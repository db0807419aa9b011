"""Quadrotor hover/waypoint, the m = 4 workload (counterpart of
``ilqr_tpu/models/quadrotor.py``).

  state   = [p (3), v (3), φ θ ψ (ZYX Euler), ω (3)]   (n = 12)
  control = per-rotor thrusts [f1, f2, f3, f4]          (m = 4)

  ṗ = v
  v̇ = (F/m)·R(φ,θ,ψ)e₃ − g·e₃          F = Σfᵢ
  [φ̇, θ̇, ψ̇] = W(φ,θ)·ω                 (body rates → Euler rates)
  ω̇ = J⁻¹(τ − ω × Jω)                   diagonal J, '+'-configuration:
      τx = L(f₂ − f₄), τy = L(f₃ − f₁), τz = c_τ(f₁ − f₂ + f₃ − f₄)

  cost = (g−x)ᵀHx(g−x) + (u−u_hover)ᵀHu(u−u_hover), final = s·(g−x)ᵀHx(g−x)

The thrust box [0, f_max] is asymmetric. The SoA functions keep the
operation order of the JAX package's, which csrc/quadrotor.cuh repeats.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch.models.base import Model


class QuadrotorParams(NamedTuple):
    goal: torch.Tensor         # (12,)
    mass: torch.Tensor         # scalar
    gravity: torch.Tensor      # scalar
    arm: torch.Tensor          # scalar rotor arm length L
    c_tau: torch.Tensor        # scalar thrust→yaw-torque coefficient
    inertia: torch.Tensor      # (3,) diagonal of J
    hx_diag: torch.Tensor      # (12,) diagonal of Hx
    hu_diag: torch.Tensor      # (4,) diagonal of Hu
    final_scale: torch.Tensor  # scalar
    u_min: torch.Tensor        # (4,)
    u_max: torch.Tensor        # (4,)


def default_params(
    goal=(1.0, 0.5, 0.8, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
) -> QuadrotorParams:
    """500 g '+'-frame quadrotor. Hover thrust mg/4 ≈ 1.23 N per rotor is
    well inside the [0, 3] N box."""
    t = lambda v: torch.tensor(v, dtype=torch.get_default_dtype())
    return QuadrotorParams(
        goal=t(goal),
        mass=t(0.5),
        gravity=t(9.81),
        arm=t(0.17),
        c_tau=t(0.016),
        inertia=t([2.3e-3, 2.3e-3, 4.0e-3]),
        hx_diag=t([2.0, 2.0, 2.0,           # position
                   0.2, 0.2, 0.2,           # velocity
                   1.0, 1.0, 1.0,           # attitude
                   0.05, 0.05, 0.05]),      # body rates
        hu_diag=t([0.2, 0.2, 0.2, 0.2]),
        final_scale=t(25.0),
        u_min=t([0.0, 0.0, 0.0, 0.0]),
        u_max=t([3.0, 3.0, 3.0, 3.0]),
    )


def params_from_numpy(tree) -> QuadrotorParams:
    """The port's params from any params object with the same field names
    whose leaves convert with ``np.asarray``. Dtypes are kept."""
    return QuadrotorParams(**{
        f: torch.from_numpy(np.array(getattr(tree, f)))
        for f in QuadrotorParams._fields})


def hover_control(p: QuadrotorParams) -> torch.Tensor:
    """The per-rotor thrust that exactly cancels gravity (mg/4 each)."""
    return torch.full((4,), float(p.mass * p.gravity / 4.0),
                      dtype=torch.get_default_dtype())


def dynamics(p: QuadrotorParams, x, u):
    v = x[3:6]
    phi, theta, psi = x[6], x[7], x[8]
    om = x[9:12]

    F = u[0] + u[1] + u[2] + u[3]
    tau = torch.stack([
        p.arm * (u[1] - u[3]),
        p.arm * (u[2] - u[0]),
        p.c_tau * (u[0] - u[1] + u[2] - u[3]),
    ])

    sph, cph = torch.sin(phi), torch.cos(phi)
    sth, cth = torch.sin(theta), torch.cos(theta)
    sps, cps = torch.sin(psi), torch.cos(psi)

    # world-frame thrust direction: third column of R_zyx(ψ, θ, φ)
    acc = (F / p.mass) * torch.stack([
        cph * sth * cps + sph * sps,
        cph * sth * sps - sph * cps,
        cph * cth,
    ]) - torch.stack([0.0 * F, 0.0 * F, p.gravity * torch.ones_like(F)])

    tth = sth / cth
    eul_rate = torch.stack([
        om[0] + sph * tth * om[1] + cph * tth * om[2],
        cph * om[1] - sph * om[2],
        (sph * om[1] + cph * om[2]) / cth,
    ])

    J = p.inertia
    om_dot = torch.stack([
        (tau[0] - (J[2] - J[1]) * om[1] * om[2]) / J[0],
        (tau[1] - (J[0] - J[2]) * om[2] * om[0]) / J[1],
        (tau[2] - (J[1] - J[0]) * om[0] * om[1]) / J[2],
    ])

    return torch.cat([v, acc, eul_rate, om_dot])


def cost(p: QuadrotorParams, x, u):
    e = p.goal - x
    du = u - p.mass * p.gravity / 4.0
    return torch.dot(e * p.hx_diag, e) + torch.dot(du * p.hu_diag, du)


def final_cost(p: QuadrotorParams, x):
    e = p.goal - x
    return p.final_scale * torch.dot(e * p.hx_diag, e)


def dynamics_soa(p: QuadrotorParams, x, u):
    inv_m = 1.0 / p.mass
    F = u[0] + u[1] + u[2] + u[3]
    taux = p.arm * (u[1] - u[3])
    tauy = p.arm * (u[2] - u[0])
    tauz = p.c_tau * (u[0] - u[1] + u[2] - u[3])

    sph, cph = torch.sin(x[6]), torch.cos(x[6])
    sth, cth = torch.sin(x[7]), torch.cos(x[7])
    sps, cps = torch.sin(x[8]), torch.cos(x[8])

    Fm = F * inv_m
    inv_cth = 1.0 / cth
    tth = sth * inv_cth
    Jx, Jy, Jz = p.inertia[0], p.inertia[1], p.inertia[2]

    return torch.stack([
        x[3], x[4], x[5],
        Fm * (cph * sth * cps + sph * sps),
        Fm * (cph * sth * sps - sph * cps),
        Fm * (cph * cth) - p.gravity * torch.ones_like(F),
        x[9] + sph * tth * x[10] + cph * tth * x[11],
        cph * x[10] - sph * x[11],
        (sph * x[10] + cph * x[11]) * inv_cth,
        (taux - (Jz - Jy) * x[10] * x[11]) / Jx,
        (tauy - (Jx - Jz) * x[11] * x[9]) / Jy,
        (tauz - (Jy - Jx) * x[9] * x[10]) / Jz,
    ])


def cost_soa(p: QuadrotorParams, x, u):
    hov = p.mass * p.gravity * 0.25
    e = p.goal[0] - x[0]
    acc = e * p.hx_diag[0] * e
    for i in range(1, 12):
        e = p.goal[i] - x[i]
        acc = acc + e * p.hx_diag[i] * e
    for j in range(4):
        du = u[j] - hov
        acc = acc + du * p.hu_diag[j] * du
    return acc


def final_cost_soa(p: QuadrotorParams, x):
    e = p.goal[0] - x[0]
    acc = e * p.hx_diag[0] * e
    for i in range(1, 12):
        e = p.goal[i] - x[i]
        acc = acc + e * p.hx_diag[i] * e
    return p.final_scale * acc


def jac_soa(p: QuadrotorParams, x, u):
    """Closed-form continuous-time Jacobians of :func:`dynamics`.
    Structural zeros and ones are Python floats (csrc/quadrotor.cuh holds
    the same pattern)."""
    inv_m = 1.0 / p.mass
    F = u[0] + u[1] + u[2] + u[3]
    Fm = F * inv_m

    sph, cph = torch.sin(x[6]), torch.cos(x[6])
    sth, cth = torch.sin(x[7]), torch.cos(x[7])
    sps, cps = torch.sin(x[8]), torch.cos(x[8])
    inv_cth = 1.0 / cth
    tth = sth * inv_cth
    sec2 = inv_cth * inv_cth
    w1, w2, w3 = x[9], x[10], x[11]
    Jx, Jy, Jz = p.inertia[0], p.inertia[1], p.inertia[2]

    # world-frame thrust direction (third column of R_zyx)
    rx = cph * sth * cps + sph * sps
    ry = cph * sth * sps - sph * cps
    rz = cph * cth

    A = [[0.0] * 12 for _ in range(12)]
    for i in range(3):
        A[i][i + 3] = 1.0
    # v̇ rows: angle sensitivities of the thrust direction
    A[3][6] = Fm * (-sph * sth * cps + cph * sps)
    A[3][7] = Fm * (cph * cth * cps)
    A[3][8] = Fm * (-cph * sth * sps + sph * cps)
    A[4][6] = Fm * (-sph * sth * sps - cph * cps)
    A[4][7] = Fm * (cph * cth * sps)
    A[4][8] = Fm * rx
    A[5][6] = Fm * (-sph * cth)
    A[5][7] = Fm * (-cph * sth)
    # Euler-rate rows: W(φ,θ)ω sensitivities
    A[6][6] = (cph * w2 - sph * w3) * tth
    A[6][7] = (sph * w2 + cph * w3) * sec2
    A[6][9] = 1.0
    A[6][10] = sph * tth
    A[6][11] = cph * tth
    A[7][6] = -sph * w2 - cph * w3
    A[7][10] = cph
    A[7][11] = -sph
    A[8][6] = (cph * w2 - sph * w3) * inv_cth
    A[8][7] = (sph * w2 + cph * w3) * sth * sec2
    A[8][10] = sph * inv_cth
    A[8][11] = cph * inv_cth
    # body-rate rows: gyroscopic coupling
    A[9][10] = -(Jz - Jy) * w3 / Jx
    A[9][11] = -(Jz - Jy) * w2 / Jx
    A[10][9] = -(Jx - Jz) * w3 / Jy
    A[10][11] = -(Jx - Jz) * w1 / Jy
    A[11][9] = -(Jy - Jx) * w2 / Jz
    A[11][10] = -(Jy - Jx) * w1 / Jz

    B = [[0.0] * 4 for _ in range(12)]
    for j in range(4):
        B[3][j] = rx * inv_m
        B[4][j] = ry * inv_m
        B[5][j] = rz * inv_m
    LJx = p.arm / Jx
    LJy = p.arm / Jy
    cJz = p.c_tau / Jz
    B[9][1] = LJx
    B[9][3] = -LJx
    B[10][0] = -LJy
    B[10][2] = LJy
    B[11][0] = cJz
    B[11][1] = -cJz
    B[11][2] = cJz
    B[11][3] = -cJz
    return A, B


def cost_derivs_soa(p: QuadrotorParams, x, u):
    hov = p.mass * p.gravity * 0.25
    cx = [-2.0 * p.hx_diag[i] * (p.goal[i] - x[i]) for i in range(12)]
    cu = [2.0 * p.hu_diag[j] * (u[j] - hov) for j in range(4)]
    cxx = [[2.0 * p.hx_diag[i] if i == j else 0.0 for j in range(12)]
           for i in range(12)]
    cxu = [[0.0] * 4 for _ in range(12)]
    cuu = [[2.0 * p.hu_diag[i] if i == j else 0.0 for j in range(4)]
           for i in range(4)]
    return cx, cu, cxx, cxu, cuu


def final_cost_derivs_soa(p: QuadrotorParams, x):
    fs = p.final_scale
    cx = [-2.0 * fs * p.hx_diag[i] * (p.goal[i] - x[i]) for i in range(12)]
    cxx = [[2.0 * fs * p.hx_diag[i] if i == j else 0.0 for j in range(12)]
           for i in range(12)]
    return cx, cxx


MODEL = Model(
    name="quadrotor",
    n=12,
    m=4,
    dynamics=dynamics,
    cost=cost,
    final_cost=final_cost,
    default_params=default_params,
    dynamics_soa=dynamics_soa,
    cost_soa=cost_soa,
    final_cost_soa=final_cost_soa,
    jac_soa=jac_soa,
    cost_derivs_soa=cost_derivs_soa,
    final_cost_derivs_soa=final_cost_derivs_soa,
)
