"""Planar rigid body with a ring of M one-sided thrusters, the wide-m
family (counterpart of ``ilqr_tpu/models/thruster_ring.py``).

  state   = [px, py, θ, vx, vy, ω]       (n = 6)
  control = u_0 … u_{M-1}, thrust in [0, f_max] each   (m = M)

M thrusters sit on a body-fixed ring at angles φ_i = 2πi/M: even-indexed
ones point radially inward (force through the centre of mass, no torque),
odd-indexed ones tangentially with alternating handedness (i ≡ 1 mod 4
spin +, i ≡ 3 mod 4 spin −). Body force rotates into the world frame
through θ, the only nonlinearity.

Registered instances: ``thruster_ring`` (M = 12), ``thruster_ring16``,
``thruster_ring20`` and ``thruster_ring24`` (M = 24, the widest in-kernel
QP). One-sided boxes and a linear fuel cost keep about two thirds of the
controls at their lower bound.

The ring geometry enters as Python-float coefficients, rounded to f32 at
use, with the zero ones skipped (as the JAX package skips them at trace
time); csrc/thruster_ring.cuh holds the same f32 tables as literals.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch.models.base import Model

_RING_RADIUS = 0.5


def ring_geometry(m):
    """Body-frame thrust directions (m, 2) and torque arms (m,) in f64
    (the JAX package's ``_ring_geometry``, numpy only)."""
    dirs = np.zeros((m, 2))
    torque = np.zeros((m,))
    for i in range(m):
        phi = 2.0 * math.pi * i / m
        if i % 2 == 0:                      # radial, inward: force only
            dirs[i] = (-math.cos(phi), -math.sin(phi))
            torque[i] = 0.0
        else:                               # tangential: force + torque
            s = 1.0 if i % 4 == 1 else -1.0
            dirs[i] = (-s * math.sin(phi), s * math.cos(phi))
            torque[i] = s * _RING_RADIUS
    # cos/sin of multiples of π/2 leave ~1e-16 residue: snap to exact zeros
    # so that the structural-zero folding fires on them
    dirs[np.abs(dirs) < 1e-12] = 0.0
    return dirs, torque


class ThrusterRingParams(NamedTuple):
    goal: torch.Tensor       # (6,) [px, py, θ, vx, vy, ω]
    mass: torch.Tensor       # scalar
    inertia: torch.Tensor    # scalar
    drag: torch.Tensor       # scalar linear translational drag
    drag_w: torch.Tensor     # scalar linear rotational drag
    w_state: torch.Tensor    # (6,) running weights
    w_control: torch.Tensor  # (M,) quadratic control weights
    w_fuel: torch.Tensor     # scalar linear fuel cost per unit thrust
    w_final: torch.Tensor    # (6,)
    u_min: torch.Tensor      # (M,) zeros: thrusters are one-sided
    u_max: torch.Tensor      # (M,)


def params_from_numpy(tree) -> ThrusterRingParams:
    """The port's params from any params object with the same field names
    whose leaves convert with ``np.asarray``. Dtypes are kept."""
    return ThrusterRingParams(**{
        f: torch.from_numpy(np.array(getattr(tree, f)))
        for f in ThrusterRingParams._fields})


def _weighted_sq(goal, w, x):
    acc = None
    for i in range(6):
        e = goal[i] - x[i]
        t = e * w[i] * e
        acc = t if acc is None else acc + t
    return acc


def build_ring_model(m_thrusters: int, name: str):
    """Returns ``(Model, default_params)`` for an ``m_thrusters``-ring;
    ``m_thrusters`` must be a multiple of 4."""
    if m_thrusters % 4:
        raise ValueError(
            f"m_thrusters must be a multiple of 4, got {m_thrusters}")
    M = int(m_thrusters)
    DIRS, TORQUE = ring_geometry(M)
    D = [(float(DIRS[i, 0]), float(DIRS[i, 1])) for i in range(M)]
    ARM = [float(TORQUE[i]) for i in range(M)]

    def default_params(goal=(1.5, -1.0, 0.8, 0.0, 0.0, 0.0)
                       ) -> ThrusterRingParams:
        t = lambda v: torch.tensor(v, dtype=torch.get_default_dtype())
        return ThrusterRingParams(
            goal=t(goal),
            mass=t(1.0),
            inertia=t(0.1),
            drag=t(0.1),
            drag_w=t(0.05),
            w_state=t([0.5, 0.5, 0.5, 0.05, 0.05, 0.05]),
            w_control=t([0.02] * M),
            w_fuel=t(0.05),
            w_final=t([200.0, 200.0, 200.0, 20.0, 20.0, 20.0]),
            u_min=t([0.0] * M),
            u_max=t([8.0] * M),
        )

    def _fb(u):
        """Body-frame force Σᵢ dᵢ·uᵢ, zero coefficients skipped."""
        fb = [None, None]
        for i in range(M):
            for a in range(2):
                if D[i][a] != 0.0:
                    t = D[i][a] * u[i]
                    fb[a] = t if fb[a] is None else fb[a] + t
        return fb

    def _arm_over_inertia(p, i):
        """torque_i / inertia, the constant to f32 first (``c / t`` in
        PyTorch would multiply by 1/t)."""
        return torch.full_like(p.inertia, ARM[i]) / p.inertia

    def dynamics_soa(p: ThrusterRingParams, x, u):
        ct, st = torch.cos(x[2]), torch.sin(x[2])
        fb0, fb1 = _fb(u)
        inv_m = 1.0 / p.mass
        ax = (ct * fb0 - st * fb1) * inv_m - p.drag * x[3]
        ay = (st * fb0 + ct * fb1) * inv_m - p.drag * x[4]
        aw = None
        for i in range(M):
            if ARM[i] != 0.0:
                t = ARM[i] * u[i]
                aw = t if aw is None else aw + t
        aw = aw / p.inertia - p.drag_w * x[5]
        return torch.stack([x[3], x[4], x[5], ax, ay, aw])

    def cost(p: ThrusterRingParams, x, u):
        e = p.goal - x
        return (torch.dot(e * p.w_state, e) + torch.dot(u * p.w_control, u)
                + p.w_fuel * torch.sum(u))

    def final_cost(p: ThrusterRingParams, x):
        e = p.goal - x
        return torch.dot(e * p.w_final, e)

    def cost_soa(p: ThrusterRingParams, x, u):
        acc = _weighted_sq(p.goal, p.w_state, x)
        for j in range(M):
            acc = acc + u[j] * (p.w_control[j] * u[j] + p.w_fuel)
        return acc

    def final_cost_soa(p: ThrusterRingParams, x):
        return _weighted_sq(p.goal, p.w_final, x)

    def jac_soa(p: ThrusterRingParams, x, u):
        """Closed-form continuous-time Jacobians. Live: the θ column of the
        accelerations, the diagonal drags, the rotated thrust-direction
        columns of B (rows 3-4 for every thruster, ``ct·0`` included, as
        the JAX package computes them) and the torque row at the
        tangential thrusters."""
        ct, st = torch.cos(x[2]), torch.sin(x[2])
        fb0, fb1 = _fb(u)
        inv_m = 1.0 / p.mass
        A = [[0.0] * 6 for _ in range(6)]
        for a in range(3):
            A[a][3 + a] = 1.0
        A[3][2] = (-st * fb0 - ct * fb1) * inv_m
        A[4][2] = (ct * fb0 - st * fb1) * inv_m
        A[3][3] = -1.0 * p.drag
        A[4][4] = -1.0 * p.drag
        A[5][5] = -1.0 * p.drag_w
        B = [[0.0] * M for _ in range(6)]
        for i in range(M):
            d0, d1 = D[i]
            B[3][i] = (ct * d0 - st * d1) * inv_m
            B[4][i] = (st * d0 + ct * d1) * inv_m
            if ARM[i] != 0.0:
                B[5][i] = _arm_over_inertia(p, i)
        return A, B

    def cost_derivs_soa(p: ThrusterRingParams, x, u):
        cx = [-2.0 * p.w_state[i] * (p.goal[i] - x[i]) for i in range(6)]
        cu = [2.0 * p.w_control[j] * u[j] + p.w_fuel for j in range(M)]
        cxx = [[2.0 * p.w_state[i] if i == j else 0.0
                for j in range(6)] for i in range(6)]
        cxu = [[0.0] * M for _ in range(6)]
        cuu = [[2.0 * p.w_control[i] if i == j else 0.0
                for j in range(M)] for i in range(M)]
        return cx, cu, cxx, cxu, cuu

    def final_cost_derivs_soa(p: ThrusterRingParams, x):
        cx = [-2.0 * p.w_final[i] * (p.goal[i] - x[i]) for i in range(6)]
        cxx = [[2.0 * p.w_final[i] if i == j else 0.0
                for j in range(6)] for i in range(6)]
        return cx, cxx

    model = Model(
        name=name,
        n=6,
        m=M,
        dynamics=dynamics_soa,   # elementwise: it serves one problem too
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
    return model, default_params


MODEL, default_params = build_ring_model(12, "thruster_ring")
MODEL16, default_params16 = build_ring_model(16, "thruster_ring16")
MODEL20, default_params20 = build_ring_model(20, "thruster_ring20")
MODEL24, default_params24 = build_ring_model(24, "thruster_ring24")
MODELS = (MODEL, MODEL16, MODEL20, MODEL24)
