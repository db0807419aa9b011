"""Acrobot swing-up (counterpart of ``ilqr_tpu/models/acrobot.py``).

Lagrangian dynamics and costs match ref include/acrobot.h exactly:
  state = [θ1, θ2, θ̇1, θ̇2], θ1 from the down axis (up = π); control = torque
  on the second joint only.

  H(q)  inertia matrix            (:43-51)
  C(q,q̇) Coriolis matrix          (:53-61)  — NOTE: C(0,1) uses l2 where l1
          would be expected; the reference (and its source TGlad/ILQR) does
          this, and since l1=l2=1 it is numerically irrelevant. Replicated
          verbatim for parity.
  G(q)  gravity vector            (:63-70)
  q̈ = H(q)⁻¹ ([0, u] − C q̇ − G)   (:72-81)
  running cost: Ks=Kd=0, Kr=0.1 → (Kr²)·uᵀu (torque only)  (:83-92)
  final cost: Ks=Kd=20 → Ks²·‖q_err‖² + Kd²·‖q̇_err‖²        (:94-100)
  goal = [3.1415, 0, 0, 0] (:20-22), limits ±5 (:37)
  params I1=I2=l1=l2=m1=m2=1, lc=0.5, g=9.81 (:19-25)

The SoA functions use exact ``torch.sin``/``torch.cos`` with the angle-sum
identity for sin(q1+q2) and cos(q1+q2), as the JAX package does off the TPU;
the CUDA kernels (csrc/acrobot.cuh) use ``sincosf`` the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch.models.base import Model


class AcrobotParams(NamedTuple):
    goal: torch.Tensor     # (4,)
    inertia: torch.Tensor  # (2,) [I1, I2]
    lengths: torch.Tensor  # (2,) [l1, l2]
    masses: torch.Tensor   # (2,) [m1, m2]
    lc: torch.Tensor       # (2,) [lc1, lc2]
    gravity: torch.Tensor  # scalar
    k_run: torch.Tensor    # (3,) [Ks, Kd, Kr] running-cost gains
    k_final: torch.Tensor  # (2,) [Ks, Kd] final-cost gains
    u_min: torch.Tensor    # (1,)
    u_max: torch.Tensor    # (1,)


def default_params(goal=(3.1415, 0.0, 0.0, 0.0)) -> AcrobotParams:
    t = lambda v: torch.tensor(v, dtype=torch.get_default_dtype())
    return AcrobotParams(
        goal=t(goal),
        inertia=t([1.0, 1.0]),
        lengths=t([1.0, 1.0]),
        masses=t([1.0, 1.0]),
        lc=t([0.5, 0.5]),
        gravity=t(9.81),
        k_run=t([0.0, 0.0, 0.1]),
        k_final=t([20.0, 20.0]),
        u_min=t([-5.0]),
        u_max=t([5.0]),
    )


def params_from_numpy(tree) -> AcrobotParams:
    """The port's params from any params object with the same field names
    whose leaves convert with ``np.asarray`` (the JAX package's
    ``AcrobotParams`` after ``tree_map(np.asarray)``). Dtypes are kept."""
    return AcrobotParams(**{
        f: torch.from_numpy(np.array(getattr(tree, f)))
        for f in AcrobotParams._fields})


def dynamics(p: AcrobotParams, x, u):
    i1, i2 = p.inertia[0], p.inertia[1]
    l1, l2 = p.lengths[0], p.lengths[1]
    m1, m2 = p.masses[0], p.masses[1]
    lc1, lc2 = p.lc[0], p.lc[1]
    g = p.gravity

    q, qdot = x[:2], x[2:]
    c2, s2 = torch.cos(q[1]), torch.sin(q[1])
    s1, s12 = torch.sin(q[0]), torch.sin(q[0] + q[1])

    h_off = i2 + m2 * l1 * lc2 * c2
    H = torch.stack([
        torch.stack([i1 + i2 + m2 * l1 * l1 + 2.0 * m2 * l1 * lc2 * c2,
                     h_off]),
        torch.stack([h_off, i2]),
    ])
    # C(0,1) uses l2 (reference quirk, see module docstring).
    C = torch.stack([
        torch.stack([-2.0 * m2 * l1 * lc2 * s2 * qdot[1],
                     -m2 * l2 * lc2 * s2 * qdot[1]]),
        torch.stack([m2 * l1 * lc2 * s2 * qdot[0], torch.zeros_like(s2)]),
    ])
    G = torch.stack([
        m1 * g * lc1 * s1 + m2 * g * (l1 * s1 + lc2 * s12),
        m2 * g * lc2 * s12,
    ])
    tau = torch.stack([torch.zeros_like(u[0]), u[0]])
    qddot = torch.linalg.solve(H, tau - C @ qdot - G)
    return torch.cat([qdot, qddot])


def cost(p: AcrobotParams, x, u):
    e = p.goal - x
    ks, kd, kr = p.k_run[0], p.k_run[1], p.k_run[2]
    return (ks * ks * torch.dot(e[:2], e[:2])
            + kd * kd * torch.dot(e[2:], e[2:])
            + kr * kr * torch.dot(u, u))


def final_cost(p: AcrobotParams, x):
    e = p.goal - x
    ks, kd = p.k_final[0], p.k_final[1]
    return (ks * ks * torch.dot(e[:2], e[:2])
            + kd * kd * torch.dot(e[2:], e[2:]))


def dynamics_soa(p: AcrobotParams, x, u):
    """Structure-of-arrays dynamics: the same math as :func:`dynamics` with
    the 2×2 H-solve written as an explicit inverse, in the operation order
    of the JAX package's ``dynamics_soa`` (one reciprocal determinant)."""
    i1, i2 = p.inertia[0], p.inertia[1]
    l1, l2 = p.lengths[0], p.lengths[1]
    m1, m2 = p.masses[0], p.masses[1]
    lc1, lc2 = p.lc[0], p.lc[1]
    g = p.gravity

    q1, q2, qd1, qd2 = x[0], x[1], x[2], x[3]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s2, c2 = torch.sin(q2), torch.cos(q2)
    s12 = s1 * c2 + c1 * s2

    kk = m2 * l1 * lc2
    kkc2 = kk * c2
    h11 = i1 + i2 + m2 * l1 * l1 + 2.0 * kkc2
    h12 = i2 + kkc2
    h22 = i2
    kks2 = kk * s2

    # C(0,1) uses l2 (reference quirk, see module docstring):
    # b = tau - C q̇ - G expanded with the C/G terms inlined.
    gBs12 = m2 * g * lc2 * s12
    g1 = (m1 * g * lc1 + m2 * g * l1) * s1 + gBs12
    b1 = (2.0 * kks2 * qd1 + (m2 * l2 * lc2) * s2 * qd2) * qd2 - g1
    b2 = u[0] - kks2 * qd1 * qd1 - gBs12

    rdet = 1.0 / (h11 * h22 - h12 * h12)
    qdd1 = (h22 * b1 - h12 * b2) * rdet
    qdd2 = (h11 * b2 - h12 * b1) * rdet
    return torch.stack([qd1, qd2, qdd1, qdd2])


def cost_soa(p: AcrobotParams, x, u):
    kr = p.k_run[2]
    ks = p.k_run[0]
    kd = p.k_run[1]
    e0 = p.goal[0] - x[0]
    e1 = p.goal[1] - x[1]
    e2 = p.goal[2] - x[2]
    e3 = p.goal[3] - x[3]
    return (ks * ks * (e0 * e0 + e1 * e1)
            + kd * kd * (e2 * e2 + e3 * e3)
            + kr * kr * u[0] * u[0])


def final_cost_soa(p: AcrobotParams, x):
    ks = p.k_final[0]
    kd = p.k_final[1]
    e0 = p.goal[0] - x[0]
    e1 = p.goal[1] - x[1]
    e2 = p.goal[2] - x[2]
    e3 = p.goal[3] - x[3]
    return (ks * ks * (e0 * e0 + e1 * e1)
            + kd * kd * (e2 * e2 + e3 * e3))


def jac_soa(p: AcrobotParams, x, u):
    """Closed-form continuous-time Jacobians ∂f/∂x, ∂f/∂u of
    :func:`dynamics_soa` (∂q̈/∂θ = M⁻¹(∂b/∂θ − (∂M/∂θ) q̈)), in the
    operation order of the JAX package's ``jac_soa``. Structural entries
    are Python floats."""
    i1, i2 = p.inertia[0], p.inertia[1]
    l1, l2 = p.lengths[0], p.lengths[1]
    m1, m2 = p.masses[0], p.masses[1]
    lc1, lc2 = p.lc[0], p.lc[1]
    g = p.gravity

    q1, q2, qd1, qd2 = x[0], x[1], x[2], x[3]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s2, c2 = torch.sin(q2), torch.cos(q2)
    s12 = s1 * c2 + c1 * s2
    c12 = c1 * c2 - s1 * s2

    kk = m2 * l1 * lc2
    kkc2 = kk * c2
    h11 = i1 + i2 + m2 * l1 * l1 + 2.0 * kkc2
    h12 = i2 + kkc2
    h22 = i2
    rdet = 1.0 / (h11 * h22 - h12 * h12)
    kks2 = kk * s2

    # C(0,1) uses l2 (reference quirk, see module docstring).
    c11 = -2.0 * kks2 * qd2
    c12_ = -m2 * l2 * lc2 * s2 * qd2
    c21 = kks2 * qd1

    gBs12 = m2 * g * lc2 * s12
    g1 = (m1 * g * lc1 + m2 * g * l1) * s1 + gBs12
    g2 = gBs12

    b1 = -(c11 * qd1 + c12_ * qd2) - g1
    b2 = u[0] - c21 * qd1 - g2
    qdd1 = (h22 * b1 - h12 * b2) * rdet
    qdd2 = (h11 * b2 - h12 * b1) * rdet

    def msolve(r1, r2):
        return ((h22 * r1 - h12 * r2) * rdet, (h11 * r2 - h12 * r1) * rdet)

    # ∂b/∂q1 (M does not depend on q1)
    db1_q1 = -(m1 * g * lc1 * c1 + m2 * g * (l1 * c1 + lc2 * c12))
    db2_q1 = -m2 * g * lc2 * c12
    a2_q1, a3_q1 = msolve(db1_q1, db2_q1)

    # ∂/∂q2: both b and M depend on q2
    db1_q2 = (2.0 * kk * c2 * qd2 * qd1 + m2 * l2 * lc2 * c2 * qd2 * qd2
              - m2 * g * lc2 * c12)
    db2_q2 = -kk * c2 * qd1 * qd1 - m2 * g * lc2 * c12
    # (∂M/∂q2) q̈ with ∂M/∂q2 = [[-2ks2, -ks2], [-ks2, 0]]
    dm_qdd1 = -2.0 * kks2 * qdd1 - kks2 * qdd2
    dm_qdd2 = -kks2 * qdd1
    a2_q2, a3_q2 = msolve(db1_q2 - dm_qdd1, db2_q2 - dm_qdd2)

    # ∂b/∂q̇1 = (-c11, -2 c21); ∂b/∂q̇2 = (2k s2 q̇1 + 2 m2 l2 lc2 s2 q̇2, 0)
    a2_qd1, a3_qd1 = msolve(-c11, -2.0 * c21)
    db1_qd2 = 2.0 * kks2 * qd1 + 2.0 * m2 * l2 * lc2 * s2 * qd2
    a2_qd2 = h22 * db1_qd2 * rdet        # msolve(db1_qd2, 0) hand-folded
    a3_qd2 = -h12 * db1_qd2 * rdet

    # ∂f/∂u = (0, 0, M⁻¹ e₂) — msolve(0, 1) hand-folded
    b2_u = -h12 * rdet
    b3_u = h11 * rdet

    A = [[0.0, 0.0, 1.0, 0.0],
         [0.0, 0.0, 0.0, 1.0],
         [a2_q1, a2_q2, a2_qd1, a2_qd2],
         [a3_q1, a3_q2, a3_qd1, a3_qd2]]
    B = [[0.0], [0.0], [b2_u], [b3_u]]
    return A, B


def cost_derivs_soa(p: AcrobotParams, x, u):
    ks, kd, kr = p.k_run[0], p.k_run[1], p.k_run[2]
    w = [ks * ks, ks * ks, kd * kd, kd * kd]
    cx = [-2.0 * w[i] * (p.goal[i] - x[i]) for i in range(4)]
    cu = [2.0 * kr * kr * u[0]]
    cxx = [[2.0 * w[i] if i == j else 0.0 for j in range(4)]
           for i in range(4)]
    cxu = [[0.0] for _ in range(4)]
    cuu = [[2.0 * kr * kr]]
    return cx, cu, cxx, cxu, cuu


def final_cost_derivs_soa(p: AcrobotParams, x):
    ks, kd = p.k_final[0], p.k_final[1]
    w = [ks * ks, ks * ks, kd * kd, kd * kd]
    cx = [-2.0 * w[i] * (p.goal[i] - x[i]) for i in range(4)]
    cxx = [[2.0 * w[i] if i == j else 0.0 for j in range(4)]
           for i in range(4)]
    return cx, cxx


MODEL = Model(
    name="acrobot",
    n=4,
    m=1,
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
