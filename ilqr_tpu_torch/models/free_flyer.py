"""Free-flyer with 8 cube-corner thrusters, the m = 8 workload (counterpart
of ``ilqr_tpu/models/free_flyer.py``).

A translation-only rigid body in microgravity with quadratic drag, driven
by 8 one-sided thrusters on the cube corners, thruster j pushing along the
unit diagonal s_j/√3 with s_j ∈ {−1, +1}³ (all 8 sign patterns):

  state   = [px, py, pz, vx, vy, vz]      (n = 6)
  control = u_0..u_7, each in [0, f_max]  (m = 8)

  ṗ = v        v̇ = (1/√3·mass)·Σ_j s_j·u_j − drag·|v|⊙v

The mixing matrix has a 5-dimensional null space that only the quadratic
and linear fuel costs resolve, and most thrusters sit exactly at 0. The
SoA functions keep the operation order of the JAX package's, which
csrc/free_flyer.cuh repeats.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch.models.base import Model

# Thruster direction signs: bit k of j gives the sign on axis k.
_SIGNS = tuple(
    tuple(1.0 if (j >> k) & 1 else -1.0 for k in range(3)) for j in range(8)
)
_INV_SQRT3 = 1.0 / math.sqrt(3.0)


class FreeFlyerParams(NamedTuple):
    goal: torch.Tensor       # (6,) [px, py, pz, vx, vy, vz]
    mass: torch.Tensor       # scalar
    drag: torch.Tensor       # scalar quadratic drag coefficient
    w_state: torch.Tensor    # (6,) running weights
    w_control: torch.Tensor  # (8,) quadratic control weights
    w_fuel: torch.Tensor     # scalar linear fuel cost per unit thrust
    w_final: torch.Tensor    # (6,)
    u_min: torch.Tensor      # (8,) zeros: thrusters are one-sided
    u_max: torch.Tensor      # (8,)


def default_params(goal=(1.5, -1.0, 0.8, 0.0, 0.0, 0.0)) -> FreeFlyerParams:
    t = lambda v: torch.tensor(v, dtype=torch.get_default_dtype())
    return FreeFlyerParams(
        goal=t(goal),
        mass=t(4.0),
        drag=t(0.1),
        w_state=t([0.5, 0.5, 0.5, 0.05, 0.05, 0.05]),
        w_control=t([0.05] * 8),
        w_fuel=t(0.1),
        w_final=t([200.0, 200.0, 200.0, 20.0, 20.0, 20.0]),
        u_min=t([0.0] * 8),
        u_max=t([4.0] * 8),
    )


def params_from_numpy(tree) -> FreeFlyerParams:
    """The port's params from any params object with the same field names
    whose leaves convert with ``np.asarray``. Dtypes are kept."""
    return FreeFlyerParams(**{
        f: torch.from_numpy(np.array(getattr(tree, f)))
        for f in FreeFlyerParams._fields})


def _scale(p):
    """(1/√3)/mass as the JAX package rounds it: the constant to f32 first,
    then one division (``c / t`` in PyTorch would multiply by 1/t)."""
    return torch.full_like(p.mass, _INV_SQRT3) / p.mass


def _thrust_sum(u, axis):
    """Σ_j sign_j[axis]·u_j, in j order."""
    acc = None
    for j in range(8):
        term = _SIGNS[j][axis] * u[j]
        acc = term if acc is None else acc + term
    return acc


def _accel(p, v, u, axis):
    return _scale(p) * _thrust_sum(u, axis) - p.drag * torch.abs(v) * v


def dynamics_soa(p: FreeFlyerParams, x, u):
    return torch.stack([
        x[3], x[4], x[5],
        _accel(p, x[3], u, 0),
        _accel(p, x[4], u, 1),
        _accel(p, x[5], u, 2),
    ])


dynamics = dynamics_soa   # elementwise, so it serves one problem too


def cost(p: FreeFlyerParams, x, u):
    e = p.goal - x
    return (torch.dot(e * p.w_state, e) + torch.dot(u * p.w_control, u)
            + p.w_fuel * torch.sum(u))


def final_cost(p: FreeFlyerParams, x):
    e = p.goal - x
    return torch.dot(e * p.w_final, e)


def _weighted_sq(goal, w, x):
    acc = None
    for i in range(6):
        e = goal[i] - x[i]
        acc = e * w[i] * e if acc is None else acc + e * w[i] * e
    return acc


def cost_soa(p: FreeFlyerParams, x, u):
    acc = _weighted_sq(p.goal, p.w_state, x)
    for j in range(8):
        acc = acc + u[j] * (p.w_control[j] * u[j] + p.w_fuel)
    return acc


def final_cost_soa(p: FreeFlyerParams, x):
    return _weighted_sq(p.goal, p.w_final, x)


def jac_soa(p: FreeFlyerParams, x, u):
    """Closed-form continuous-time Jacobians; structural zeros and ones are
    Python floats. B's force block is the mixing matrix scaled by
    1/(√3·mass). d|v|·v/dv = 2|v|."""
    A = [[0.0] * 6 for _ in range(6)]
    for a in range(3):
        A[a][3 + a] = 1.0
        A[3 + a][3 + a] = -2.0 * p.drag * torch.abs(x[3 + a])
    scale = _scale(p)
    B = [[0.0] * 8 for _ in range(6)]
    for a in range(3):
        for j in range(8):
            B[3 + a][j] = _SIGNS[j][a] * scale
    return A, B


def cost_derivs_soa(p: FreeFlyerParams, x, u):
    cx = [-2.0 * p.w_state[i] * (p.goal[i] - x[i]) for i in range(6)]
    cu = [2.0 * p.w_control[j] * u[j] + p.w_fuel for j in range(8)]
    cxx = [[2.0 * p.w_state[i] if i == j else 0.0 for j in range(6)]
           for i in range(6)]
    cxu = [[0.0] * 8 for _ in range(6)]
    cuu = [[2.0 * p.w_control[i] if i == j else 0.0 for j in range(8)]
           for i in range(8)]
    return cx, cu, cxx, cxu, cuu


def final_cost_derivs_soa(p: FreeFlyerParams, x):
    cx = [-2.0 * p.w_final[i] * (p.goal[i] - x[i]) for i in range(6)]
    cxx = [[2.0 * p.w_final[i] if i == j else 0.0 for j in range(6)]
           for i in range(6)]
    return cx, cxx


MODEL = Model(
    name="free_flyer",
    n=6,
    m=8,
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
