"""Power-limited planar point mass, the m = 2 model with live cost cross
terms (counterpart of ``ilqr_tpu/models/power_mass.py``).

  state   = [px, py, vx, vy]       (n = 4)
  control = [ux, uy] (forces)      (m = 2)

  ṗ = v        v̇ = u/mass − drag·v

Cost = quadratic goal tracking + control effort + a quadratic mechanical-
power penalty w_power·(v·u)². With s = vx·ux + vy·uy the power term makes
cxu live and state dependent,

  cxu[2+a][j] = 2·w_power·(u_a·v_j + δ_aj·s),

and adds 2·w_power·u uᵀ to cxx's velocity block (live off-diagonal
entries) and 2·w_power·v vᵀ to cuu (full). The SoA functions keep the
operation order of the JAX package's, which csrc/power_mass.cuh repeats.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch.models.base import Model


class PowerMassParams(NamedTuple):
    goal: torch.Tensor       # (4,) [px, py, vx, vy]
    mass: torch.Tensor       # scalar
    drag: torch.Tensor       # scalar linear drag coefficient
    w_state: torch.Tensor    # (4,) running weights
    w_control: torch.Tensor  # (2,)
    w_power: torch.Tensor    # scalar weight on (v·u)²
    w_final: torch.Tensor    # (4,)
    u_min: torch.Tensor      # (2,)
    u_max: torch.Tensor      # (2,)


def default_params(goal=(3.0, 2.0, 0.0, 0.0)) -> PowerMassParams:
    t = lambda v: torch.tensor(v, dtype=torch.get_default_dtype())
    return PowerMassParams(
        goal=t(goal),
        mass=t(1.0),
        drag=t(0.15),
        w_state=t([0.5, 0.5, 0.05, 0.05]),
        w_control=t([0.1, 0.1]),
        w_power=t(0.05),
        w_final=t([200.0, 200.0, 20.0, 20.0]),
        u_min=t([-1.5, -1.5]),
        u_max=t([2.5, 2.5]),
    )


def params_from_numpy(tree) -> PowerMassParams:
    """The port's params from any params object with the same field names
    whose leaves convert with ``np.asarray``. Dtypes are kept."""
    return PowerMassParams(**{
        f: torch.from_numpy(np.array(getattr(tree, f)))
        for f in PowerMassParams._fields})


def dynamics_soa(p: PowerMassParams, x, u):
    inv_m = 1.0 / p.mass
    return torch.stack([
        x[2],
        x[3],
        u[0] * inv_m - p.drag * x[2],
        u[1] * inv_m - p.drag * x[3],
    ])


dynamics = dynamics_soa   # the same expression for one problem


def _power(x, u):
    return x[2] * u[0] + x[3] * u[1]


def cost(p: PowerMassParams, x, u):
    e = p.goal - x
    s = _power(x, u)
    return (torch.dot(e * p.w_state, e) + torch.dot(u * p.w_control, u)
            + p.w_power * s * s)


def final_cost(p: PowerMassParams, x):
    e = p.goal - x
    return torch.dot(e * p.w_final, e)


def _werr(p, x, w):
    acc = None
    for i in range(4):
        e = p.goal[i] - x[i]
        acc = e * w[i] * e if acc is None else acc + e * w[i] * e
    return acc


def cost_soa(p: PowerMassParams, x, u):
    acc = _werr(p, x, p.w_state)
    for j in range(2):
        acc = acc + u[j] * p.w_control[j] * u[j]
    s = _power(x, u)
    return acc + p.w_power * s * s


def final_cost_soa(p: PowerMassParams, x):
    return _werr(p, x, p.w_final)


def jac_soa(p: PowerMassParams, x, u):
    """Closed-form continuous-time Jacobians; structural constants are
    Python floats (4 live A entries of 16)."""
    inv_m = 1.0 / p.mass
    A = [[0.0] * 4 for _ in range(4)]
    A[0][2] = 1.0
    A[1][3] = 1.0
    A[2][2] = -p.drag
    A[3][3] = -p.drag
    B = [[0.0] * 2 for _ in range(4)]
    B[2][0] = inv_m
    B[3][1] = inv_m
    return A, B


def cost_derivs_soa(p: PowerMassParams, x, u):
    """Closed-form cost derivatives: the power term s = v·u gives
    state-dependent entries in cx (velocity rows), cu, cxx's velocity
    block, cuu and cxu."""
    s = _power(x, u)
    two_wp = 2.0 * p.w_power
    cx = [-2.0 * p.w_state[0] * (p.goal[0] - x[0]),
          -2.0 * p.w_state[1] * (p.goal[1] - x[1]),
          -2.0 * p.w_state[2] * (p.goal[2] - x[2]) + two_wp * s * u[0],
          -2.0 * p.w_state[3] * (p.goal[3] - x[3]) + two_wp * s * u[1]]
    cu = [2.0 * p.w_control[0] * u[0] + two_wp * s * x[2],
          2.0 * p.w_control[1] * u[1] + two_wp * s * x[3]]
    cxx = [[2.0 * p.w_state[i] if i == j else 0.0 for j in range(4)]
           for i in range(4)]
    for a in range(2):          # velocity block += 2 w_p · u uᵀ
        for b in range(2):
            extra = two_wp * u[a] * u[b]
            cxx[2 + a][2 + b] = (cxx[2 + a][2 + b] + extra if a == b
                                 else extra)
    cxu = [[0.0] * 2 for _ in range(4)]
    for a in range(2):          # ∂²c/∂v_a∂u_j = 2 w_p (u_a v_j + δ_aj s)
        for j in range(2):
            cxu[2 + a][j] = two_wp * (u[a] * x[2 + j]
                                      + (s if a == j else 0.0))
    cuu = [[two_wp * x[2 + i] * x[2 + j] for j in range(2)]
           for i in range(2)]
    for j in range(2):
        cuu[j][j] = cuu[j][j] + 2.0 * p.w_control[j]
    return cx, cu, cxx, cxu, cuu


def final_cost_derivs_soa(p: PowerMassParams, x):
    cx = [-2.0 * p.w_final[i] * (p.goal[i] - x[i]) for i in range(4)]
    cxx = [[2.0 * p.w_final[i] if i == j else 0.0 for j in range(4)]
           for i in range(4)]
    return cx, cxx


MODEL = Model(
    name="power_mass",
    n=4,
    m=2,
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
