"""Omnidirectional 6-thruster craft, the m = 6 workload (counterpart of
``ilqr_tpu/models/omni_thruster.py``).

  state   = [px, py, pz, vx, vy, vz]                 (n = 6)
  control = [f+x, f−x, f+y, f−y, f+z, f−z]           (m = 6)

  ṗ = v        v̇_a = (f+a − f−a)/mass − drag·|v_a|·v_a − g·δ_{a,z}

Each thruster pushes one way with thrust in [0, f_max]: a one-sided box
whose lower bound is active on about half the controls, and a linear fuel
cost w_fuel·Σu that pins idle thrusters exactly at 0. The SoA functions
keep the operation order of the JAX package's, which
csrc/omni_thruster.cuh repeats.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch.models.base import Model


class OmniThrusterParams(NamedTuple):
    goal: torch.Tensor       # (6,) [px, py, pz, vx, vy, vz]
    mass: torch.Tensor       # scalar
    drag: torch.Tensor       # scalar quadratic drag coefficient
    gravity: torch.Tensor    # scalar (positive; acts on −z)
    w_state: torch.Tensor    # (6,) running weights
    w_control: torch.Tensor  # (6,) quadratic control weights
    w_fuel: torch.Tensor     # scalar linear fuel cost per unit thrust
    w_final: torch.Tensor    # (6,)
    u_min: torch.Tensor      # (6,) zeros: thrusters are one-sided
    u_max: torch.Tensor      # (6,)


def default_params(goal=(2.0, -1.5, 1.0, 0.0, 0.0, 0.0)
                   ) -> OmniThrusterParams:
    t = lambda v: torch.tensor(v, dtype=torch.get_default_dtype())
    return OmniThrusterParams(
        goal=t(goal),
        mass=t(1.0),
        drag=t(0.05),
        gravity=t(9.81),
        w_state=t([0.5, 0.5, 0.5, 0.05, 0.05, 0.05]),
        w_control=t([0.02] * 6),
        w_fuel=t(0.05),
        w_final=t([200.0, 200.0, 200.0, 20.0, 20.0, 20.0]),
        u_min=t([0.0] * 6),
        u_max=t([15.0] * 6),
    )


def params_from_numpy(tree) -> OmniThrusterParams:
    """The port's params from any params object with the same field names
    whose leaves convert with ``np.asarray``. Dtypes are kept."""
    return OmniThrusterParams(**{
        f: torch.from_numpy(np.array(getattr(tree, f)))
        for f in OmniThrusterParams._fields})


def hover_control(p: OmniThrusterParams) -> torch.Tensor:
    """Thrusts that cancel gravity at rest: the +z thruster carries m·g,
    the others idle (the workload's u0; a zero-thrust rollout free-falls)."""
    u = torch.zeros(6, dtype=p.mass.dtype)
    u[4] = p.mass * p.gravity
    return u


def _accel(p, v, u_pos, u_neg, axis):
    inv_m = 1.0 / p.mass
    a = (u_pos - u_neg) * inv_m - p.drag * torch.abs(v) * v
    if axis == 2:
        a = a - p.gravity
    return a


def dynamics_soa(p: OmniThrusterParams, x, u):
    return torch.stack([
        x[3], x[4], x[5],
        _accel(p, x[3], u[0], u[1], 0),
        _accel(p, x[4], u[2], u[3], 1),
        _accel(p, x[5], u[4], u[5], 2),
    ])


dynamics = dynamics_soa   # elementwise, so it serves one problem too


def cost(p: OmniThrusterParams, x, u):
    e = p.goal - x
    return (torch.dot(e * p.w_state, e) + torch.dot(u * p.w_control, u)
            + p.w_fuel * torch.sum(u))


def final_cost(p: OmniThrusterParams, x):
    e = p.goal - x
    return torch.dot(e * p.w_final, e)


def _weighted_sq(goal, w, x):
    acc = None
    for i in range(6):
        e = goal[i] - x[i]
        acc = e * w[i] * e if acc is None else acc + e * w[i] * e
    return acc


def cost_soa(p: OmniThrusterParams, x, u):
    acc = _weighted_sq(p.goal, p.w_state, x)
    for j in range(6):
        acc = acc + u[j] * (p.w_control[j] * u[j] + p.w_fuel)
    return acc


def final_cost_soa(p: OmniThrusterParams, x):
    return _weighted_sq(p.goal, p.w_final, x)


def jac_soa(p: OmniThrusterParams, x, u):
    """Closed-form continuous-time Jacobians; structural zeros and ones are
    Python floats (csrc/omni_thruster.cuh holds the same pattern).
    d|v|·v/dv = 2|v|."""
    inv_m = 1.0 / p.mass
    A = [[0.0] * 6 for _ in range(6)]
    for a in range(3):
        A[a][3 + a] = 1.0
        A[3 + a][3 + a] = -2.0 * p.drag * torch.abs(x[3 + a])
    B = [[0.0] * 6 for _ in range(6)]
    for a in range(3):
        B[3 + a][2 * a] = inv_m
        B[3 + a][2 * a + 1] = -inv_m
    return A, B


def cost_derivs_soa(p: OmniThrusterParams, x, u):
    cx = [-2.0 * p.w_state[i] * (p.goal[i] - x[i]) for i in range(6)]
    cu = [2.0 * p.w_control[j] * u[j] + p.w_fuel for j in range(6)]
    cxx = [[2.0 * p.w_state[i] if i == j else 0.0 for j in range(6)]
           for i in range(6)]
    cxu = [[0.0] * 6 for _ in range(6)]
    cuu = [[2.0 * p.w_control[i] if i == j else 0.0 for j in range(6)]
           for i in range(6)]
    return cx, cu, cxx, cxu, cuu


def final_cost_derivs_soa(p: OmniThrusterParams, x):
    cx = [-2.0 * p.w_final[i] * (p.goal[i] - x[i]) for i in range(6)]
    cxx = [[2.0 * p.w_final[i] if i == j else 0.0 for j in range(6)]
           for i in range(6)]
    return cx, cxx


MODEL = Model(
    name="omni_thruster",
    n=6,
    m=6,
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
