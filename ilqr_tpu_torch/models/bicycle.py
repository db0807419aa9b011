"""Kinematic bicycle (car), an m = 2 driving workload (counterpart of
``ilqr_tpu/models/bicycle.py``).

  state   = [px, py, ψ (heading), v]          (n = 4)
  control = [a (accel), δ (steering angle)]   (m = 2)

  ṗx = v cos ψ      ṗy = v sin ψ
  ψ̇  = v tan δ / L   v̇ = a

Quadratic pose/speed tracking cost; the accel box is asymmetric (braking
stronger than throttle, a ∈ [−4, 2] m/s²), so the box QP's clamped set is
exercised off centre. The SoA functions keep the operation order of the
JAX package's, which csrc/bicycle.cuh repeats (``sincosf`` and the
full-accuracy ``tanf`` for ``torch.sin``/``cos``/``tan``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch.models.base import Model


class BicycleParams(NamedTuple):
    goal: torch.Tensor       # (4,) [px, py, ψ, v]
    wheelbase: torch.Tensor  # scalar L
    w_state: torch.Tensor    # (4,) running weights
    w_control: torch.Tensor  # (2,)
    w_final: torch.Tensor    # (4,)
    u_min: torch.Tensor      # (2,) [a_min, δ_min]
    u_max: torch.Tensor      # (2,)


def default_params(goal=(5.0, 2.0, 0.0, 0.0)) -> BicycleParams:
    t = lambda v: torch.tensor(v, dtype=torch.get_default_dtype())
    return BicycleParams(
        goal=t(goal),
        wheelbase=t(2.7),
        w_state=t([0.1, 0.1, 0.05, 0.05]),
        w_control=t([0.5, 2.0]),
        w_final=t([100.0, 100.0, 50.0, 50.0]),
        u_min=t([-4.0, -0.55]),
        u_max=t([2.0, 0.55]),
    )


def params_from_numpy(tree) -> BicycleParams:
    """The port's params from any params object with the same field names
    whose leaves convert with ``np.asarray``. Dtypes are kept."""
    return BicycleParams(**{
        f: torch.from_numpy(np.array(getattr(tree, f)))
        for f in BicycleParams._fields})


def dynamics(p: BicycleParams, x, u):
    psi, v = x[2], x[3]
    return torch.stack([
        v * torch.cos(psi),
        v * torch.sin(psi),
        v * torch.tan(u[1]) / p.wheelbase,
        u[0] + 0.0 * v,
    ])


def cost(p: BicycleParams, x, u):
    e = p.goal - x
    return torch.dot(e * p.w_state, e) + torch.dot(u * p.w_control, u)


def final_cost(p: BicycleParams, x):
    e = p.goal - x
    return torch.dot(e * p.w_final, e)


def dynamics_soa(p: BicycleParams, x, u):
    psi, v = x[2], x[3]
    inv_L = 1.0 / p.wheelbase
    return torch.stack([
        v * torch.cos(psi),
        v * torch.sin(psi),
        v * torch.tan(u[1]) * inv_L,
        u[0] + 0.0 * v,
    ])


def _werr(p, x, w):
    acc = None
    for i in range(4):
        e = p.goal[i] - x[i]
        acc = e * w[i] * e if acc is None else acc + e * w[i] * e
    return acc


def cost_soa(p: BicycleParams, x, u):
    acc = _werr(p, x, p.w_state)
    for j in range(2):
        acc = acc + u[j] * p.w_control[j] * u[j]
    return acc


def final_cost_soa(p: BicycleParams, x):
    return _werr(p, x, p.w_final)


def jac_soa(p: BicycleParams, x, u):
    """Closed-form continuous-time Jacobians; structural constants are
    Python floats (6 live A entries of 16, B[3][0] a structural one)."""
    psi, v = x[2], x[3]
    sp, cp = torch.sin(psi), torch.cos(psi)
    inv_L = 1.0 / p.wheelbase
    td = torch.tan(u[1])
    sec2 = 1.0 + td * td
    A = [[0.0] * 4 for _ in range(4)]
    A[0][2] = -v * sp
    A[0][3] = cp
    A[1][2] = v * cp
    A[1][3] = sp
    A[2][3] = td * inv_L
    B = [[0.0] * 2 for _ in range(4)]
    B[2][1] = v * sec2 * inv_L
    B[3][0] = 1.0
    return A, B


def cost_derivs_soa(p: BicycleParams, x, u):
    cx = [-2.0 * p.w_state[i] * (p.goal[i] - x[i]) for i in range(4)]
    cu = [2.0 * p.w_control[j] * u[j] for j in range(2)]
    cxx = [[2.0 * p.w_state[i] if i == j else 0.0 for j in range(4)]
           for i in range(4)]
    cxu = [[0.0] * 2 for _ in range(4)]
    cuu = [[2.0 * p.w_control[i] if i == j else 0.0 for j in range(2)]
           for i in range(2)]
    return cx, cu, cxx, cxu, cuu


def final_cost_derivs_soa(p: BicycleParams, x):
    cx = [-2.0 * p.w_final[i] * (p.goal[i] - x[i]) for i in range(4)]
    cxx = [[2.0 * p.w_final[i] if i == j else 0.0 for j in range(4)]
           for i in range(4)]
    return cx, cxx


MODEL = Model(
    name="bicycle",
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
