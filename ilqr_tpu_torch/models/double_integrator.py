"""2D double integrator (counterpart of
``ilqr_tpu/models/double_integrator.py``).

Math matches ref include/double_integrator.h exactly:
  state  = [x, y, vx, vy], control = [Fx, Fy]
  dx     = [vx, vy, Fx/m, Fy/m]                        (:29-37)
  cost   = (g-x)ᵀ Hx (g-x) + uᵀ Hu u,  Hx=diag(1,1,.2,.2), Hu=I  (:19-24,39-43)
  final  = (g-x)ᵀ (10·Hx) (g-x)                        (:45-48)
  limits = ±0.5, mass = 1                              (:25-26,51)

The SoA functions keep the operation order of the JAX package's, which
csrc/double_integrator.cuh repeats.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch.models.base import Model


class DoubleIntegratorParams(NamedTuple):
    goal: torch.Tensor         # (4,)
    mass: torch.Tensor         # scalar
    hx_diag: torch.Tensor      # (4,) diagonal of Hx
    hu_diag: torch.Tensor      # (2,) diagonal of Hu
    final_scale: torch.Tensor  # scalar (10 in the reference)
    u_min: torch.Tensor        # (2,)
    u_max: torch.Tensor        # (2,)


def default_params(goal=(1.0, 0.5, 0.0, 0.0)) -> DoubleIntegratorParams:
    t = lambda v: torch.tensor(v, dtype=torch.get_default_dtype())
    return DoubleIntegratorParams(
        goal=t(goal),
        mass=t(1.0),
        hx_diag=t([1.0, 1.0, 0.2, 0.2]),
        hu_diag=t([1.0, 1.0]),
        final_scale=t(10.0),
        u_min=t([-0.5, -0.5]),
        u_max=t([0.5, 0.5]),
    )


def params_from_numpy(tree) -> DoubleIntegratorParams:
    """The port's params from any params object with the same field names
    whose leaves convert with ``np.asarray`` (the JAX package's params
    after ``tree_map(np.asarray)``). Dtypes are kept."""
    return DoubleIntegratorParams(**{
        f: torch.from_numpy(np.array(getattr(tree, f)))
        for f in DoubleIntegratorParams._fields})


def dynamics(p: DoubleIntegratorParams, x, u):
    return torch.cat([x[2:4], u / p.mass])


def cost(p: DoubleIntegratorParams, x, u):
    e = p.goal - x
    return torch.dot(e * p.hx_diag, e) + torch.dot(u * p.hu_diag, u)


def final_cost(p: DoubleIntegratorParams, x):
    e = p.goal - x
    return p.final_scale * torch.dot(e * p.hx_diag, e)


def dynamics_soa(p: DoubleIntegratorParams, x, u):
    return torch.stack([x[2], x[3], u[0] / p.mass, u[1] / p.mass])


def _state_err_sq(p, x):
    acc = None
    for i in range(4):
        e = p.goal[i] - x[i]
        term = p.hx_diag[i] * e * e
        acc = term if acc is None else acc + term
    return acc


def cost_soa(p: DoubleIntegratorParams, x, u):
    return (_state_err_sq(p, x)
            + p.hu_diag[0] * u[0] * u[0] + p.hu_diag[1] * u[1] * u[1])


def final_cost_soa(p: DoubleIntegratorParams, x):
    return p.final_scale * _state_err_sq(p, x)


def jac_soa(p: DoubleIntegratorParams, x, u):
    """Closed-form Jacobians of :func:`dynamics_soa`; structural constants
    are Python floats."""
    inv_m = 1.0 / p.mass
    A = [[0.0, 0.0, 1.0, 0.0],
         [0.0, 0.0, 0.0, 1.0],
         [0.0, 0.0, 0.0, 0.0],
         [0.0, 0.0, 0.0, 0.0]]
    B = [[0.0, 0.0], [0.0, 0.0], [inv_m, 0.0], [0.0, inv_m]]
    return A, B


def cost_derivs_soa(p: DoubleIntegratorParams, x, u):
    cx = [-2.0 * p.hx_diag[i] * (p.goal[i] - x[i]) for i in range(4)]
    cu = [2.0 * p.hu_diag[j] * u[j] for j in range(2)]
    cxx = [[2.0 * p.hx_diag[i] if i == j else 0.0 for j in range(4)]
           for i in range(4)]
    cxu = [[0.0, 0.0] for _ in range(4)]
    cuu = [[2.0 * p.hu_diag[i] if i == j else 0.0 for j in range(2)]
           for i in range(2)]
    return cx, cu, cxx, cxu, cuu


def final_cost_derivs_soa(p: DoubleIntegratorParams, x):
    fs = p.final_scale
    cx = [-2.0 * fs * p.hx_diag[i] * (p.goal[i] - x[i]) for i in range(4)]
    cxx = [[2.0 * fs * p.hx_diag[i] if i == j else 0.0 for j in range(4)]
           for i in range(4)]
    return cx, cxx


MODEL = Model(
    name="double_integrator",
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
