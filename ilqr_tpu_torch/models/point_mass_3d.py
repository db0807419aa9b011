"""3D point mass, the m = 3 workload (counterpart of
``ilqr_tpu/models/point_mass_3d.py``).

  state  = [x, y, z, vx, vy, vz], control = [Fx, Fy, Fz]
  dx     = [v, F/m]                       (double_integrator.h:29-37 pattern)
  cost   = (g-x)ᵀ Hx (g-x) + uᵀ Hu u
  final  = final_scale · (g-x)ᵀ Hx (g-x)

The SoA functions keep the operation order of the JAX package's, which
csrc/point_mass_3d.cuh repeats.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch.models.base import Model


class PointMass3DParams(NamedTuple):
    goal: torch.Tensor         # (6,)
    mass: torch.Tensor         # scalar
    hx_diag: torch.Tensor      # (6,) diagonal of Hx
    hu_diag: torch.Tensor      # (3,) diagonal of Hu
    final_scale: torch.Tensor  # scalar
    u_min: torch.Tensor        # (3,)
    u_max: torch.Tensor        # (3,)


def default_params(goal=(1.0, 0.5, -0.5, 0.0, 0.0, 0.0)) -> PointMass3DParams:
    t = lambda v: torch.tensor(v, dtype=torch.get_default_dtype())
    return PointMass3DParams(
        goal=t(goal),
        mass=t(1.0),
        hx_diag=t([1.0, 1.0, 1.0, 0.2, 0.2, 0.2]),
        hu_diag=t([1.0, 1.0, 1.0]),
        final_scale=t(10.0),
        u_min=t([-0.5, -0.5, -0.5]),
        u_max=t([0.5, 0.5, 0.5]),
    )


def params_from_numpy(tree) -> PointMass3DParams:
    """The port's params from any params object with the same field names
    whose leaves convert with ``np.asarray``. Dtypes are kept."""
    return PointMass3DParams(**{
        f: torch.from_numpy(np.array(getattr(tree, f)))
        for f in PointMass3DParams._fields})


def dynamics(p: PointMass3DParams, x, u):
    return torch.cat([x[3:], u / p.mass])


def cost(p: PointMass3DParams, x, u):
    e = p.goal - x
    return torch.dot(e * p.hx_diag, e) + torch.dot(u * p.hu_diag, u)


def final_cost(p: PointMass3DParams, x):
    e = p.goal - x
    return p.final_scale * torch.dot(e * p.hx_diag, e)


def dynamics_soa(p: PointMass3DParams, x, u):
    inv_m = 1.0 / p.mass
    return torch.stack([x[3], x[4], x[5],
                        u[0] * inv_m, u[1] * inv_m, u[2] * inv_m])


def cost_soa(p: PointMass3DParams, x, u):
    acc = (p.goal[0] - x[0]) * p.hx_diag[0] * (p.goal[0] - x[0])
    for i in range(1, 6):
        e = p.goal[i] - x[i]
        acc = acc + e * p.hx_diag[i] * e
    for j in range(3):
        acc = acc + u[j] * p.hu_diag[j] * u[j]
    return acc


def final_cost_soa(p: PointMass3DParams, x):
    acc = (p.goal[0] - x[0]) * p.hx_diag[0] * (p.goal[0] - x[0])
    for i in range(1, 6):
        e = p.goal[i] - x[i]
        acc = acc + e * p.hx_diag[i] * e
    return p.final_scale * acc


def jac_soa(p: PointMass3DParams, x, u):
    """Closed-form Jacobians of :func:`dynamics_soa`; structural constants
    are Python floats (A has 3 nonzeros of 36)."""
    inv_m = 1.0 / p.mass
    A = [[0.0] * 6 for _ in range(6)]
    for i in range(3):
        A[i][i + 3] = 1.0
    B = [[0.0] * 3 for _ in range(6)]
    for j in range(3):
        B[j + 3][j] = inv_m
    return A, B


def cost_derivs_soa(p: PointMass3DParams, x, u):
    cx = [-2.0 * p.hx_diag[i] * (p.goal[i] - x[i]) for i in range(6)]
    cu = [2.0 * p.hu_diag[j] * u[j] for j in range(3)]
    cxx = [[2.0 * p.hx_diag[i] if i == j else 0.0 for j in range(6)]
           for i in range(6)]
    cxu = [[0.0] * 3 for _ in range(6)]
    cuu = [[2.0 * p.hu_diag[i] if i == j else 0.0 for j in range(3)]
           for i in range(3)]
    return cx, cu, cxx, cxu, cuu


def final_cost_derivs_soa(p: PointMass3DParams, x):
    fs = p.final_scale
    cx = [-2.0 * fs * p.hx_diag[i] * (p.goal[i] - x[i]) for i in range(6)]
    cxx = [[2.0 * fs * p.hx_diag[i] if i == j else 0.0 for j in range(6)]
           for i in range(6)]
    return cx, cxx


MODEL = Model(
    name="point_mass_3d",
    n=6,
    m=3,
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
