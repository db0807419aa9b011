"""Torque-limited pendulum swing-up (counterpart of
``ilqr_tpu/models/pendulum.py``).

  state   = [θ, θ̇] with θ from the down axis (up = π)   (n = 2)
  control = [torque]                                    (m = 1)

  θ̈ = (u − b·θ̇ − m·g·l·sin θ) / (m·l²)

Quadratic state + control running cost, quadratic final cost. The SoA
functions keep the operation order of the JAX package's, which
csrc/pendulum.cuh repeats (``sinf``/``cosf`` for ``torch.sin``/``cos``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch.models.base import Model


class PendulumParams(NamedTuple):
    goal: torch.Tensor       # (2,)
    mass: torch.Tensor
    length: torch.Tensor
    damping: torch.Tensor
    gravity: torch.Tensor
    w_state: torch.Tensor    # (2,) running state weights
    w_control: torch.Tensor  # scalar
    w_final: torch.Tensor    # (2,) final state weights
    u_min: torch.Tensor      # (1,)
    u_max: torch.Tensor      # (1,)


def default_params(goal=(3.14159265, 0.0)) -> PendulumParams:
    t = lambda v: torch.tensor(v, dtype=torch.get_default_dtype())
    return PendulumParams(
        goal=t(goal),
        mass=t(1.0),
        length=t(1.0),
        damping=t(0.05),
        gravity=t(9.81),
        w_state=t([0.1, 0.01]),
        w_control=t(0.01),
        w_final=t([100.0, 10.0]),
        u_min=t([-2.5]),
        u_max=t([2.5]),
    )


def params_from_numpy(tree) -> PendulumParams:
    """The port's params from any params object with the same field names
    whose leaves convert with ``np.asarray`` (the JAX package's params
    after ``tree_map(np.asarray)``). Dtypes are kept."""
    return PendulumParams(**{
        f: torch.from_numpy(np.array(getattr(tree, f)))
        for f in PendulumParams._fields})


def dynamics(p: PendulumParams, x, u):
    theta, thetadot = x[0], x[1]
    inertia = p.mass * p.length * p.length
    thetaddot = (
        u[0] - p.damping * thetadot
        - p.mass * p.gravity * p.length * torch.sin(theta)) / inertia
    return torch.stack([thetadot, thetaddot])


def cost(p: PendulumParams, x, u):
    e = p.goal - x
    return torch.dot(e * p.w_state, e) + p.w_control * torch.dot(u, u)


def final_cost(p: PendulumParams, x):
    e = p.goal - x
    return torch.dot(e * p.w_final, e)


def dynamics_soa(p: PendulumParams, x, u):
    inertia = p.mass * p.length * p.length
    thetaddot = (
        u[0] - p.damping * x[1]
        - p.mass * p.gravity * p.length * torch.sin(x[0])) / inertia
    return torch.stack([x[1], thetaddot])


def cost_soa(p: PendulumParams, x, u):
    e0 = p.goal[0] - x[0]
    e1 = p.goal[1] - x[1]
    return (p.w_state[0] * e0 * e0 + p.w_state[1] * e1 * e1
            + p.w_control * u[0] * u[0])


def final_cost_soa(p: PendulumParams, x):
    e0 = p.goal[0] - x[0]
    e1 = p.goal[1] - x[1]
    return p.w_final[0] * e0 * e0 + p.w_final[1] * e1 * e1


def jac_soa(p: PendulumParams, x, u):
    """Closed-form Jacobians of :func:`dynamics_soa`; structural constants
    are Python floats."""
    inertia = p.mass * p.length * p.length
    a10 = -p.gravity / p.length * torch.cos(x[0])
    a11 = -p.damping / inertia
    A = [[0.0, 1.0], [a10, a11]]
    B = [[0.0], [1.0 / inertia]]
    return A, B


def cost_derivs_soa(p: PendulumParams, x, u):
    cx = [-2.0 * p.w_state[i] * (p.goal[i] - x[i]) for i in range(2)]
    cu = [2.0 * p.w_control * u[0]]
    cxx = [[2.0 * p.w_state[i] if i == j else 0.0 for j in range(2)]
           for i in range(2)]
    cxu = [[0.0], [0.0]]
    cuu = [[2.0 * p.w_control]]
    return cx, cu, cxx, cxu, cuu


def final_cost_derivs_soa(p: PendulumParams, x):
    cx = [-2.0 * p.w_final[i] * (p.goal[i] - x[i]) for i in range(2)]
    cxx = [[2.0 * p.w_final[i] if i == j else 0.0 for j in range(2)]
           for i in range(2)]
    return cx, cxx


MODEL = Model(
    name="pendulum",
    n=2,
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
