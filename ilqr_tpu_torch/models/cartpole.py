"""Cart-pole swing-up (counterpart of ``ilqr_tpu/models/cartpole.py``).

  state   = [p, θ, ṗ, θ̇] with θ from the down axis (up = π)   (n = 4)
  control = [cart force]                                       (m = 1)

Frictionless cart-pole equations of motion:
  θ̈ = (−g sinθ − cosθ·(u + m_p l θ̇² sinθ)/(m_c+m_p)) /
       (l·(4/3 − m_p cos²θ/(m_c+m_p)))
  p̈ = (u + m_p l θ̇² sinθ)/(m_c+m_p) + m_p l θ̈ cosθ/(m_c+m_p)

The SoA functions keep the operation order of the JAX package's, which
csrc/cartpole.cuh repeats (``sincosf`` for ``torch.sin``/``cos``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch.models.base import Model


class CartPoleParams(NamedTuple):
    goal: torch.Tensor       # (4,)
    mass_cart: torch.Tensor
    mass_pole: torch.Tensor
    length: torch.Tensor     # half pole length
    gravity: torch.Tensor
    w_state: torch.Tensor    # (4,)
    w_control: torch.Tensor  # scalar
    w_final: torch.Tensor    # (4,)
    u_min: torch.Tensor      # (1,)
    u_max: torch.Tensor      # (1,)


def default_params(goal=(0.0, 3.14159265, 0.0, 0.0)) -> CartPoleParams:
    t = lambda v: torch.tensor(v, dtype=torch.get_default_dtype())
    return CartPoleParams(
        goal=t(goal),
        mass_cart=t(1.0),
        mass_pole=t(0.1),
        length=t(0.5),
        gravity=t(9.81),
        w_state=t([0.1, 0.1, 0.01, 0.01]),
        w_control=t(0.01),
        w_final=t([10.0, 100.0, 10.0, 10.0]),
        u_min=t([-10.0]),
        u_max=t([10.0]),
    )


def params_from_numpy(tree) -> CartPoleParams:
    """The port's params from any params object with the same field names
    whose leaves convert with ``np.asarray``. Dtypes are kept."""
    return CartPoleParams(**{
        f: torch.from_numpy(np.array(getattr(tree, f)))
        for f in CartPoleParams._fields})


def _accels(p: CartPoleParams, theta, thetadot, u0):
    """(p̈, θ̈) in the JAX package's operation order."""
    mt = p.mass_cart + p.mass_pole
    st = torch.sin(theta)
    ct = torch.cos(theta)
    temp = (u0 + p.mass_pole * p.length * thetadot * thetadot * st) / mt
    thetaddot = (-p.gravity * st - ct * temp) / (
        p.length * (4.0 / 3.0 - p.mass_pole * ct * ct / mt))
    pddot = temp + p.mass_pole * p.length * thetaddot * ct / mt
    return pddot, thetaddot


def dynamics(p: CartPoleParams, x, u):
    pddot, thetaddot = _accels(p, x[1], x[3], u[0])
    return torch.stack([x[2], x[3], pddot, thetaddot])


def cost(p: CartPoleParams, x, u):
    e = p.goal - x
    return torch.dot(e * p.w_state, e) + p.w_control * torch.dot(u, u)


def final_cost(p: CartPoleParams, x):
    e = p.goal - x
    return torch.dot(e * p.w_final, e)


def dynamics_soa(p: CartPoleParams, x, u):
    pddot, thetaddot = _accels(p, x[1], x[3], u[0])
    return torch.stack([x[2], x[3], pddot, thetaddot])


def _werr(p, x, w):
    acc = None
    for i in range(4):
        e = p.goal[i] - x[i]
        term = w[i] * e * e
        acc = term if acc is None else acc + term
    return acc


def cost_soa(p: CartPoleParams, x, u):
    return _werr(p, x, p.w_state) + p.w_control * u[0] * u[0]


def final_cost_soa(p: CartPoleParams, x):
    return _werr(p, x, p.w_final)


def jac_soa(p: CartPoleParams, x, u):
    """Closed-form Jacobians of :func:`dynamics_soa`: columns 0 and 2 of A
    are structural zeros (Python floats). With N = −g·sinθ − cosθ·temp and
    D = l·(4/3 − k·cos²θ): ∂θ̈ = (∂N − θ̈·∂D)/D, ∂p̈ = ∂temp + k·l·∂(θ̈·cosθ),
    one reciprocal per distinct denominator (mt, D)."""
    theta, thetadot = x[1], x[3]
    mt = p.mass_cart + p.mass_pole
    rmt = 1.0 / mt
    k = p.mass_pole * rmt
    kl = k * p.length
    st = torch.sin(theta)
    ct = torch.cos(theta)
    temp = (u[0] + p.mass_pole * p.length * thetadot * thetadot * st) * rmt
    dtemp_dth = kl * thetadot * thetadot * ct
    dtemp_dw = 2.0 * kl * thetadot * st
    rD = 1.0 / (p.length * (4.0 / 3.0 - k * ct * ct))
    a2 = (-p.gravity * st - ct * temp) * rD          # θ̈
    dD_dth = 2.0 * p.length * k * ct * st
    dN_dth = -p.gravity * ct + st * temp - ct * dtemp_dth
    da2_dth = (dN_dth - a2 * dD_dth) * rD
    da2_dw = -ct * dtemp_dw * rD
    da2_du = -ct * rmt * rD
    da1_dth = dtemp_dth + kl * (da2_dth * ct - a2 * st)
    da1_dw = dtemp_dw + kl * ct * da2_dw
    da1_du = rmt + kl * ct * da2_du
    A = [[0.0, 0.0, 1.0, 0.0],
         [0.0, 0.0, 0.0, 1.0],
         [0.0, da1_dth, 0.0, da1_dw],
         [0.0, da2_dth, 0.0, da2_dw]]
    B = [[0.0], [0.0], [da1_du], [da2_du]]
    return A, B


def cost_derivs_soa(p: CartPoleParams, x, u):
    cx = [-2.0 * p.w_state[i] * (p.goal[i] - x[i]) for i in range(4)]
    cu = [2.0 * p.w_control * u[0]]
    cxx = [[2.0 * p.w_state[i] if i == j else 0.0 for j in range(4)]
           for i in range(4)]
    cxu = [[0.0], [0.0], [0.0], [0.0]]
    cuu = [[2.0 * p.w_control]]
    return cx, cu, cxx, cxu, cuu


def final_cost_derivs_soa(p: CartPoleParams, x):
    cx = [-2.0 * p.w_final[i] * (p.goal[i] - x[i]) for i in range(4)]
    cxx = [[2.0 * p.w_final[i] if i == j else 0.0 for j in range(4)]
           for i in range(4)]
    return cx, cxx


MODEL = Model(
    name="cartpole",
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
