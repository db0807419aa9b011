"""Model abstraction (counterpart of ``ilqr_tpu/models/base.py``).

A model is three pure functions — ``dynamics(params, x, u) -> dx``,
``cost(params, x, u) -> scalar``, ``final_cost(params, x) -> scalar`` — plus
static dims (ref: include/model.h:6-21). Parameters (goal, masses, control
limits, …) are a NamedTuple of tensors.

The optional ``*_soa`` functions are the structure-of-arrays variants the
fused solver's plain versions use: they receive ``x`` of shape (n, *batch)
and ``u`` of shape (m, *batch), index only leading axes and use only
elementwise ops. The analytic ones return nested lists whose STRUCTURALLY
constant entries are plain Python floats; the sweep folds products and sums
with such constants out (ops/kernel_sweep.py ``_fmul``/``_fadd``), as the
JAX package does, and the CUDA kernels skip the same terms.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Tensor = torch.Tensor
DynamicsFn = Callable[[Any, Tensor, Tensor], Tensor]
CostFn = Callable[[Any, Tensor, Tensor], Tensor]
FinalCostFn = Callable[[Any, Tensor], Tensor]


@dataclasses.dataclass(frozen=True)
class Model:
    """Static model definition.

    ``jac_soa(p, x, u) -> (A, B)``: continuous-time Jacobians of
    ``dynamics`` (n×n and n×m nested lists); the sweep forms the Euler step's
    fx = I + dt·A, fu = dt·B. ``cost_derivs_soa(p, x, u) -> (cx, cu, cxx,
    cxu, cuu)`` and ``final_cost_derivs_soa(p, x) -> (cx, cxx)`` are the
    cost derivatives.
    """

    name: str
    n: int  # state dims   (ref: model.h:19 x_dims)
    m: int  # control dims (ref: model.h:20 u_dims)
    dynamics: DynamicsFn
    cost: CostFn
    final_cost: FinalCostFn
    default_params: Callable[[], Any]
    dynamics_soa: Any = None
    cost_soa: Any = None
    final_cost_soa: Any = None
    jac_soa: Any = None
    cost_derivs_soa: Any = None
    final_cost_derivs_soa: Any = None

    @property
    def has_soa(self) -> bool:
        return (self.dynamics_soa is not None and self.cost_soa is not None
                and self.final_cost_soa is not None)

    @property
    def has_analytic_soa(self) -> bool:
        return (self.jac_soa is not None
                and self.cost_derivs_soa is not None
                and self.final_cost_derivs_soa is not None)

    def __hash__(self):  # identity of the registered functions
        return hash((self.name, self.n, self.m))


def euler_step(model: Model, params, x: Tensor, u: Tensor, dt) -> Tensor:
    """Explicit Euler: x + f(x,u)·dt (ref: include/model.h:12-15)."""
    return x + model.dynamics(params, x, u) * dt


def rk4_step(model: Model, params, x: Tensor, u: Tensor, dt) -> Tensor:
    """Classic RK4 with zero-order-hold control."""
    f = lambda xx: model.dynamics(params, xx, u)
    k1 = f(x)
    k2 = f(x + 0.5 * dt * k1)
    k3 = f(x + 0.5 * dt * k2)
    k4 = f(x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


_INTEGRATORS = {"euler": euler_step, "rk4": rk4_step}


def get_integrator(name: str):
    try:
        return _INTEGRATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown integrator {name!r}; have {sorted(_INTEGRATORS)}"
        ) from None
