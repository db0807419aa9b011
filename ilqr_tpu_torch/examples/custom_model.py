"""Defining your own model — the user-extension point (counterpart of
``examples/custom_model.py``).

In the reference you subclass ``Model`` and override three virtuals
(ref: include/model.h:8-10). Here a model is three pure functions over a
params NamedTuple plus static dims; registering it
(``ilqr_tpu_torch.models.register``) makes it available to ``get_model``,
and its SoA variants opt it into the CUDA kernels: on first use on the card
they are recorded, emitted as the model's device functions and built with
the hand-written kernels into a library of its own (ops/codegen.py,
``ops._build.build_model``). The SoA functions may index leading axes and
use ``+ - * /``, unary minus, ``torch.sin``, ``torch.cos``, ``torch.tan``,
``torch.abs`` and ``torch.stack``.

This example: a planar unicycle (Dubins car with velocity control) driving
to a pose, in the JAX example's operation order; beside it
``UNICYCLE_HEADING``, its m = 1 companion at a fixed forward speed, whose
turn rate passes a steering reduction (a division by a constant).

  python -m ilqr_tpu_torch.examples.custom_model [--cpu]
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch.models.base import Model


def _t(v):
    return torch.tensor(v, dtype=torch.get_default_dtype())


class UnicycleParams(NamedTuple):
    goal: torch.Tensor       # (3,) [x, y, θ]
    w_pos: torch.Tensor      # scalar
    w_theta: torch.Tensor
    w_control: torch.Tensor  # (2,) [v, ω] weights
    w_final: torch.Tensor    # scalar multiplier on the state error
    u_min: torch.Tensor      # (2,)
    u_max: torch.Tensor      # (2,)


def default_params(goal=(2.0, 1.0, 0.0)) -> UnicycleParams:
    return UnicycleParams(
        goal=_t(goal),
        w_pos=_t(1.0),
        w_theta=_t(0.3),
        w_control=_t([0.05, 0.05]),
        w_final=_t(50.0),
        u_min=_t([-1.0, -2.0]),
        u_max=_t([2.0, 2.0]),
    )


def _from_numpy(cls, tree):
    return cls(**{f: torch.from_numpy(np.array(getattr(tree, f)))
                  for f in cls._fields})


def params_from_numpy(tree) -> UnicycleParams:
    """The port's params from any params object with the same field names
    whose leaves convert with ``np.asarray`` (the JAX example's params
    after ``tree_map(np.asarray)``). Dtypes are kept."""
    return _from_numpy(UnicycleParams, tree)


def dynamics(p: UnicycleParams, x, u):
    # ẋ = v cosθ, ẏ = v sinθ, θ̇ = ω
    return torch.stack([u[0] * torch.cos(x[2]), u[0] * torch.sin(x[2]),
                        u[1]])


def _state_err(p, x):
    e = p.goal - x
    return (p.w_pos * (e[0] * e[0] + e[1] * e[1])
            + p.w_theta * e[2] * e[2])


def cost(p: UnicycleParams, x, u):
    return (_state_err(p, x)
            + p.w_control[0] * u[0] * u[0] + p.w_control[1] * u[1] * u[1])


def final_cost(p: UnicycleParams, x):
    return p.w_final * _state_err(p, x)


# The per-problem functions above already index only leading axes and use
# elementwise ops, so they double as their own SoA variants — the common
# case for models without matrix solves in the dynamics.
UNICYCLE = Model(
    name="unicycle",
    n=3,
    m=2,
    dynamics=dynamics,
    cost=cost,
    final_cost=final_cost,
    default_params=default_params,
    dynamics_soa=dynamics,
    cost_soa=cost,
    final_cost_soa=final_cost,
)


# --- the m = 1 companion: forward speed fixed, the turn rate commanded
# through a steering reduction

STEER_RATIO = 3.0   # commanded turn rate : heading rate


class HeadingParams(NamedTuple):
    goal: torch.Tensor       # (3,) [x, y, θ]
    v: torch.Tensor          # forward speed
    w_pos: torch.Tensor
    w_theta: torch.Tensor
    w_control: torch.Tensor  # (1,)
    w_final: torch.Tensor
    u_min: torch.Tensor      # (1,)
    u_max: torch.Tensor      # (1,)


def heading_default_params(goal=(2.0, 1.0, 0.0)) -> HeadingParams:
    return HeadingParams(
        goal=_t(goal),
        v=_t(0.5),
        w_pos=_t(1.0),
        w_theta=_t(0.3),
        w_control=_t([0.05]),
        w_final=_t(50.0),
        u_min=_t([-3.0]),
        u_max=_t([3.0]),
    )


def heading_params_from_numpy(tree) -> HeadingParams:
    """As :func:`params_from_numpy`, for :data:`UNICYCLE_HEADING`."""
    return _from_numpy(HeadingParams, tree)


def heading_dynamics(p: HeadingParams, x, u):
    return torch.stack([p.v * torch.cos(x[2]), p.v * torch.sin(x[2]),
                        u[0] / STEER_RATIO])


def heading_cost(p: HeadingParams, x, u):
    return _state_err(p, x) + p.w_control[0] * u[0] * u[0]


def heading_final_cost(p: HeadingParams, x):
    return p.w_final * _state_err(p, x)


UNICYCLE_HEADING = Model(
    name="unicycle_heading",
    n=3,
    m=1,
    dynamics=heading_dynamics,
    cost=heading_cost,
    final_cost=heading_final_cost,
    default_params=heading_default_params,
    dynamics_soa=heading_dynamics,
    cost_soa=heading_cost,
    final_cost_soa=heading_final_cost,
)


def register_models():
    """Registers both models unless already registered; returns them."""
    from ilqr_tpu_torch.models import get_model, list_models, register

    for model in (UNICYCLE, UNICYCLE_HEADING):
        if model.name not in list_models():
            register(model)
        elif get_model(model.name) is not model:
            raise ValueError(f"another model is registered as "
                             f"{model.name!r}")
    return UNICYCLE, UNICYCLE_HEADING


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    args = ap.parse_args(argv)

    from ilqr_tpu_torch import SolverConfig, solve

    register_models()   # now get_model("unicycle") works everywhere

    p = default_params()
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True)
    sol = solve(UNICYCLE, p, cfg, 0.05, np.zeros(3, np.float32),
                np.zeros((80, 2), np.float32),
                device="cpu" if args.cpu else None)
    xf = sol.xs[-1]
    print(f"cost {float(sol.cost):.4f}  iters {int(sol.iterations)}  "
          f"final pose ({float(xf[0]):.3f}, {float(xf[1]):.3f}, "
          f"{float(xf[2]):.3f})  goal {tuple(map(float, p.goal))}")
    return sol


if __name__ == "__main__":
    main()
