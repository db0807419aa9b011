"""Receding-horizon MPC (counterpart of ``ilqr_tpu/mpc.py``): one
controller on the composable solver (``mpc_init``, ``mpc_step``,
``make_mpc_controller``, ``run_mpc``) and whole fleets on the fused solver
(``fleet_init``, ``fleet_step``).

One replanning cycle of a whole fleet (a single controller's is the same,
with a warm composable solve of its one problem):

  1. each controller applies its plan's first control with its feedback
     correction, u = ū₀ + K₀ (x − x̄₀) (clamped to the box when
     ``cfg.clamp_forward``), and the plant takes one step of the configured
     integrator;
  2. the plan shifts by one step (receding horizon: us, xs and K lose their
     first row and repeat their last);
  3. one warm-started fused batch solve re-plans every controller from the
     shifted plan with its λ/dλ carried (ref generate_trajectory overload
     2, ilqr_core.cpp:65-76; the reference's λ statics, ilqr.h:17-18, made
     explicit).

The plant step is plain tensor code on lane-last tensors, as the JAX
package's is XLA code (a vmapped step, no kernel); the re-plan runs the
solver's kernels on the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ilqr_tpu_torch.config import SolverConfig
from ilqr_tpu_torch.fused import solve_batch_fused, solve_batch_fused_warm
from ilqr_tpu_torch.models.base import Model
from ilqr_tpu_torch.ops.kernel_rollout import (
    batch_first,
    closed_loop_step,
    lane_last,
    pack_params,
    unpack_params,
)
from ilqr_tpu_torch.solver import as_f32, solve, solve_warm
from ilqr_tpu_torch.types import Solution


class MPCState(NamedTuple):
    """Controller state between replanning steps: the observed state x,
    the last plan (a Solution; its us[0] is the next control) and the step
    counter t (int32). A fleet's carries a leading fleet axis B on each:
    x (B, n), a Solution of B problems, t (B,)."""

    x: torch.Tensor
    plan: Solution
    t: torch.Tensor


def fleet_init(model: Model, params, cfg: SolverConfig, dt, x0s, u0,
               device=None) -> MPCState:
    """Cold-plans a whole fleet with the fused batch solver: x0s (B, n),
    u0 (T, m) shared initial guess (or (B, T, m)). ``device`` as in
    :func:`~ilqr_tpu_torch.fused.solve_batch_fused`; the state lives
    there."""
    sol = solve_batch_fused(model, params, cfg, dt, x0s, u0, device=device)
    dev = sol.cost.device
    x = as_f32(x0s, dev)
    return MPCState(x=x, plan=sol,
                    t=torch.zeros((x.shape[0],), dtype=torch.int32,
                                  device=dev))


def plant_step(model: Model, params, cfg: SolverConfig, dt,
               state: MPCState) -> torch.Tensor:
    """Each controller's first control with its feedback, u = ū₀ +
    K₀ (x − x̄₀) (clamped when ``cfg.clamp_forward``), through one step of
    ``cfg.integrator``: the next states (B, n)."""
    plan = state.plan
    p, dt_t = unpack_params(pack_params(params, dt, state.x.device))
    _u, _c, x_next = closed_loop_step(
        model, p, dt_t, cfg.integrator, cfg.clamp_forward,
        lane_last(state.x), lane_last(plan.us[:, 0]),
        lane_last(plan.xs[:, 0]), lane_last(plan.K[:, 0]))
    return batch_first(x_next)


def _shift(a: torch.Tensor) -> torch.Tensor:
    """Receding-horizon shift along time (axis 1): drop row 0, repeat the
    last row."""
    return torch.cat([a[:, 1:], a[:, -1:]], dim=1)


def fleet_step(model: Model, params, cfg: SolverConfig, dt, state: MPCState,
               disturbance=None) -> MPCState:
    """One replanning cycle for the whole fleet (see the module docstring):
    apply each controller's first control, simulate, shift, warm re-solve
    everything with one fused batch solve on the state's device.
    ``disturbance`` (optional, (B, n) or (n,)) is added to the simulated
    next states to exercise the feedback."""
    dev = state.x.device
    x_next = plant_step(model, params, cfg, dt, state)
    if disturbance is not None:
        x_next = x_next + as_f32(disturbance, dev)
    plan = state.plan
    prev = plan._replace(us=_shift(plan.us), xs=_shift(plan.xs),
                         K=_shift(plan.K))
    sol = solve_batch_fused_warm(model, params, cfg, dt, x_next, prev,
                                 device=dev)
    return MPCState(x=x_next, plan=sol, t=state.t + 1)


# ---------------------------------------------------------------------------
# One controller on the composable solver
# ---------------------------------------------------------------------------

def mpc_init(model: Model, params, cfg: SolverConfig, dt, x0, u0,
             device=None) -> MPCState:
    """The first plan, a cold :func:`~ilqr_tpu_torch.solver.solve` of x0
    (n,) from u0 (T, m); ``device`` as there, and the state lives on it."""
    sol = solve(model, params, cfg, dt, x0, u0, device=device)
    dev = sol.cost.device
    return MPCState(x=as_f32(x0, dev), plan=sol,
                    t=torch.zeros((), dtype=torch.int32, device=dev))


def mpc_step(model: Model, params, cfg: SolverConfig, dt, state: MPCState,
             disturbance=None) -> MPCState:
    """One replanning cycle of one controller on the state's device: apply
    the plan's first control with its feedback, simulate one step (plus
    ``disturbance``, optional (n,)), shift the plan and re-solve it warm
    (:func:`~ilqr_tpu_torch.solver.solve_warm`, λ and dλ carried)."""
    dev = state.x.device
    plan = Solution(*(a[None] for a in state.plan))     # one lane
    x_next = plant_step(model, params, cfg, dt, MPCState(
        x=state.x[None], plan=plan, t=state.t[None]))[0]
    if disturbance is not None:
        x_next = x_next + as_f32(disturbance, dev)
    prev = plan._replace(us=_shift(plan.us), xs=_shift(plan.xs),
                         K=_shift(plan.K))
    sol = solve_warm(model, params, cfg, dt, x_next,
                     Solution(*(a[0] for a in prev)), device=dev)
    return MPCState(x=x_next, plan=sol, t=state.t + 1)


def make_mpc_controller(model: Model, cfg: SolverConfig, dt):
    """(init_fn, step_fn): :func:`mpc_init` and :func:`mpc_step` with the
    model, config and dt bound (the JAX package jits them; here there is
    nothing to compile)."""
    return (functools.partial(mpc_init, model, cfg=cfg, dt=dt),
            functools.partial(mpc_step, model, cfg=cfg, dt=dt))


def run_mpc(model: Model, params, cfg: SolverConfig, dt, x0, u0,
            n_steps: int, device=None) -> tuple:
    """``n_steps`` replanning cycles from a cold plan, a host loop. Returns
    (the final MPCState, (x (n_steps, n), cost (n_steps,)) per step)."""
    state = mpc_init(model, params, cfg, dt, x0, u0, device=device)
    xs, costs = [], []
    for _ in range(n_steps):
        state = mpc_step(model, params, cfg, dt, state)
        xs.append(state.x)
        costs.append(state.plan.cost)
    return state, (torch.stack(xs), torch.stack(costs))
