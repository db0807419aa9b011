"""Fleet-scale receding-horizon MPC on the fused solver (counterpart of the
fleet half of ``ilqr_tpu/mpc.py``: ``MPCState``, ``fleet_init``,
``fleet_step``).

One replanning cycle of a whole fleet:

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
fused solver's kernels on the card. The single-controller half of the JAX
module (``mpc_init``, ``mpc_step``, ``make_mpc_controller``, ``run_mpc``)
runs on the composable solver's warm ``init_state`` and is not ported.
"""

from __future__ import annotations

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
from ilqr_tpu_torch.solver import as_f32
from ilqr_tpu_torch.types import Solution


class MPCState(NamedTuple):
    """A fleet's controller state between replanning steps, with a leading
    fleet axis B: the observed states x (B, n), the last plan (a Solution
    of B problems; plan.us[:, 0] is each controller's next control) and
    the step counters t (B,) int32."""

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
