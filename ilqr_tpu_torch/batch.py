"""Batched solves (counterpart of ``ilqr_tpu/batch.py``).

:func:`solve_batch` solves B independent problems in lock-step through the
composable solver (solver.py) — the JAX package's ``vmap(solve)`` with the
batch written out. On the card each stage of every iteration is one CUDA
kernel launch over the whole batch (the line search over B·A lanes).

The JAX package's containment of an XLA:TPU worker fault
(``solve_batch_wide``, its lane-iteration ledger, ``solve_batch_chunked``)
has no counterpart yet; ROADMAP A5 holds its routing and API.
"""

from __future__ import annotations

import torch

from ilqr_tpu_torch.config import SolverConfig
from ilqr_tpu_torch.models.base import Model
from ilqr_tpu_torch.ops.kernel_rollout import pack_params, pack_params_batched
from ilqr_tpu_torch.solver import (
    as_f32,
    check_supported,
    resolve_device,
    solve_lanes,
)
from ilqr_tpu_torch.types import Solution, TerminationReason


def solve_batch(model: Model, params, cfg: SolverConfig, dt, x0, u0,
                device=None, params_batched: bool = False) -> Solution:
    """Solves a batch of problems: x0 (B, n); u0 (T, m) shared or
    (B, T, m); params shared by every problem, or with
    ``params_batched=True`` one per problem (every leaf with a leading
    batch axis B: per-problem goals, limits, weights). ``device`` defaults
    to the card and raises without one; with ``device="cpu"`` every stage
    runs its plain PyTorch version. Returns a Solution with leading batch
    axis B, on ``device``."""
    check_supported(model, cfg, params_batched)
    dev = resolve_device(device)
    x0 = as_f32(x0, dev)
    u0 = as_f32(u0, dev)
    if u0.ndim == 2:
        u0 = u0.expand((x0.shape[0],) + tuple(u0.shape))
    if x0.shape[-1] != model.n or u0.shape[-1] != model.m:
        raise ValueError(f"x0/u0 dims ({x0.shape[-1]}, {u0.shape[-1]}) do "
                         f"not match model {model.name!r} ({model.n}, "
                         f"{model.m})")
    pack = pack_params_batched if params_batched else pack_params
    pp = pack(params, dt, dev)
    if params_batched and pp.vec.shape[0] != x0.shape[0]:
        raise ValueError(f"params_batched: {pp.vec.shape[0]} params rows "
                         f"for {x0.shape[0]} problems")
    return solve_lanes(model, pp, cfg, x0, u0.contiguous())


def convergence_stats(sol: Solution) -> dict:
    """Batch-level convergence statistics (the reference's per-solve
    SHOWPROGRESS summary, aggregated)."""
    return {
        "mean_cost": sol.cost.mean(),
        "max_cost": sol.cost.max(),
        "mean_iterations": sol.iterations.to(torch.float32).mean(),
        "converged_frac": (sol.reason != int(TerminationReason.MAX_ITER))
        .to(torch.float32).mean(),
        "mean_gnorm": sol.gnorm.mean(),
    }
