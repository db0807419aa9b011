"""Solver and result types (counterpart of ``ilqr_tpu/types.py`` and of
``LineSearchResult`` in ``ilqr_tpu/ops/rollout.py``).

The composable path writes the JAX package's ``vmap`` out as a leading batch
axis B, so every field below carries it."""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch


class TerminationReason(enum.IntEnum):
    """Why the outer loop stopped (ref termination sites in ilqr_core.cpp)."""

    RUNNING = 0
    GRAD_TOL = 1      # gradient norm < tolGrad with small λ (ref :153-159)
    FUN_TOL = 2       # cost improvement < tolFun (ref :257-262)
    LAMBDA_MAX = 3    # λ exceeded λmax (ref :276-281 and backward :146)
    MAX_ITER = 4      # iteration cap (ref :285)


class Derivs(NamedTuple):
    """Linearization along (xs, us), batch-major: fx (B, T, n, n) and
    fu (B, T, n, m) of the DISCRETE step, cx (B, T+1, n) and cxx
    (B, T+1, n, n) with row T from the final cost, cu (B, T, m),
    cxu (B, T, n, m), cuu (B, T, m, m)."""

    fx: torch.Tensor
    fu: torch.Tensor
    cx: torch.Tensor
    cu: torch.Tensor
    cxx: torch.Tensor
    cxu: torch.Tensor
    cuu: torch.Tensor


class BackwardResult(NamedTuple):
    """One backward sweep (ref src/ilqr_core.cpp:350-401): k (B, T, m),
    K (B, T, m, n), dV (B, 2) expected-reduction coefficients, diverged
    (B,) bool — some step had a non-positive QuuF."""

    k: torch.Tensor
    K: torch.Tensor
    dV: torch.Tensor
    diverged: torch.Tensor


class BoxQPResult(NamedTuple):
    """The box QP's result per lane (ref: include/boxqp.h:35-43): x (B, m),
    status (B,) int32 (< 1 failure, which the backward pass treats as
    divergence; 2 line search failed, 4 small relative improvement, 5
    small free gradient, 6 all clamped), free (B, m) bool, chol_free
    (B, m, m) the lower Cholesky factor of Q on the free subspace padded
    with identity on the clamped dims, n_iters (B,) int32."""

    x: torch.Tensor
    status: torch.Tensor
    free: torch.Tensor
    chol_free: torch.Tensor
    n_iters: torch.Tensor


class LineSearchResult(NamedTuple):
    """The chosen line-search candidate per problem: xs (B, T+1, n),
    us (B, T, m), cost, dcost, expected (−α(dV₀+α·dV₁)), z (dcost/expected),
    alpha (0 when every α was rejected) and accepted (bool), each (B,)."""

    xs: torch.Tensor
    us: torch.Tensor
    cost: torch.Tensor
    dcost: torch.Tensor
    expected: torch.Tensor
    z: torch.Tensor
    alpha: torch.Tensor
    accepted: torch.Tensor


class SolverState(NamedTuple):
    """Batch-major solver state. The JAX state also carries the last
    linearization and a flag to reuse it when no step was taken; a vmapped
    ``lax.cond`` computes both branches, and the linearization of an
    unchanged trajectory is the same, so the port recomputes it every
    iteration and carries neither."""

    xs: torch.Tensor             # (B, T+1, n)
    us: torch.Tensor             # (B, T, m)
    cost: torch.Tensor           # (B,)
    lam: torch.Tensor            # (B,)
    dlam: torch.Tensor           # (B,)
    k: torch.Tensor              # (B, T, m)
    K: torch.Tensor              # (B, T, m, n)
    iteration: torch.Tensor      # (B,) int32
    done: torch.Tensor           # (B,) bool
    reason: torch.Tensor         # (B,) int32
    gnorm: torch.Tensor          # (B,)
    dcost: torch.Tensor          # (B,)
    expected: torch.Tensor       # (B,)
    step_accepted: torch.Tensor  # (B,) bool


class Solution(NamedTuple):
    """What a batched solve returns, with a leading batch axis B:
    xs (B, T+1, n), us (B, T, m), k (B, T, m), K (B, T, m, n) and the
    per-problem cost, lam, dlam, iterations (int32), reason (int32,
    :class:`TerminationReason`) and gnorm, each (B,)."""

    xs: torch.Tensor
    us: torch.Tensor
    k: torch.Tensor
    K: torch.Tensor
    cost: torch.Tensor
    lam: torch.Tensor
    dlam: torch.Tensor
    iterations: torch.Tensor
    reason: torch.Tensor
    gnorm: torch.Tensor
