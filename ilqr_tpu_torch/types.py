"""Result types (counterpart of ``ilqr_tpu/types.py``)."""

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
