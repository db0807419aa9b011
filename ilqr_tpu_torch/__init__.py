"""PyTorch/CUDA port of ilqr_tpu: batched iLQR/DDP on an NVIDIA H100.

This slice carries the fused batch solver for acrobot (n = 4, m = 1) and its
four CUDA kernels (ops/, csrc/). It imports neither JAX nor ilqr_tpu.
"""

from ilqr_tpu_torch.config import (
    DEFAULT_ALPHAS,
    PARITY_CONFIG,
    BoxQPConfig,
    SolverConfig,
)
from ilqr_tpu_torch.fused import solve_batch_fused
from ilqr_tpu_torch.models import get_model
from ilqr_tpu_torch.types import Solution, TerminationReason

__all__ = [
    "BoxQPConfig",
    "DEFAULT_ALPHAS",
    "PARITY_CONFIG",
    "Solution",
    "SolverConfig",
    "TerminationReason",
    "get_model",
    "solve_batch_fused",
]
