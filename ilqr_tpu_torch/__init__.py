"""PyTorch/CUDA port of ilqr_tpu: batched iLQR/DDP on an NVIDIA H100.

It carries the fused batch solver (``solve_batch_fused``, fused.py, with
shared or per-problem params, and its warm start
``solve_batch_fused_warm``) for the package's 14 models, the fleet MPC on
it (``mpc.fleet_init``/``fleet_step``), the composable solve for acrobot
(``solve``, solver.py; ``solve_batch``, batch.py), and the six CUDA
kernels they run (ops/, csrc/). It imports neither JAX nor ilqr_tpu.
"""

from ilqr_tpu_torch.config import (
    DEFAULT_ALPHAS,
    PARITY_CONFIG,
    BoxQPConfig,
    SolverConfig,
)
from ilqr_tpu_torch.batch import convergence_stats, solve_batch
from ilqr_tpu_torch.fused import solve_batch_fused, solve_batch_fused_warm
from ilqr_tpu_torch.models import get_model
from ilqr_tpu_torch.solver import solve
from ilqr_tpu_torch.types import Solution, TerminationReason

__all__ = [
    "BoxQPConfig",
    "DEFAULT_ALPHAS",
    "PARITY_CONFIG",
    "Solution",
    "SolverConfig",
    "TerminationReason",
    "convergence_stats",
    "get_model",
    "solve",
    "solve_batch",
    "solve_batch_fused",
    "solve_batch_fused_warm",
]
