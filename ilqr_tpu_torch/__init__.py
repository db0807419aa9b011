"""PyTorch/CUDA port of ilqr_tpu: batched iLQR/DDP on an NVIDIA H100.

It carries the fused batch solver (``solve_batch_fused``, fused.py, with
shared or per-problem params, and its warm start
``solve_batch_fused_warm``) and the composable solver (``solve``,
``solve_verbose``, ``solve_warm``, solver.py; ``solve_batch``, batch.py,
with shared or per-problem params) for the package's 14 models and for
custom models registered with ``models.register`` (their kernels built
from their torch SoA functions, ops/codegen.py), the box QPs of the
composable backward pass (ops/boxqp.py), the MPC on both (mpc.py: one
controller on the composable solver, fleets on the fused one), and the six
CUDA kernels they run (ops/, csrc/; ``rollout_packed`` with the JAX
kernel's candidate-sweep modes too). Around them: the CLI
(``python -m ilqr_tpu_torch``, __main__.py), the reference-format I/O,
checkpoints, phase timing, plots and math helpers (utils/), the native
trajectory writer (runtime/) and the examples (examples/). It imports
neither JAX nor ilqr_tpu.
"""

from ilqr_tpu_torch.config import (
    DEFAULT_ALPHAS,
    PARITY_CONFIG,
    BoxQPConfig,
    SolverConfig,
)
from ilqr_tpu_torch.batch import convergence_stats, solve_batch
from ilqr_tpu_torch.fused import solve_batch_fused, solve_batch_fused_warm
from ilqr_tpu_torch.models import get_model, list_models
from ilqr_tpu_torch.models.base import Model
from ilqr_tpu_torch.ops.boxqp import boxqp, boxqp_pn
from ilqr_tpu_torch.solver import init_state, solve, solve_verbose, solve_warm
from ilqr_tpu_torch.types import Solution, SolverState, TerminationReason

__all__ = [
    "BoxQPConfig",
    "DEFAULT_ALPHAS",
    "Model",
    "PARITY_CONFIG",
    "Solution",
    "SolverConfig",
    "SolverState",
    "TerminationReason",
    "boxqp",
    "boxqp_pn",
    "convergence_stats",
    "get_model",
    "init_state",
    "list_models",
    "solve",
    "solve_batch",
    "solve_batch_fused",
    "solve_batch_fused_warm",
    "solve_verbose",
    "solve_warm",
]
