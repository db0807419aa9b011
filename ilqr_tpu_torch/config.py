"""Solver configuration (counterpart of ``ilqr_tpu/config.py``).

The reference keeps every hyperparameter as a compile-time file-scope constant
(ref: include/ilqr.h:14-25, include/boxqp.h:19-24, include/finite_diff.h:9).
Here they live in frozen dataclasses with the same field names and defaults
as the JAX package, so a config can be carried across field by field.

Fields of the JAX config that only tile or type-check the TPU program have no
counterpart here and are left out:

- ``vma_axes`` and ``with_vma_axes`` (shard_map variance typing),
- ``sweep_time_block``, ``ls_time_block`` and ``iter_time_block`` (time
  blocking of the Pallas grid; the CUDA kernels loop over exactly T steps).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


# The reference's hard-coded line-search schedule (ref: include/ilqr.h:24).
# These are the literal values, NOT an exact log-space — parity requires them.
DEFAULT_ALPHAS: Tuple[float, ...] = (
    1.0000, 0.5012, 0.2512, 0.1259, 0.0631,
    0.0316, 0.0158, 0.0079, 0.0040, 0.0020, 0.0010,
)


@dataclasses.dataclass(frozen=True)
class BoxQPConfig:
    """Projected-Newton boxQP hyperparameters (ref: include/boxqp.h:19-24)."""

    max_iter: int = 100           # qp_maxIter
    min_grad: float = 1e-8        # minGrad: free-subspace gradient-norm tol
    min_rel_improve: float = 1e-8  # minRelImprove
    step_dec: float = 0.6         # stepDec: Armijo backtracking factor
    min_step: float = 1e-22       # minStep
    armijo: float = 0.1           # Armijo sufficient-decrease fraction
    clamp_tol: float = 1e-4       # approx_eq tolerance (ref: boxqp.h:61-64)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Outer iLQR loop hyperparameters (ref: include/ilqr.h:14-25).

    Same fields and defaults as ``ilqr_tpu.config.SolverConfig`` minus the
    TPU-only ones listed in the module docstring. See that class for the
    meaning of each field; the fused solver of this package runs the
    subset that ``fused.fused_applicable`` accepts and raises on the rest.
    """

    max_iter: int = 100
    tol_fun: float = 1e-6
    tol_grad: float = 1e-6
    full_ddp: bool = False
    lambda_init: float = 1.0
    dlambda_init: float = 1.0
    lambda_factor: float = 1.6
    lambda_max: float = 1e11
    lambda_min: float = 1e-8
    lambda_grad_term: float = 1e-5  # λ must be below this for grad termination
    z_min: float = 0.0
    alphas: Tuple[float, ...] = DEFAULT_ALPHAS
    deriv_mode: str = "analytic"
    fd_eps: float = 1e-3
    integrator: str = "euler"
    clamp_forward: bool = False
    use_control_limits: bool = True
    boxqp_mode: str = "auto"
    backward_kernel: str = "auto"
    rollout_kernel: str = "auto"
    deriv_kernel: str = "auto"
    backward_mode: str = "scan"
    assoc_refine_sweeps: int = 2
    sweep_kernel: str = "merged"
    iter_kernel: str = "auto"  # "merged": one whole-iteration kernel per
    # attempt (ops/kernel_iter.py); "split": sweep + line-search kernels.
    fused_unroll: int = 4  # iterations between the host's checks of the
    # outer loop condition; lanes are frozen past max_iter, so any U ≥ 1
    # gives identical results.
    boxqp: BoxQPConfig = dataclasses.field(default_factory=BoxQPConfig)

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


# Configuration that reproduces the reference binary bit-for-bit semantics.
PARITY_CONFIG = SolverConfig(
    deriv_mode="fd", clamp_forward=False, boxqp_mode="iterative"
)
