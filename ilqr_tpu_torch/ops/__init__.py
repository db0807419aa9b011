"""The kernel ops: each a plain PyTorch version beside a CUDA kernel
(csrc/). ``launch_counts()`` reads, and ``reset_launch_counts()``
zeroes, every op's count of kernel launches. ``rollout_packed``'s second
kernel (its costs-only, candidate and per-lane α modes) counts apart, by
mode, in ``rollout_packed.mode_launches``, which ``reset_launch_counts()``
zeroes too."""

from ilqr_tpu_torch.ops.kernel_backward import backward_sweep_packed
from ilqr_tpu_torch.ops.kernel_derivs import derivs_packed
from ilqr_tpu_torch.ops.kernel_iter import iteration_packed
from ilqr_tpu_torch.ops.kernel_rollout import linesearch_packed, rollout_packed
from ilqr_tpu_torch.ops.kernel_sweep import sweep_packed

KERNEL_OPS = (rollout_packed, linesearch_packed, sweep_packed,
              iteration_packed, derivs_packed, backward_sweep_packed)


def launch_counts() -> dict:
    return {op.__name__: op.launches for op in KERNEL_OPS}


def reset_launch_counts() -> None:
    for op in KERNEL_OPS:
        op.launches = 0
    for mode in rollout_packed.mode_launches:
        rollout_packed.mode_launches[mode] = 0
