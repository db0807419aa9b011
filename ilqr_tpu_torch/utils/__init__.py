"""Utilities (counterpart of ``ilqr_tpu/utils``): reference-format
trajectory I/O (io.py), checkpoints of solver and MPC state
(checkpoint.py), the TIMESTUFF phase timer and the profiler trace
(timing.py), plots (plotting.py) and the reference's math helpers
(math.py). The JAX package's ``vma.py`` (shard_map typing) has no
counterpart."""

from ilqr_tpu_torch.utils.io import read_trajectory_csv, write_trajectory_csv
from ilqr_tpu_torch.utils.timing import PhaseTimer

__all__ = ["read_trajectory_csv", "write_trajectory_csv", "PhaseTimer"]
