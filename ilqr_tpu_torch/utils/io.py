"""Trajectory I/O, format-compatible with the reference (counterpart of
``ilqr_tpu/utils/io.py``).

CSV layout of ref iLQR::output_to_csv (src/ilqr_core.cpp:414-431): header
``x1, ..., xn, u1, ..., um``, then T rows of state+control, then one final
state-only row (no trailing controls). The reference's plot_results.py
reads exactly this (plot_results.py:5-21).

The native writer (ilqr_tpu_torch/runtime) is used where it builds;
otherwise a Python writer with the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def write_trajectory_csv(path: str, xs, us) -> str:
    """Writes xs (T+1, n), us (T, m) (numpy arrays or tensors on any
    device). Returns the writer that wrote it: ``"native"`` (the runtime's
    libtrajio) or ``"python"``."""
    xs, us = _np(xs), _np(us)
    T, m = us.shape
    n = xs.shape[1]
    try:
        from ilqr_tpu_torch.runtime import trajio

        trajio.write_csv(path, xs, us)
        return "native"
    except OSError:
        pass
    with open(path, "w") as f:
        # The reference header emits u0..um labels for only m control columns
        # (quirk of :417-419); here n state + m control labels u1..um.
        f.write(", ".join(
            [f"x{i}" for i in range(1, n + 1)] + [f"u{j + 1}" for j in range(m)]
        ) + "\n")
        for t in range(T):
            row = [f"{v:f}" for v in xs[t]] + [f"{v:f}" for v in us[t]]
            f.write(", ".join(row) + "\n")
        f.write(", ".join(f"{v:f}" for v in xs[T]) + "\n")
    return "python"


def read_trajectory_csv(path: str, n: int, m: int):
    """Reads the reference CSV format (ref plot_results.py:5-21): returns
    (xs (T+1, n), us (T, m)) as f64 numpy arrays; the final row has states
    only."""
    rows = []
    with open(path) as f:
        next(f)  # header
        for line in f:
            rows.append([float(v) for v in line.replace(",", " ").split()])
    xs = np.array([r[:n] for r in rows])
    us = np.array([r[n:n + m] for r in rows[:-1] if len(r) >= n + m])
    return xs, us
