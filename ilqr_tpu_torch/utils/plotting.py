"""Trajectory plotting, the counterpart of ``ilqr_tpu/utils/plotting.py``
and of the reference's plot_results.py.

The reference script hardcodes the acrobot dims and the CSV path
(ref: plot_results.py:28-31); here dims come from the data and any Solution
or CSV plots. matplotlib is imported when a plot is made, so the package
never depends on it.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def plot_trajectory(xs, us, dt: float = 1.0, title: str = "iLQR result",
                    save_path=None, show: bool = False):
    """State and control subplots over time (ref: plot_results.py:33-37):
    xs (T+1, n), us (T, m), numpy arrays or tensors on any device. Returns
    the matplotlib Figure."""
    import matplotlib

    if save_path is not None and not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs, us = _np(xs), _np(us)
    tx = np.arange(xs.shape[0]) * dt
    tu = np.arange(us.shape[0]) * dt

    fig, (ax_x, ax_u) = plt.subplots(2, 1, sharex=True, figsize=(8, 6))
    for i in range(xs.shape[1]):
        ax_x.plot(tx, xs[:, i], label=f"x{i + 1}")
    ax_x.set_ylabel("state")
    ax_x.legend(loc="best", fontsize=8)
    ax_x.set_title(title)
    for j in range(us.shape[1]):
        ax_u.plot(tu, us[:, j], label=f"u{j + 1}")
    ax_u.set_ylabel("control")
    ax_u.set_xlabel("time [s]")
    ax_u.legend(loc="best", fontsize=8)
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=120)
    if show:
        plt.show()
    return fig


def plot_csv(path: str, n: int, m: int, dt: float = 1.0, **kw):
    """Plots a reference-format CSV (ref: plot_results.py:5-21 reader)."""
    from ilqr_tpu_torch.utils.io import read_trajectory_csv

    xs, us = read_trajectory_csv(path, n, m)
    return plot_trajectory(xs, us, dt=dt, **kw)
