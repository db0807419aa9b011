"""Checkpoint and resume of solver and MPC state (counterpart of
``ilqr_tpu/utils/checkpoint.py``).

Any tree of tensors — a :class:`~ilqr_tpu_torch.types.Solution`, a batch
of them, a fleet's :class:`~ilqr_tpu_torch.mpc.MPCState`; NamedTuples,
dataclasses, tuples and lists of tensors or numpy arrays — snapshots to one ``.npz`` (one
array per leaf, ``leaf_<i>`` in flattening order, the layout of the JAX
package's files) and restores bit for bit onto the device and dtype of a
template. The JAX package's ``save_orbax`` has no counterpart: orbax
checkpoints JAX arrays.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any, out: list) -> None:
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        out.append(tree)
    elif tree is None:
        pass
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _flatten(getattr(tree, f.name), out)
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            _flatten(item, out)
    else:
        raise TypeError(f"checkpoint: unsupported leaf {type(tree).__name__}")


def _unflatten(like: Any, leaves) -> Any:
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(next(leaves)).to(device=like.device,
                                                 dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return next(leaves).astype(like.dtype, copy=False)
    if like is None:
        return None
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _unflatten(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like)})
    items = [_unflatten(item, leaves) for item in like]
    if hasattr(like, "_fields"):          # a NamedTuple
        return type(like)(*items)
    return type(like)(items)


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any) -> None:
    """Saves a tree of tensors (or arrays) to ``path`` (.npz, written to a
    temporary file and renamed into place)."""
    flat = []
    _flatten(tree, flat)
    arrays = {f"leaf_{i}": _as_numpy(x) for i, x in enumerate(flat)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def restore(path: str, like: Any) -> Any:
    """Restores a tree saved by :func:`save`. ``like`` gives the structure
    and, for each tensor leaf, the device and dtype it is restored to."""
    n = []
    _flatten(like, n)
    with np.load(path) as data:
        if len(data.files) != len(n):
            raise ValueError(f"{path}: {len(data.files)} leaves, the "
                             f"template has {len(n)}")
        leaves = [data[f"leaf_{i}"] for i in range(len(n))]
    return _unflatten(like, iter(leaves))
