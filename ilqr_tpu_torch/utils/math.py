"""Math helpers with reference parity (counterpart of
``ilqr_tpu/utils/math.py``; ref include/common.h:37-92,
include/eigen_helpers.h:86-89), on tensors.

The reference's masked-indexing helpers (eigen_helpers.h:15-61) have no
counterpart here: their purpose was the dynamic-size active-set extraction
of the box QP, which ops/boxqp.py replaces with fixed-shape masking.
"""

from __future__ import annotations

import math

import torch


def sqr(x):
    """x² (ref: common.h:37-40)."""
    return x * x


def cube(x):
    """x³ (ref: common.h:42-45)."""
    return x * x * x


def sgn(x):
    """Sign with sgn(0) = 0 (ref: common.h:47-49), as ``jnp.sign``: ±0
    and NaN are kept (``torch.sign`` maps both to +0)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def _sqrt(v):
    """The correctly rounded square root. PyTorch's vectorized f32 sqrt on
    the CPU is not (an ulp off at some inputs); the f64 root of an f32
    value rounded back to f32 is, on either device."""
    if v.dtype == torch.float32:
        return torch.sqrt(v.double()).float()
    return torch.sqrt(v)


def smooth_abs(x, alpha=1.0):
    """Pseudo-Huber smooth |x|: sqrt(x² + α²) − α (ref: common.h:51-54 and
    the vector version eigen_helpers.h:86-89), differentiable everywhere."""
    return _sqrt(x * x + alpha * alpha) - alpha


def wrap_to_pi(angle):
    """Wraps angles to [−π, π) (ref: common.h:56-71, via the float Mod
    helper :73-92), elementwise. ``torch.remainder`` is non-negative for a
    positive modulus, as ``jnp.mod`` is (``torch.fmod`` is not)."""
    return torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi


def angle_diff(a, b):
    """Shortest signed angular difference a − b, in [−π, π)."""
    return wrap_to_pi(a - b)
