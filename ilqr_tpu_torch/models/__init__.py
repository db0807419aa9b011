"""Model registry (counterpart of ``ilqr_tpu/models/__init__.py``).

Ported so far: acrobot, double_integrator, point_mass_3d and quadrotor; the
other registered names of the JAX package raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict

from ilqr_tpu_torch.models import (
    acrobot,
    double_integrator,
    point_mass_3d,
    quadrotor,
)
from ilqr_tpu_torch.models.base import Model, euler_step, get_integrator, rk4_step

_REGISTRY: Dict[str, Model] = {
    mod.MODEL.name: mod.MODEL
    for mod in (acrobot, double_integrator, point_mass_3d, quadrotor)}

# Models of the JAX package that this package does not carry yet.
_NOT_YET_PORTED = (
    "bicycle", "cartpole", "free_flyer", "omni_thruster", "pendulum",
    "power_mass", "thruster_ring", "thruster_ring16", "thruster_ring20",
    "thruster_ring24",
)


def get_model(name: str) -> Model:
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in _NOT_YET_PORTED:
            raise NotImplementedError(
                f"model {name!r} is not yet ported to ilqr_tpu_torch; "
                f"have {sorted(_REGISTRY)}") from None
        raise NotImplementedError(
            f"unknown model {name!r}: ilqr_tpu_torch has "
            f"{sorted(_REGISTRY)}") from None


def list_models():
    return sorted(_REGISTRY)


__all__ = [
    "Model",
    "euler_step",
    "rk4_step",
    "get_integrator",
    "get_model",
    "list_models",
]
