"""Model registry (counterpart of ``ilqr_tpu/models/__init__.py``).

Ported so far: acrobot, double_integrator, point_mass_3d, quadrotor,
omni_thruster, free_flyer and the four thruster rings; the other
registered names of the JAX package raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict

from ilqr_tpu_torch.models import (
    acrobot,
    double_integrator,
    free_flyer,
    omni_thruster,
    point_mass_3d,
    quadrotor,
    thruster_ring,
)
from ilqr_tpu_torch.models.base import Model, euler_step, get_integrator, rk4_step

_REGISTRY: Dict[str, Model] = {
    model.name: model
    for model in (acrobot.MODEL, double_integrator.MODEL, point_mass_3d.MODEL,
                  quadrotor.MODEL, omni_thruster.MODEL, free_flyer.MODEL,
                  *thruster_ring.MODELS)}

# Models of the JAX package that this package does not carry yet.
_NOT_YET_PORTED = ("bicycle", "cartpole", "pendulum", "power_mass")


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
