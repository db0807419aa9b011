"""Model registry (counterpart of ``ilqr_tpu/models/__init__.py``).

Every model of the JAX package is ported; another name raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict

from ilqr_tpu_torch.models import (
    acrobot,
    bicycle,
    cartpole,
    double_integrator,
    free_flyer,
    omni_thruster,
    pendulum,
    point_mass_3d,
    power_mass,
    quadrotor,
    thruster_ring,
)
from ilqr_tpu_torch.models.base import Model, euler_step, get_integrator, rk4_step

_REGISTRY: Dict[str, Model] = {
    model.name: model
    for model in (acrobot.MODEL, double_integrator.MODEL, point_mass_3d.MODEL,
                  quadrotor.MODEL, omni_thruster.MODEL, free_flyer.MODEL,
                  *thruster_ring.MODELS, pendulum.MODEL, cartpole.MODEL,
                  bicycle.MODEL, power_mass.MODEL)}

# Models of the JAX package that this package does not carry yet.
_NOT_YET_PORTED = ()


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
