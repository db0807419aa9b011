"""Model registry (counterpart of ``ilqr_tpu/models/__init__.py``).

Every model of the JAX package is ported. :func:`register` adds a user's
model (the extension point, ref include/model.h:8-10): with SoA functions
its kernels are generated from them and built into a library of its own at
first use on the card (ops/codegen.py, ``ops._build.build_model``); without
them it runs the "xla" routes. An unknown name raises
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

# The package's own models, whose kernels are the hand-written ones of
# csrc/ in the main library.
_BUILTIN = dict(_REGISTRY)

# Models of the JAX package that this package does not carry yet.
_NOT_YET_PORTED = ()


def register(model: Model) -> Model:
    """Adds ``model`` under its name (``get_model`` then finds it). Its
    kernels' launchers are named ``ilqr_<name>_<kernel>``, so the name must
    be a C identifier; a duplicate or another name raises ValueError."""
    name = model.name
    if not (isinstance(name, str) and name.isidentifier()
            and name.isascii()):
        raise ValueError(f"model name {name!r} is not a C identifier (the "
                         "kernels' launchers are named ilqr_<name>_<kernel>)")
    if name in _REGISTRY:
        raise ValueError(f"model {name!r} already registered")
    _REGISTRY[name] = model
    return model


def is_builtin(model: Model) -> bool:
    """Whether ``model`` is one of the package's own 14 models."""
    return _BUILTIN.get(model.name) is model


def custom_model(model: Model):
    """``model`` if it is a registered custom model (its kernels come from
    its own library), else None."""
    if is_builtin(model) or _REGISTRY.get(model.name) is not model:
        return None
    return model


def custom_models():
    """The registered custom models, in registration order."""
    return [m for m in _REGISTRY.values() if not is_builtin(m)]


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
    "custom_model",
    "custom_models",
    "get_model",
    "is_builtin",
    "list_models",
    "register",
]
