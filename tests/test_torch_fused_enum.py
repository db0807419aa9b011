"""Whole fused solves at m = 2, 3 and 4 on the CPU (the port's plain
versions) against the JAX package.

- double_integrator (m = 2) and point_mass_3d (m = 3), with control limits
  (the enumeration box QP) and without (the Newton step), against
  ilqr_tpu.fused.solve_batch_fused in Pallas interpret mode (time blocks of
  one step, which keep its compile short): costs to rtol 1e-4, controls to
  5e-3, the same iteration counts and reasons (tests/test_fused_solver.py
  :160-208). The unconstrained cases run the port's split iteration, so
  the sweep and line-search ops are held too.
- the quadrotor (m = 4, n = 12), and a 4-thruster point mass whose mixing
  couples Quu (tests/test_fused_solver.py's ``_overactuated_model``, n = 6,
  with the asymmetric [0, u_max] box binding), against the JAX package's
  XLA path ilqr_tpu.batch.solve_batch: costs to rtol 1e-3, controls to 2e-2
  (tests/test_fused_solver.py:350-391). The XLA path's own QP is the
  projected Newton of the reference, which converges to the enumeration's
  optimum; with ``boxqp_mode="enum"`` its compile takes ~45 s on the CPU,
  so that case is marked slow. Interpret mode at n = 12, m = 4 is
  pathologically slow on XLA:CPU and is not run.
"""

import dataclasses
import os
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu import get_model as jax_get_model
from ilqr_tpu.batch import solve_batch as jax_solve_batch
from ilqr_tpu.fused import solve_batch_fused as jax_solve_fused
from ilqr_tpu.models import double_integrator as jdi
from ilqr_tpu.models import point_mass_3d as jpm
from ilqr_tpu.models import quadrotor as jqd
from ilqr_tpu_torch import SolverConfig, get_model, solve_batch_fused
from ilqr_tpu_torch.models import double_integrator as tdi
from ilqr_tpu_torch.models import point_mass_3d as tpm
from ilqr_tpu_torch.models import quadrotor as tqd
from ilqr_tpu_torch.models.base import Model

sys.path.insert(0, os.path.dirname(__file__))
from test_fused_solver import _overactuated_model  # noqa: E402

FAST_ALPHAS = (1.0, 0.3, 0.03)
MODS = {"double_integrator": (jdi, tdi), "point_mass_3d": (jpm, tpm),
        "quadrotor": (jqd, tqd)}


def _params(name):
    jmod, tmod = MODS[name]
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                jmod.default_params())
    return jax.tree_util.tree_map(jnp.asarray, jp), tmod.params_from_numpy(jp)


@pytest.mark.parametrize("name,use_limits", [
    ("double_integrator", True), ("double_integrator", False),
    ("point_mass_3d", True), ("point_mass_3d", False)])
def test_m2_m3_match_jax_fused(name, use_limits):
    jp, tp = _params(name)
    m = get_model(name)
    rng = np.random.default_rng(0)
    x0 = (0.3 * rng.normal(size=(2, m.n))).astype(np.float32)
    u0 = np.zeros((8, m.m), np.float32)
    kw = dict(deriv_mode="analytic", clamp_forward=use_limits,
              use_control_limits=use_limits, max_iter=4, alphas=FAST_ALPHAS,
              iter_kernel="auto" if use_limits else "split")
    ref = jax_solve_fused(
        jax_get_model(name), jp,
        JaxConfig(iter_time_block=1, sweep_time_block=1, ls_time_block=1,
                  **kw), 0.02, jnp.asarray(x0), jnp.asarray(u0))
    got = solve_batch_fused(m, tp, SolverConfig(**kw), 0.02, x0, u0,
                            device="cpu")
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-4)
    assert np.abs(got.us.numpy() - np.asarray(ref.us)).max() < 5e-3
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.reason.numpy(), np.asarray(ref.reason))
    assert got.us.shape == (2, 8, m.m) and got.K.shape == (2, 8, m.m, m.n)
    if use_limits:
        assert got.us.abs().max() <= 0.5 + 1e-6


def _check_m4(got, ref, us_max):
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-3)
    assert np.abs(got.us.numpy() - np.asarray(ref.us)).max() < 2e-2
    us = got.us.numpy()
    assert us.min() >= -1e-6 and us.max() <= us_max + 1e-6


@pytest.mark.parametrize("boxqp_mode", [
    "auto", pytest.param("enum", marks=pytest.mark.slow)])
def test_quadrotor_matches_jax_xla(boxqp_mode):
    jp, tp = _params("quadrotor")
    rng = np.random.default_rng(0)
    x0 = (0.05 * rng.normal(size=(2, 12))).astype(np.float32)
    u0 = np.tile(np.asarray(jqd.hover_control(jp), np.float32)[None], (8, 1))
    kw = dict(deriv_mode="analytic", clamp_forward=True, max_iter=4,
              alphas=FAST_ALPHAS)
    ref = jax_solve_batch(
        jax_get_model("quadrotor"), jp,
        JaxConfig(boxqp_mode=boxqp_mode, backward_kernel="xla",
                  rollout_kernel="xla", deriv_kernel="xla", **kw),
        0.02, jnp.asarray(x0), jnp.asarray(u0))
    got = solve_batch_fused(get_model("quadrotor"), tp, SolverConfig(**kw),
                            0.02, x0, u0, device="cpu")
    _check_m4(got, ref, 3.0)
    assert got.K.shape == (2, 8, 4, 12)


# The 4-thruster point mass of tests/test_fused_solver.py, ported: its
# Jacobians and cost Hessians are Python constants (the mixing matrix), so
# the plain sweep folds them as the JAX kernel does.
_MIX = ((1.0, 0.3, -0.2, 0.1), (0.2, 1.0, 0.3, -0.1), (-0.1, 0.2, 1.0, 0.4))


class _OverParams(NamedTuple):
    goal: torch.Tensor
    u_min: torch.Tensor
    u_max: torch.Tensor


def _over_dyn(p, x, u):
    f = [sum(_MIX[i][j] * u[j] for j in range(4)) - 0.970 - 0.1 * x[3 + i]
         for i in range(3)]
    return torch.stack([x[3], x[4], x[5], f[0], f[1], f[2]])


def _over_cost(p, x, u):
    acc = None
    for i in range(6):
        e = p.goal[i] - x[i]
        acc = e * e if acc is None else acc + e * e
    for j in range(4):
        acc = acc + 0.1 * u[j] * u[j]
    return acc


def _over_final(p, x):
    acc = None
    for i in range(6):
        e = p.goal[i] - x[i]
        acc = e * e if acc is None else acc + e * e
    return 20.0 * acc


def _over_jac(p, x, u):
    A = [[0.0] * 6 for _ in range(6)]
    for i in range(3):
        A[i][i + 3] = 1.0
        A[i + 3][i + 3] = -0.1
    B = [[0.0] * 4 for _ in range(6)]
    for i in range(3):
        for j in range(4):
            B[i + 3][j] = _MIX[i][j]
    return A, B


def _over_cost_derivs(p, x, u):
    cx = [-2.0 * (p.goal[i] - x[i]) for i in range(6)]
    cu = [0.2 * u[j] for j in range(4)]
    cxx = [[2.0 if i == j else 0.0 for j in range(6)] for i in range(6)]
    cxu = [[0.0] * 4 for _ in range(6)]
    cuu = [[0.2 if i == j else 0.0 for j in range(4)] for i in range(4)]
    return cx, cu, cxx, cxu, cuu


def _over_final_derivs(p, x):
    cx = [-40.0 * (p.goal[i] - x[i]) for i in range(6)]
    cxx = [[40.0 if i == j else 0.0 for j in range(6)] for i in range(6)]
    return cx, cxx


def _unused(*a):
    raise AssertionError("the fused solver uses the SoA functions only")


OVERACTUATED = Model(
    name="_overactuated_pm", n=6, m=4, dynamics=_unused, cost=_unused,
    final_cost=_unused, default_params=_unused, dynamics_soa=_over_dyn,
    cost_soa=_over_cost, final_cost_soa=_over_final, jac_soa=_over_jac,
    cost_derivs_soa=_over_cost_derivs,
    final_cost_derivs_soa=_over_final_derivs)


def test_overactuated_m4_matches_jax_xla():
    jm, jp = _overactuated_model()
    tp = _OverParams(*(torch.from_numpy(np.array(a, np.float32))
                       for a in jp))
    rng = np.random.default_rng(3)
    x0 = (rng.normal(size=(2, 6)) * 0.1).astype(np.float32)
    u0 = np.full((8, 4), 0.3, np.float32)
    kw = dict(deriv_mode="analytic", clamp_forward=True, max_iter=4,
              alphas=FAST_ALPHAS)
    ref = jax_solve_batch(
        jm, jp, JaxConfig(backward_kernel="xla", rollout_kernel="xla",
                          deriv_kernel="xla", **kw),
        0.02, jnp.asarray(x0), jnp.asarray(u0))
    for ik in ("merged", "split"):
        got = solve_batch_fused(OVERACTUATED, tp,
                                SolverConfig(iter_kernel=ik, **kw), 0.02, x0,
                                u0, device="cpu")
        _check_m4(got, ref, 0.6)
        assert got.us.numpy().max() > 0.6 - 1e-4   # the upper box binds
        assert got.K.shape == (2, 8, 4, 6)


def test_unregistered_model_has_no_kernels():
    """On the card the kernels exist only for the compiled models; checked
    here without a card through the guard every wrapper calls first."""
    from ilqr_tpu_torch.ops import kernel_rollout

    pp = kernel_rollout.pack_params(
        _OverParams(torch.zeros(6), torch.zeros(4), torch.ones(4)), 0.02)
    with pytest.raises(NotImplementedError, match="quadrotor"):
        kernel_rollout.require_kernel_model(OVERACTUATED, "euler", pp,
                                            pp.vec.device)
    # a compiled model's name with another params type is refused too
    fake = dataclasses.replace(OVERACTUATED, name="quadrotor")
    with pytest.raises(NotImplementedError):
        kernel_rollout.require_kernel_model(fake, "euler", pp, pp.vec.device)
    qp_ = kernel_rollout.pack_params(tqd.default_params(), 0.02)
    assert kernel_rollout.require_kernel_model(
        get_model("quadrotor"), "euler", qp_,
        qp_.vec.device) == "ilqr_quadrotor"
