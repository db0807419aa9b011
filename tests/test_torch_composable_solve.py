"""Whole composable solves (``ilqr_tpu_torch.solve_batch`` on the CPU: the
plain derivative, backward and rollout stages, the QPs of ops/boxqp.py) of
the m ≥ 2 models against the JAX package's ``ilqr_tpu.batch.solve_batch``
(its XLA routes on the CPU) on the same inputs.

Every problem: the model's default params (or one row per problem with
``params_batched=True``), x0 = 0.3·normal from ``default_rng`` (B = 2),
u0 = 0, T = 12, dt = 0.05, analytic derivatives unless stated, clamped
rollouts, max_iter 4. Between them the cases run every QP mode of the
backward scan (the iterative box QP under "auto" at m ≥ 2 and
"iterative", "enum", "pn_fixed", the unconstrained Cholesky step), RK4,
the reference's stencils and per-problem params.

Bounds (tests/test_fused_solver.py:31-47): costs to rtol 1e-4, or 1e-3
where the model's dynamics take sin/cos/tan (their library ulps);
iteration counts and termination reasons equal; controls within 5e-3.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu import get_model as jax_get_model
from ilqr_tpu.batch import solve_batch as jax_solve_batch
from ilqr_tpu_torch import SolverConfig, get_model, solve_batch

B, T, DT = 2, 12, 0.05
TRIG = ("pendulum", "cartpole", "quadrotor", "omni_thruster", "free_flyer",
        "bicycle",
        "thruster_ring", "thruster_ring16", "thruster_ring20",
        "thruster_ring24")
US_TOL = 5e-3


def port_params(name, jp):
    module = "thruster_ring" if name.startswith("thruster_ring") else name
    return importlib.import_module(
        f"ilqr_tpu_torch.models.{module}").params_from_numpy(jp)


def jax_params(name):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jax_get_model(name).default_params())


def per_problem(name, seed):
    """Every leaf of the defaults × U(0.8, 1.2), one row per problem."""
    base = jax_params(name)
    rng = np.random.default_rng(seed)
    return type(base)(**{
        f: (np.asarray(getattr(base, f))[None] * rng.uniform(
            0.8, 1.2, size=(B,) + np.shape(getattr(base, f)))
            ).astype(np.float32) for f in base._fields})


def compare(name, seed=1, params_batched=False, **kw):
    """Solves the problem of ``name`` on both sides and checks the
    bounds; returns the port's Solution."""
    jm = jax_get_model(name)
    rng = np.random.default_rng(seed)
    x0 = (0.3 * rng.normal(size=(B, jm.n))).astype(np.float32)
    u0 = np.zeros((T, jm.m), np.float32)
    kw = dict(dict(deriv_mode="analytic", clamp_forward=True, max_iter=4),
              **kw)
    jp = per_problem(name, seed) if params_batched else jax_params(name)
    ref = jax_solve_batch(jm, jax.tree_util.tree_map(jnp.asarray, jp),
                          JaxConfig(**kw), DT, jnp.asarray(x0),
                          jnp.asarray(u0), params_batched=params_batched)
    got = solve_batch(get_model(name), port_params(name, jp),
                      SolverConfig(**kw), DT, x0, u0, device="cpu",
                      params_batched=params_batched)
    rtol = 1e-3 if name in TRIG else 1e-4
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=rtol)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.reason.numpy(), np.asarray(ref.reason))
    assert np.abs(got.us.numpy() - np.asarray(ref.us)).max() < US_TOL
    assert np.isfinite(got.cost.numpy()).all()
    return got


@pytest.mark.parametrize("name,extra", [
    ("double_integrator", {}),
    ("point_mass_3d", dict(integrator="rk4")),
    ("quadrotor", {}),
    ("bicycle", dict(integrator="rk4")),
    ("omni_thruster", dict(boxqp_mode="pn_fixed")),
    ("free_flyer", dict(use_control_limits=False, clamp_forward=False)),
])
def test_solve_batch_matches_jax(name, extra):
    compare(name, **extra)


def test_per_problem_params_match_jax():
    """power_mass (the live cxu) with one row of params per problem: goals,
    weights, physics and boxes of its own in every lane."""
    got = compare("power_mass", params_batched=True)
    assert got.cost.shape == (B,)
