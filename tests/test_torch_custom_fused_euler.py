"""The unicycle (a custom model, examples/custom_model.py) through
ilqr_tpu_torch.solve_batch_fused on the CPU (the plain versions) against
ilqr_tpu.fused.solve_batch_fused (Pallas interpret mode), with analytic
derivatives and the Euler step: a model without ``jac_soa``, so both
sweeps take the dual numbers (the JAX kernels' in-kernel JVP route with
Euler, which the port's merged sweep had run with RK4 only).

B = 3 lanes at x0 = 0.2·normal(3, 3) from ``default_rng(0)``, T = 8, 3
iterations, the 3-α schedule and time blocks of 3 of
tests/test_torch_fused.py. Tolerances as there: per-lane costs to rtol
1e-4, iterations and reasons equal, controls and gains to 1e-4 absolute
(the two sides differ by the trig's ulps only). The split-iteration route
is marked slow (one JAX interpret solve of ~50 s); tier-1 holds the split
route by tests/test_torch_custom_model.py's bitwise plain split-against-
merged iteration. Each JAX reference is solved once per module.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu.fused import solve_batch_fused as jax_solve
from ilqr_tpu_torch import SolverConfig, solve_batch_fused
from ilqr_tpu_torch.examples import custom_model as tcm

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import custom_model as jcm  # noqa: E402

FAST_ALPHAS = (1.0, 0.3, 0.03)
COST_RTOL = 1e-4
US_ATOL = 1e-4
B, T, MAX_ITER, DT = 3, 8, 3, 0.05
ROUTES = ["merged", pytest.param("split", marks=pytest.mark.slow)]
CASE = (("deriv_mode", "analytic"), ("integrator", "euler"))


@functools.lru_cache(maxsize=None)
def solve_both(route, case):
    """(JAX Solution, port Solution) of the unicycle batch with the
    config items ``case`` on iteration route ``route``."""
    rng = np.random.default_rng(0)
    x0 = (0.2 * rng.normal(size=(B, 3))).astype(np.float32)
    u0 = np.zeros((T, 2), np.float32)
    kw = dict(case, clamp_forward=True, max_iter=MAX_ITER,
              alphas=FAST_ALPHAS, iter_kernel=route)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                jcm.default_params())
    ref = jax_solve(jcm.UNICYCLE, jp,
                    JaxConfig(iter_time_block=3, sweep_time_block=3,
                              ls_time_block=3, **kw), DT,
                    jnp.asarray(x0), jnp.asarray(u0))
    tp = tcm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    got = solve_batch_fused(tcm.UNICYCLE, tp, SolverConfig(**kw), DT, x0,
                            u0, device="cpu")
    return ref, got


def check_costs(ref, got):
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=COST_RTOL)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.reason.numpy(), np.asarray(ref.reason))
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(ref.lam),
                               rtol=1e-6)


def check_trajectories(ref, got, atol=US_ATOL):
    for name in ("xs", "us", "k", "K"):
        assert getattr(got, name).shape == np.asarray(
            getattr(ref, name)).shape
    np.testing.assert_allclose(got.us.numpy(), np.asarray(ref.us), atol=atol)
    np.testing.assert_allclose(got.K.numpy(), np.asarray(ref.K), atol=atol)


@pytest.fixture(scope="module", params=ROUTES)
def both(request):
    return solve_both(request.param, CASE)


def test_costs_iterations_reasons(both):
    ref, got = both
    check_costs(ref, got)
    # the JAX package's figures for this problem (analytic, Euler)
    np.testing.assert_allclose(np.asarray(ref.cost),
                               [136.537, 146.16084, 94.24773], rtol=1e-6)


def test_controls_and_gains(both):
    check_trajectories(*both)
