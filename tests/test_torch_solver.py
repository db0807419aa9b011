"""The composable solve of ilqr_tpu_torch (solver.py, batch.py) against the
JAX package, end to end.

- ``solve_batch(device="cpu")`` against ``ilqr_tpu.batch.solve_batch``:
  the port's "auto" route (the plain versions of the derivative, backward
  and rollout kernels) against JAX with the three kernels forced to
  "pallas" (Pallas interpret mode), and "xla" against "xla";
- ``solve`` against ``ilqr_tpu.solve`` for one problem.

The fused solver's split-sweep route, which runs the same derivative and
backward ops, is held against JAX's in tests/test_torch_fused.py and
against the composable solve here.

Acrobot with B = 3 problems, T = 8, max_iter = 5 and the 3-α schedule of
tests/test_torch_fused.py, whose seed and horizon keep every line-search
decision away from the rounding knife edge described there.

Tolerances (as tests/test_torch_fused.py): per-lane costs to rtol 1e-4,
equal iteration counts and reasons, λ to rtol 1e-6, controls and gains to
1e-4 absolute — the sides differ by sinf/cosf ulps (measured |Δus| ≤
3.1e-6). With deriv_mode="fd" the f32 stencils turn those ulps into ~1e2
in the final cost's Hessian (tests/test_torch_derivs.py), which moves the
gains by O(1) while the costs still agree to ~1e-5: costs, iterations,
reasons and λ are compared, the trajectory is not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ilqr_tpu
from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu.batch import solve_batch as jax_solve_batch
from ilqr_tpu.models import acrobot as jac
from ilqr_tpu_torch import SolverConfig, get_model, solve_batch_fused
from ilqr_tpu_torch.batch import convergence_stats, solve_batch
from ilqr_tpu_torch.models import acrobot as tac
from ilqr_tpu_torch.solver import solve

FAST_ALPHAS = (1.0, 0.3, 0.03)
COST_RTOL = 1e-4
US_ATOL = 1e-4
T, MAX_ITER = 8, 5


def _jparams():
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jac.default_params())


def _x0(seed=0, b=3):
    rng = np.random.default_rng(seed)
    return (0.05 * rng.normal(size=(b, 4))).astype(np.float32)


def _kw(**extra):
    return dict(dict(deriv_mode="analytic", clamp_forward=True,
                     max_iter=MAX_ITER, alphas=FAST_ALPHAS), **extra)


def _check(ref, got, trajectory=True):
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=COST_RTOL)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.reason.numpy(), np.asarray(ref.reason))
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(ref.lam),
                               rtol=1e-6)
    for name in got._fields:
        assert getattr(got, name).shape == np.asarray(getattr(ref,
                                                              name)).shape
    if trajectory:
        np.testing.assert_allclose(got.us.numpy(), np.asarray(ref.us),
                                   atol=US_ATOL)
        np.testing.assert_allclose(got.K.numpy(), np.asarray(ref.K),
                                   atol=US_ATOL)


@pytest.mark.parametrize("route,deriv_mode", [
    ("auto", "analytic"), ("xla", "analytic"), ("auto", "fd")])
def test_solve_batch_matches_jax(route, deriv_mode):
    x0, u0 = _x0(), np.zeros((T, 1), np.float32)
    kw = _kw(deriv_mode=deriv_mode)
    jroute = "pallas" if route == "auto" else "xla"
    ref = jax_solve_batch(
        jac.MODEL, jax.tree_util.tree_map(jnp.asarray, _jparams()),
        JaxConfig(deriv_kernel=jroute, backward_kernel=jroute,
                  rollout_kernel=jroute, **kw),
        0.02, jnp.asarray(x0), jnp.asarray(np.broadcast_to(u0, (3, T, 1))))
    got = solve_batch(
        get_model("acrobot"), tac.params_from_numpy(_jparams()),
        SolverConfig(deriv_kernel=route, backward_kernel=route,
                     rollout_kernel=route, **kw),
        0.02, x0, u0, device="cpu")
    _check(ref, got, trajectory=deriv_mode == "analytic")
    # the solve made progress: every lane stepped on every iteration
    assert np.all(got.lam.numpy() < 1e-3)


def test_solve_matches_jax():
    """One problem, no batch axis: JAX's unbatched solve (its scan route
    off the TPU) against the port's, which runs as one lane through the
    plain versions of the kernels."""
    x0, u0 = _x0()[0], np.zeros((T, 1), np.float32)
    ref = ilqr_tpu.solve(jac.MODEL,
                         jax.tree_util.tree_map(jnp.asarray, _jparams()),
                         JaxConfig(**_kw()), 0.02, jnp.asarray(x0),
                         jnp.asarray(u0))
    got = solve(get_model("acrobot"), tac.params_from_numpy(_jparams()),
                SolverConfig(**_kw()), 0.02, x0, u0, device="cpu")
    _check(ref, got)
    assert got.xs.shape == (T + 1, 4) and got.cost.shape == ()


@pytest.mark.parametrize("lam0", [1.0, -50.0])
def test_composable_equals_fused_split_sweep(lam0):
    """The composable solve and the fused split sweep run the same
    derivative and backward ops and the same line-search arithmetic, so on
    the CPU they agree bitwise but for gnorm's reduction order; λ_init = −50
    sends every lane through the λ retry first."""
    x0, u0 = _x0(5, 4), np.zeros((12, 1), np.float32)
    cfg = SolverConfig(**_kw(max_iter=8, lambda_init=lam0))
    a = solve_batch(get_model("acrobot"), tac.default_params(), cfg, 0.02,
                    x0, u0, device="cpu")
    b = solve_batch_fused(get_model("acrobot"), tac.default_params(),
                          cfg.replace(sweep_kernel="split"), 0.02, x0, u0,
                          device="cpu")
    for name in a._fields:
        if name == "gnorm":
            np.testing.assert_allclose(a.gnorm.numpy(), b.gnorm.numpy(),
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(getattr(a, name).numpy(),
                                          getattr(b, name).numpy())


def test_lambda_retry_loop_is_exact():
    """λ_init = −50 fails every lane's first backward attempt; the retry
    escalates to λ = max(−50·1.6, λmin) = λmin with dλ = 1.6, after which
    the solve must be exactly the one that starts at (λmin, 1.6)."""
    sols = []
    for lam0, dlam0 in ((-50.0, 1.0), (1e-8, 1.6)):
        sols.append(solve_batch(
            get_model("acrobot"), tac.default_params(),
            SolverConfig(**_kw(max_iter=3, lambda_init=lam0,
                               dlambda_init=dlam0)),
            0.02, _x0(7, 2), np.zeros((6, 1), np.float32), device="cpu"))
    for a, b in zip(*sols):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_frozen_lanes_and_convergence_stats():
    """Lanes stop at max_iter (or when done) and keep their state; the
    batch statistics read the Solution."""
    sol = solve_batch(get_model("acrobot"), tac.default_params(),
                      SolverConfig(**_kw(max_iter=2)), 0.02, _x0(8, 4),
                      np.zeros((4, 6, 1), np.float32), device="cpu")
    np.testing.assert_array_equal(sol.iterations.numpy(), [2, 2, 2, 2])
    np.testing.assert_array_equal(sol.reason.numpy(), [4, 4, 4, 4])
    stats = convergence_stats(sol)
    assert stats["mean_cost"].item() == pytest.approx(
        sol.cost.mean().item())
    assert stats["mean_iterations"].item() == 2.0
    assert stats["converged_frac"].item() == 0.0
    assert stats["max_cost"].item() == sol.cost.max().item()
    assert torch.isfinite(stats["mean_gnorm"])
