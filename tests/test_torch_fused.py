"""ilqr_tpu_torch.solve_batch_fused (plain versions, CPU) against
ilqr_tpu.fused.solve_batch_fused (Pallas interpret mode), end to end.

Acrobot swing-up with B = 3 problems and the 3-α schedule of the JAX
package's fast fused tests. The JAX side uses time blocks of 3 so its
edge-row masking runs (T = 8 is not a multiple of 3).

The horizon and seed are chosen so that no lane's line search sits on a
rounding knife edge within max_iter: every accepted or rejected step has
|dcost| at least ~30 ulps of the cost (checked with the port). Near
convergence dcost shrinks to an ulp of the cost, where the sign of
cprev − cost — and with it the λ schedule and the next step — is decided
by rounding and may differ between any two f32 implementations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu.fused import solve_batch_fused as jax_solve
from ilqr_tpu.models import acrobot as jac
from ilqr_tpu_torch import SolverConfig, get_model, solve_batch_fused
from ilqr_tpu_torch.fused import fused_applicable
from ilqr_tpu_torch.models import acrobot as tac

FAST_ALPHAS = (1.0, 0.3, 0.03)
# Per-lane costs to rtol 1e-4; controls and gains to 1e-4 absolute: the
# two sides differ only by sinf/cosf ulps (max |Δus| measured 1.7e-6, |ΔK|
# 3.8e-6 after five iterations); a different accept/reject decision moves
# us by ~1e-2.
COST_RTOL = 1e-4
US_ATOL = 1e-4


def _solve_both(iter_kernel, T, max_iter, alphas, seed, **extra):
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                jac.default_params())
    rng = np.random.default_rng(seed)
    x0 = (0.05 * rng.normal(size=(3, 4))).astype(np.float32)
    u0 = np.zeros((T, 1), np.float32)
    kw = dict(dict(deriv_mode="analytic", clamp_forward=True,
                   max_iter=max_iter, alphas=alphas,
                   iter_kernel=iter_kernel), **extra)
    ref = jax_solve(
        jac.MODEL, jax.tree_util.tree_map(jnp.asarray, jp),
        JaxConfig(iter_time_block=3, sweep_time_block=3, ls_time_block=3,
                  **kw), 0.02, jnp.asarray(x0), jnp.asarray(u0))
    got = solve_batch_fused(get_model("acrobot"), tac.params_from_numpy(jp),
                            SolverConfig(**kw), 0.02, x0, u0, device="cpu")
    return ref, got


def _check(ref, got, trajectory=True):
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=COST_RTOL)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.reason.numpy(), np.asarray(ref.reason))
    if trajectory:
        np.testing.assert_allclose(got.us.numpy(), np.asarray(ref.us),
                                   atol=US_ATOL)
        np.testing.assert_allclose(got.K.numpy(), np.asarray(ref.K),
                                   atol=US_ATOL)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(ref.lam),
                               rtol=1e-6)
    for name in ("xs", "us", "k", "K"):
        assert getattr(got, name).shape == np.asarray(getattr(ref,
                                                              name)).shape


@pytest.mark.parametrize("iter_kernel", ["merged", "split"])
def test_matches_jax_fused(iter_kernel):
    ref, got = _solve_both(iter_kernel, T=8, max_iter=5,
                           alphas=FAST_ALPHAS, seed=0)
    _check(ref, got)
    # the solve made progress: every lane stepped on every iteration
    assert np.all(got.lam.numpy() < 1e-3)


@pytest.mark.parametrize("deriv_mode", ["analytic", "fd"])
def test_split_sweep_matches_jax_fused(deriv_mode):
    """sweep_kernel="split": the derivative kernel once per iteration and
    the backward kernel per λ attempt, then the line-search kernel. With
    deriv_mode="fd" the f32 stencils turn sinf/cosf ulps into ~1e2 in the
    final cost's Hessian (tests/test_torch_derivs.py), which moves the gains
    by O(1) while the costs still agree to ~1e-5: costs, iterations,
    reasons and λ are compared there, the trajectory is not."""
    ref, got = _solve_both("auto", T=8, max_iter=5, alphas=FAST_ALPHAS,
                           seed=0, sweep_kernel="split",
                           deriv_mode=deriv_mode)
    _check(ref, got, trajectory=deriv_mode == "analytic")
    assert np.all(got.lam.numpy() < 1e-3)


def test_matches_jax_fused_lambda_retry():
    """λ_init = −50 makes QuuF ≤ 0 on every lane's first backward attempt,
    so the λ-escalation retry loop (ref ilqr_core.cpp:136-150) runs on both
    sides. With λ then at λmin (and 0 after the first accept), lane 1
    reaches a full Newton step whose dcost is an ulp of the cost at the
    fifth iteration, so this case stops at four."""
    ref, got = _solve_both("merged", T=8, max_iter=4, alphas=FAST_ALPHAS,
                           seed=0, lambda_init=-50.0)
    _check(ref, got)


@pytest.mark.slow
def test_matches_jax_fused_full_schedule():
    """The T=19, 11-α problem of tests/test_fused_solver.py."""
    from ilqr_tpu_torch.config import DEFAULT_ALPHAS

    ref, got = _solve_both("merged", T=19, max_iter=5,
                           alphas=DEFAULT_ALPHAS, seed=0)
    _check(ref, got)


def test_merged_equals_split():
    """The two iteration routes of the port compute the same iteration."""
    sols = []
    for ik in ("merged", "split"):
        rng = np.random.default_rng(5)
        x0 = (0.05 * rng.normal(size=(4, 4))).astype(np.float32)
        sols.append(solve_batch_fused(
            get_model("acrobot"), tac.default_params(),
            SolverConfig(deriv_mode="analytic", clamp_forward=True,
                         max_iter=6, alphas=FAST_ALPHAS, iter_kernel=ik,
                         fused_unroll=4),
            0.02, x0, np.zeros((12, 1), np.float32), device="cpu"))
    for a, b in zip(*sols):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_unroll_is_exact():
    """max_iter not a multiple of fused_unroll: sub-iterations past the
    budget are frozen, so any unroll gives identical results."""
    out = []
    for unroll in (1, 4):
        rng = np.random.default_rng(6)
        x0 = (0.05 * rng.normal(size=(2, 4))).astype(np.float32)
        out.append(solve_batch_fused(
            get_model("acrobot"), tac.default_params(),
            SolverConfig(deriv_mode="analytic", clamp_forward=True,
                         max_iter=3, alphas=FAST_ALPHAS,
                         fused_unroll=unroll),
            0.02, x0, np.zeros((6, 1), np.float32), device="cpu"))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(out[0].iterations.numpy(), [3, 3])


@pytest.mark.parametrize("iter_kernel", ["merged", "split"])
def test_lambda_retry_loop_is_exact(iter_kernel):
    """With λ_init = −50 the first backward attempt fails on every lane and
    the retry escalates to λ = max(−50·1.6, λmin) = λmin, dλ = 1.6. From
    there the solve must be exactly the one that starts at (λmin, 1.6):
    the retry re-ran the failed lanes and left nothing else behind."""
    sols = []
    for lam0, dlam0 in ((-50.0, 1.0), (1e-8, 1.6)):
        rng = np.random.default_rng(7)
        x0 = (0.05 * rng.normal(size=(2, 4))).astype(np.float32)
        sols.append(solve_batch_fused(
            get_model("acrobot"), tac.default_params(),
            SolverConfig(deriv_mode="analytic", clamp_forward=True,
                         max_iter=3, alphas=FAST_ALPHAS,
                         iter_kernel=iter_kernel, lambda_init=lam0,
                         dlambda_init=dlam0),
            0.02, x0, np.zeros((6, 1), np.float32), device="cpu"))
    for a, b in zip(*sols):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_unsupported_configurations_raise():
    m, p = get_model("acrobot"), tac.default_params()
    x0, u0 = np.zeros((2, 4), np.float32), np.zeros((5, 1), np.float32)
    for bad, exc in ((dict(sweep_kernel="split", iter_kernel="merged"),
                      ValueError),
                     (dict(sweep_kernel="fused"), ValueError),
                     (dict(sweep_kernel="split", use_control_limits=False),
                      ValueError),
                     (dict(full_ddp=True), ValueError),
                     (dict(boxqp_mode="iterative"), ValueError)):
        with pytest.raises(exc):
            solve_batch_fused(m, p, SolverConfig(**bad), 0.02, x0, u0,
                              device="cpu")
    # per-problem params run (every leaf with a leading batch axis)
    batched = type(p)(*[v.expand((2,) + tuple(v.shape)) for v in p])
    sol = solve_batch_fused(m, batched, SolverConfig(max_iter=2), 0.02, x0,
                            u0, device="cpu", params_batched=True)
    assert np.all(np.isfinite(sol.cost.numpy()))
    # m >= 2 runs on the merged sweep only (the split sweep's backward
    # kernel is the closed-form m = 1 QP)
    di = get_model("double_integrator")
    with pytest.raises(ValueError, match="sweep_kernel"):
        solve_batch_fused(di, di.default_params(),
                          SolverConfig(sweep_kernel="split"), 0.02,
                          np.zeros((2, 4), np.float32),
                          np.zeros((5, 2), np.float32), device="cpu")
    # m up to 24 runs (projected Newton from m = 5); m > 24 is past the
    # JAX package's cap
    assert fused_applicable(dataclasses.replace(m, name="m6", m=6),
                            SolverConfig())
    wide = dataclasses.replace(m, name="m25", m=25)
    with pytest.raises(ValueError):
        solve_batch_fused(wide, p, SolverConfig(), 0.02, x0,
                          np.zeros((5, 25), np.float32), device="cpu")
    assert not fused_applicable(wide, SolverConfig())
    from ilqr_tpu_torch.fused import solve_batch_fused_warm

    # the warm start runs from a previous Solution
    warm = solve_batch_fused_warm(m, p, SolverConfig(max_iter=2), 0.02, x0,
                                  sol, device="cpu")
    assert np.all(np.isfinite(warm.cost.numpy()))
    assert fused_applicable(m, SolverConfig())
    assert fused_applicable(m, SolverConfig(use_control_limits=False))
    assert fused_applicable(m, SolverConfig(deriv_mode="fd"))
    assert fused_applicable(m, SolverConfig(deriv_mode="fd",
                                            integrator="rk4"))
    # analytic + RK4 (the in-kernel JVP route) and RK4 on the split sweep
    # are carried; the JVP route of a model without jac_soa is not
    assert fused_applicable(m, SolverConfig(integrator="rk4"))
    assert fused_applicable(m, SolverConfig(
        deriv_mode="fd", integrator="rk4", sweep_kernel="split"))
    assert fused_applicable(m, SolverConfig(integrator="rk4",
                                            sweep_kernel="split"))
    custom = dataclasses.replace(m, name="custom", jac_soa=None)
    assert not fused_applicable(custom, SolverConfig(integrator="rk4"))
    with pytest.raises(NotImplementedError, match="B2"):
        solve_batch_fused(custom, p, SolverConfig(integrator="rk4"), 0.02,
                          x0, u0, device="cpu")
    assert fused_applicable(m, SolverConfig(sweep_kernel="split",
                                            deriv_mode="fd"))
    assert not fused_applicable(m, SolverConfig(sweep_kernel="split",
                                                use_control_limits=False))
    for name in ("double_integrator", "point_mass_3d", "quadrotor"):
        mm = get_model(name)
        assert fused_applicable(mm, SolverConfig())
        assert fused_applicable(mm, SolverConfig(use_control_limits=False))
        assert not fused_applicable(mm, SolverConfig(sweep_kernel="split"))
