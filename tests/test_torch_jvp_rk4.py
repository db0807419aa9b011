"""The sweep's in-kernel JVP route (deriv_mode="analytic" with RK4: exact
derivatives of the RK4 step and the costs by dual numbers) against the JAX
package, on the CPU.

- The plain JVP sweep (mode="jvp", integrator="rk4", limits on) against the
  JAX sweep_packed(mode="jvp", integrator="rk4") in Pallas interpret mode,
  one 1024-lane block, T = 3 in time blocks of 1 (XLA:CPU compiles the
  JVP-of-JVP trace of each time block for seconds to minutes):
  acrobot, pendulum, bicycle (tan), power_mass (live cxu); omni_thruster
  (abs, projected Newton at m = 6) at T = 2, marked slow (XLA:CPU takes
  minutes to compile its JVP-of-JVP trace in interpret mode).
- The plain JVP whole iteration against the JAX iteration_packed in
  interpret mode: acrobot and power_mass (m = 2).
- The dual numbers' derivatives of the RK4 step and the costs (the dense
  fx, fu, cx, cu, cxx, cxu, cuu the JVP sweep consumes, derivs_plain) of
  the wide models, whose interpret-mode kernels XLA:CPU compiles for
  minutes (omni_thruster) to over half an hour (the quadrotor at n = 12,
  m = 4), against the JAX package's autodiff of the same step
  (ilqr_tpu.ops.derivatives.analytic_derivs, jacfwd/hessian through XLA).
- Whole solves (solve_batch_fused on the CPU, analytic + RK4) against the
  JAX XLA solve_batch: acrobot, pendulum (clamped rollout) and omni_thruster
  (boxqp_mode="pn_fixed"), costs to rtol 1e-4 and equal iteration counts
  (tests/test_fused_solver.py:31-47).

Tolerance: max |a − b| / (1 + |b|) ≤ 1e-4 on every output. Exact
derivatives have no 1/eps² amplification; the two sides differ only where
XLA:CPU contracts a·b + c into an FMA or rounds sin/cos/tan differently
from PyTorch. Inputs are drawn with numpy and handed to both sides.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu import get_model as jax_get_model
from ilqr_tpu.batch import solve_batch as jax_solve_batch
from ilqr_tpu.ops import derivatives as jax_derivatives
from ilqr_tpu.ops import pallas_iter, pallas_rollout, pallas_sweep
from ilqr_tpu_torch import SolverConfig, get_model, solve_batch_fused
from ilqr_tpu_torch.ops import (
    kernel_derivs,
    kernel_iter,
    kernel_rollout,
    kernel_sweep,
)

B, T, TB = 1024, 3, 1      # one packed block, three time blocks
TOL = 1e-4
ALPHAS = np.asarray([1.0, 0.5, 0.1], np.float32)
DT = {"acrobot": 0.02, "pendulum": 0.05, "bicycle": 0.05,
      "power_mass": 0.05, "omni_thruster": 0.05, "quadrotor": 0.02}


def _params(name):
    """(JAX params, port params) of ``name``'s defaults in f32."""
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                jax_get_model(name).default_params())
    mod = importlib.import_module(f"ilqr_tpu_torch.models.{name}")
    return jax.tree_util.tree_map(jnp.asarray, jp), mod.params_from_numpy(jp)


def _packs(name):
    jp, tp = _params(name)
    return (pallas_rollout.pack_params(jp, DT[name]),
            kernel_rollout.pack_params(tp, DT[name]))


def _jp(a):
    """Lane-last numpy array → JAX packed (…, 1, 8, 128) f32 array."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a.reshape(a.shape[:-1] + (1, 8, 128)))


def _tp(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _unj(y):
    y = np.asarray(y)
    return y.reshape(y.shape[:-3] + (B,))


def _rel(got, want, scale=None):
    """max |got − want| / (1 + |scale|), NaNs in the same places."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = want if scale is None else np.broadcast_to(scale, want.shape)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    return float((np.abs(got[ok] - want[ok])
                  / (1.0 + np.abs(scale[ok]))).max(initial=0.0))


def _u_mid(name, tp):
    """Controls around which inputs are drawn: the hover thrusts of the
    quadrotor and omni_thruster, else zero."""
    if name in ("quadrotor", "omni_thruster"):
        mod = importlib.import_module(f"ilqr_tpu_torch.models.{name}")
        return mod.hover_control(tp).numpy()
    return np.zeros(get_model(name).m)


def _inputs(name, t=T, scale=3.0):
    """(x0, xs, us, x_T, λ) of one block: a clamped open-loop RK4 rollout of
    controls drawn so that the boxes bind on some lanes; λ mostly 1, some
    1e-3, 1/8 negative (the divergence latch)."""
    tm = get_model(name)
    _jp_, tpack = _packs(name)
    _j, tp = _params(name)
    n, m = tm.n, tm.m
    rng = np.random.default_rng(41)
    x0 = (0.5 * rng.normal(size=(n, B))).astype(np.float32)
    us_in = (_u_mid(name, tp)[None, :, None]
             + scale * rng.normal(size=(t, m, B))).astype(np.float32)
    xs, us, xT, _c = kernel_rollout.rollout_plain(
        tm, "rk4", True, tpack, _tp(x0), _tp(us_in), torch.zeros(t, n, B),
        torch.zeros(t, m, n, B))
    lam = np.ones(B, np.float32)
    lam[rng.uniform(size=B) < 0.25] = 1e-3
    lam[rng.uniform(size=B) < 0.125] = -100.0
    return x0, xs.numpy(), us.numpy(), xT.numpy(), lam


def _check_sweep(name, t, tb):
    jm, tm = jax_get_model(name), get_model(name)
    jpack, tpack = _packs(name)
    _x0, xs, us, xT, lam = _inputs(name, t)
    want = [_unj(w) for w in pallas_sweep.sweep_packed(
        jm, "rk4", jpack, _jp(xs), _jp(xT), _jp(us), _jp(lam), mode="jvp",
        interpret=True, use_limits=True, time_block=tb)]
    got = kernel_sweep.sweep_packed(tm, "rk4", tpack, _tp(xs), _tp(xT),
                                    _tp(us), _tp(lam), mode="jvp")
    for g, w, what in zip(got, want, ("k", "K", "dv", "diverged", "gnorm")):
        assert _rel(g, w) <= TOL, (name, what, _rel(g, w))
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    div = got[3].numpy()
    assert div[lam < 0].min() == 1.0 and div[lam > 0].max() == 0.0
    # the dual numbers differentiate the RK4 step: not the Euler closed
    # forms on these inputs
    euler = kernel_sweep.sweep_packed(tm, "euler", tpack, _tp(xs), _tp(xT),
                                      _tp(us), _tp(lam), mode="jvp")
    assert np.abs(euler[1].numpy() - got[1].numpy()).max() > 1e-5


@pytest.mark.parametrize("name", ["acrobot", "pendulum", "bicycle",
                                  "power_mass"])
def test_jvp_sweep_matches_jax(name):
    """The plain JVP sweep against the JAX kernel's in-kernel JVPs (see the
    module docstring). Measured max |a − b| / (1 + |b|) over k, K, dv and
    gnorm: acrobot 3.9e-5 (K), pendulum 7.7e-7, bicycle 4.0e-7, power_mass
    3.6e-7."""
    _check_sweep(name, T, TB)


@pytest.mark.slow
def test_jvp_sweep_matches_jax_omni_thruster():
    """omni_thruster (abs in the drag, projected Newton at m = 6), T = 2 in
    time blocks of 1: XLA:CPU compiles its interpret-mode trace for
    minutes. Measured 3.2e-5 (k)."""
    _check_sweep("omni_thruster", 2, 1)


@pytest.mark.parametrize("name", ["acrobot", "power_mass"])
def test_jvp_iteration_matches_jax(name):
    """The plain JVP whole iteration (sweep, gates, RK4 line search over
    three α's, the post-accept state) against the JAX iteration_packed in
    interpret mode, T = 3 in time blocks of 1; previous costs placed
    between this iteration's candidate costs, half a gap from each. Every
    output to TOL; α, the accept flags and the latch exact. Measured:
    acrobot 2.2e-5 (K_keep), power_mass 4.3e-7 (us)."""
    jm, tm = jax_get_model(name), get_model(name)
    jpack, tpack = _packs(name)
    n, m = tm.n, tm.m
    x0, xs, us, xT, lam = _inputs(name)
    rng = np.random.default_rng(42)
    kold = rng.normal(size=(T, m, B)).astype(np.float32)
    Kold = rng.normal(size=(T, m, n, B)).astype(np.float32)
    live = (rng.uniform(size=B) > 0.25).astype(np.float32)
    k, K, *_ = kernel_sweep.sweep_plain(tm, "rk4", tpack, _tp(xs), _tp(xT),
                                        _tp(us), _tp(lam), "jvp")
    cand = np.stack([kernel_rollout.rollout_plain(
        tm, "rk4", True, tpack, _tp(x0), _tp(us + a * k.numpy()), _tp(xs),
        K)[3].numpy() for a in ALPHAS])
    s = np.sort(cand, axis=0)
    choice = rng.integers(0, len(ALPHAS) + 1, size=B)
    cprev = np.where(choice == 0, s[0] - 1.0, s[-1] + 1.0)
    for o in range(1, len(ALPHAS)):
        use = (choice == o) & (s[o] - s[o - 1] > 1e-3 * (1 + np.abs(s[o])))
        cprev = np.where(use, 0.5 * (s[o - 1] + s[o]), cprev)
    cprev = cprev.astype(np.float32)
    kw = dict(mode="jvp", use_limits=True, z_min=0.0, tol_grad=1e-6,
              lambda_grad_term=1e-5)
    want = pallas_iter.iteration_packed(
        jm, "rk4", True, jpack, _jp(x0), _jp(xs), _jp(xT), _jp(us),
        _jp(kold), _jp(Kold), _jp(lam), _jp(cprev), _jp(live),
        jnp.asarray(ALPHAS), interpret=True, time_block=TB, **kw)
    got = kernel_iter.iteration_packed(
        tm, "rk4", True, tpack, _tp(x0), _tp(xs), _tp(xT), _tp(us),
        _tp(kold), _tp(Kold), _tp(lam), _tp(cprev), _tp(live), _tp(ALPHAS),
        **kw)
    names = ("xs", "us", "x_final", "k_keep", "K_keep", "ls_cost",
             "alpha_sel", "accepted", "dcost", "expected", "diverged",
             "gnorm")
    assert len(got) == len(want) == 12
    for g, w, what in zip(got, want, names):
        w = _unj(w)
        err = _rel(g, w, scale=cprev if what == "dcost" else None)
        assert err <= TOL, (name, what, err)
    for i in (6, 7, 10):   # α, accepted and diverged are exact
        np.testing.assert_array_equal(got[i].numpy(), _unj(want[i]))
    acc, div = got[7].numpy(), got[10].numpy()
    take = (acc > 0.5) & (div < 0.5) & (live > 0.5)
    assert take.any() and (~take).any()


@pytest.mark.parametrize("name", ["omni_thruster", "quadrotor"])
def test_jvp_derivatives_match_jax_autodiff(name):
    """The dual numbers' exact derivatives of the RK4 step, the running
    cost and the final cost (derivs_plain, mode="jvp": what the JVP sweep
    consumes at every step and at x_T) against the JAX package's autodiff
    of the same RK4 step (analytic_derivs with integrator="rk4"), B = 3
    problems, T = 4, states 0.4·normal and controls around the hover
    thrust: every field to TOL. Measured max |a − b| / (1 + |b|):
    omni_thruster 0 (bit for bit), the quadrotor 6.7e-8."""
    jm, tm = jax_get_model(name), get_model(name)
    jp, tp = _params(name)
    rng = np.random.default_rng(43)
    b, t = 3, 4
    xs = (0.4 * rng.normal(size=(b, t + 1, jm.n))).astype(np.float32)
    us = (_u_mid(name, tp)[None, None]
          + 0.4 * rng.normal(size=(b, t, jm.m))).astype(np.float32)
    cfg = JaxConfig(integrator="rk4")
    want = jax.vmap(lambda a, c: jax_derivatives.analytic_derivs(
        jm, jp, cfg, DT[name], a, c))(jnp.asarray(xs), jnp.asarray(us))
    got = kernel_derivs.derivs_batched(
        tm, "rk4", kernel_rollout.pack_params(tp, DT[name]), _tp(xs),
        _tp(us), mode="jvp")
    for g, what in zip(got, ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu")):
        w = np.asarray(getattr(want, what))
        assert _rel(g, w) <= TOL, (name, what, _rel(g, w))
    # the RK4 step, not the Euler one
    euler = kernel_derivs.derivs_batched(
        tm, "euler", kernel_rollout.pack_params(tp, DT[name]), _tp(xs),
        _tp(us), mode="jvp")
    assert np.abs(euler[0].numpy() - got[0].numpy()).max() > 1e-5


XLA = dict(backward_kernel="xla", rollout_kernel="xla", deriv_kernel="xla")


def _solve_both(name, x0, u0, dt, **kw):
    jp, tp = _params(name)
    ref = jax_solve_batch(
        jax_get_model(name), jp,
        JaxConfig(deriv_mode="analytic", integrator="rk4", **XLA, **kw), dt,
        jnp.asarray(x0), jnp.asarray(u0))
    got = solve_batch_fused(
        get_model(name), tp,
        SolverConfig(deriv_mode="analytic", integrator="rk4", **kw), dt, x0,
        u0, device="cpu")
    return ref, got


def _case(name):
    """(x0, u0, dt, config) of the whole-solve comparison of ``name``."""
    if name == "acrobot":   # the CLI's unclamped rollout, 4 lanes
        x0 = 0.05 * np.random.default_rng(0).normal(size=(4, 4))
        return x0, np.zeros((12, 1)), 0.02, dict(max_iter=5)
    if name == "pendulum":  # tests/test_fused_solver.py:72-83's inputs
        x0 = 0.2 * np.random.default_rng(6).normal(size=(2, 2))
        return x0, np.zeros((10, 1)), 0.05, dict(clamp_forward=True,
                                                 max_iter=10)
    from ilqr_tpu.models import omni_thruster as jot

    jp, _tp_ = _params(name)
    x0 = 0.2 * np.random.default_rng(5).normal(size=(2, 6))
    u0 = np.tile(np.asarray(jot.hover_control(jp))[None], (8, 1))
    return x0, u0, 0.05, dict(boxqp_mode="pn_fixed", clamp_forward=True,
                              max_iter=4)


@pytest.mark.parametrize("name", ["acrobot", "pendulum", "omni_thruster"])
def test_analytic_rk4_solve_matches_jax_xla(name):
    """Whole solves with deriv_mode="analytic" and RK4 (the JVP route on
    the whole-iteration op for acrobot and pendulum, the split iteration
    for omni_thruster at m·n = 36) against the JAX XLA solve_batch: costs
    to rtol 1e-4 and equal iteration counts, controls within the JAX
    package's 0.05 (tests/test_fused_solver.py:31-47) and, with the clamped
    rollout, inside the box. Measured (costs relative, controls absolute):
    acrobot 1.3e-7 and 5.2e-3, pendulum 0 and 0, omni_thruster 9.9e-8 and
    3.6e-6."""
    x0, u0, dt, kw = _case(name)
    ref, got = _solve_both(name, x0.astype(np.float32),
                           u0.astype(np.float32), dt,
                           alphas=(1.0, 0.3, 0.03), **kw)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-4)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    us = got.us.numpy()
    assert np.abs(us - np.asarray(ref.us)).max() < 0.05
    _jp_, tp = _params(name)
    if kw.get("clamp_forward"):
        assert us.min() >= float(tp.u_min.min()) - 1e-6
        assert us.max() <= float(tp.u_max.max()) + 1e-6
