"""The port's RK4 step and the reference's central stencils inside the fused
sweep against the JAX package, on the CPU.

- RK4 rollouts and line searches (the plain versions) against the JAX
  kernels in Pallas interpret mode: acrobot, power_mass and the quadrotor.
- The plain stencil sweep (mode="fd", Euler and RK4, with limits) against
  the JAX sweep_packed(mode="fd", eps=0.05) in interpret mode: acrobot, the
  double integrator and power_mass. eps = 0.05 keeps the f32 stencils well
  above rounding: at the solver's eps = 1e-3 the Hessian stencil divides
  cost differences by 4e-6, so one ulp of a cost moves cxx by ~0.25, and
  XLA:CPU's fused code rounds a few operations differently from the port.
- Whole fd solves (solve_batch_fused on the CPU) against the JAX XLA
  solve_batch in fd mode at the default eps, under the bounds of the JAX
  package's own fd test (tests/test_fused_solver.py:486-506).

Inputs are drawn with numpy and handed to both sides; the port takes the
lane-last (…, B) layout, the JAX packed (…, 1, 8, 128) layout flattened.
The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
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
from ilqr_tpu.ops import pallas_rollout, pallas_sweep
from ilqr_tpu_torch import SolverConfig, get_model, solve_batch_fused
from ilqr_tpu_torch.ops import kernel_rollout, kernel_sweep

B, T, TB = 1024, 7, 3      # one packed block; 7 = 3 + 3 + 1 masked rows
ALPHAS = np.asarray([1.0, 0.5, 0.1], np.float32)
DT = {"acrobot": 0.02, "quadrotor": 0.02, "double_integrator": 0.02,
      "power_mass": 0.05, "pendulum": 0.05, "omni_thruster": 0.05}


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


def _u_mid(name, m):
    """Controls around which inputs are drawn: hover thrust for the
    quadrotor (its rotors' box is [0, u_max])."""
    if name == "quadrotor":
        from ilqr_tpu_torch.models import quadrotor
        return quadrotor.hover_control(_params(name)[1]).numpy()[:, None]
    return np.zeros((m, 1))


# ---------------------------------------------------------------------------
# RK4 in the rollout and the line search

@pytest.mark.parametrize("name", ["acrobot", "power_mass", "quadrotor"])
def test_rk4_rollout_matches_jax(name):
    """The plain RK4 rollout (unclamped) against the JAX rollout_batched in
    interpret mode on the inputs of tests/test_pallas_rollout.py:51 (B = 3,
    T = 9): states and controls to atol 1e-5, costs to rtol 1e-5. Measured
    max |a − b| on states / controls, relative on costs: acrobot 3.0e-8 /
    1.2e-7 / 0, power_mass 7.5e-9 / 6.0e-8 / 0, the quadrotor 3.6e-6 /
    1.0e-6 / 2.0e-7."""
    jm, tm = jax_get_model(name), get_model(name)
    jp, tp = _params(name)
    rng = np.random.default_rng(1)
    b, t = 3, 9
    x0 = (rng.normal(size=(b, jm.n)) * 0.3).astype(np.float32)
    uff = (rng.normal(size=(b, t, jm.m)) * 0.5
           + _u_mid(name, jm.m)[:, 0]).astype(np.float32)
    xsr = (rng.normal(size=(b, t + 1, jm.n)) * 0.3).astype(np.float32)
    K = (rng.normal(size=(b, t, jm.m, jm.n)) * 0.2).astype(np.float32)
    want = pallas_rollout.rollout_batched(
        jm, "rk4", False, jp, 0.02, jnp.asarray(x0), jnp.asarray(uff),
        jnp.asarray(xsr), jnp.asarray(K), interpret=True)
    got = kernel_rollout.rollout_batched(
        tm, "rk4", False, kernel_rollout.pack_params(tp, 0.02), _tp(x0),
        _tp(uff), _tp(xsr), _tp(K))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5)
    # RK4 is not the Euler step on these inputs
    euler = kernel_rollout.rollout_batched(
        tm, "euler", False, kernel_rollout.pack_params(tp, 0.02), _tp(x0),
        _tp(uff), _tp(xsr), _tp(K))
    assert np.abs(euler[0].numpy() - got[0].numpy()).max() > 1e-4


@pytest.mark.parametrize("name", ["acrobot", "power_mass", "quadrotor"])
def test_rk4_linesearch_matches_jax(name):
    """The plain RK4 line search against the JAX linesearch_packed in
    interpret mode (one 1024-lane block, T = 7 in time blocks of 3, three
    α's, an unclamped rollout as the CLI runs it): states, controls and
    gains to atol 1e-5; costs to rtol 1e-5 (dcost against the costs it was
    taken from); the selected α and the accept flags exact. Measured max
    |a − b| on states and controls, relative on costs: acrobot 1.8e-7 and
    2.8e-7, power_mass 1.2e-7 and 2.1e-7, the quadrotor 1.9e-6 and 3.2e-7;
    the gains 0."""
    jm, tm = jax_get_model(name), get_model(name)
    jpack, tpack = _packs(name)
    n, m = jm.n, jm.m
    rng = np.random.default_rng(21)
    x0 = (0.3 * rng.normal(size=(n, B))).astype(np.float32)
    us_in = (0.5 * rng.normal(size=(T, m, B))
             + _u_mid(name, m)).astype(np.float32)
    xs, us, xT, _c = kernel_rollout.rollout_plain(
        tm, "rk4", False, tpack, _tp(x0), _tp(us_in), torch.zeros(T, n, B),
        torch.zeros(T, m, n, B))
    xs, us, xT = xs.numpy(), us.numpy(), xT.numpy()
    k = (0.3 * rng.normal(size=(T, m, B))).astype(np.float32)
    K = (0.05 * rng.normal(size=(T, m, n, B))).astype(np.float32)
    kold = rng.normal(size=(T, m, B)).astype(np.float32)
    Kold = rng.normal(size=(T, m, n, B)).astype(np.float32)
    dv = np.stack([-np.abs(rng.normal(size=B)) * 5.0,
                   rng.normal(size=B) * 0.1]).astype(np.float32)
    cand = np.stack([kernel_rollout.rollout_plain(
        tm, "rk4", False, tpack, _tp(x0), _tp(us + a * k), _tp(xs), _tp(K)
    )[3].numpy() for a in ALPHAS])
    # previous costs between the candidates', half a gap from each
    s = np.sort(cand, axis=0)
    choice = rng.integers(0, len(ALPHAS) + 1, size=B)
    cprev = np.where(choice == 0, s[0] - 1.0, s[-1] + 1.0)
    for o in range(1, len(ALPHAS)):
        use = (choice == o) & (s[o] - s[o - 1] > 1e-3 * (1 + np.abs(s[o])))
        cprev = np.where(use, 0.5 * (s[o - 1] + s[o]), cprev)
    cprev = cprev.astype(np.float32)
    gate = (rng.uniform(size=B) > 0.5).astype(np.float32)
    keep = (rng.uniform(size=B) > 0.5).astype(np.float32)
    want = pallas_rollout.linesearch_packed(
        jm, "rk4", False, jpack, _jp(x0), _jp(us), _jp(xs), _jp(xT), _jp(K),
        _jp(k), _jp(Kold), _jp(kold), jnp.asarray(ALPHAS), _jp(dv),
        _jp(cprev), _jp(gate), _jp(keep), 0.0, interpret=True, time_block=TB)
    got = kernel_rollout.linesearch_packed(
        tm, "rk4", False, tpack, _tp(x0), _tp(us), _tp(xs), _tp(xT), _tp(K),
        _tp(k), _tp(Kold), _tp(kold), _tp(ALPHAS), _tp(dv), _tp(cprev),
        _tp(gate), _tp(keep), 0.0)
    names = ("xs", "us", "x_final", "k_keep", "K_keep", "ls_cost",
             "alpha_sel", "accepted", "dcost", "expected")
    for g, w, what in zip(got, want, names):
        w = _unj(w)
        if what in ("alpha_sel", "accepted"):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=what)
        elif what in ("ls_cost", "expected"):
            assert _rel(g, w) <= 1e-5, what
        elif what == "dcost":
            assert _rel(g, w, scale=cprev) <= 1e-5, what
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5,
                                       err_msg=what)
    acc = got[7].numpy()
    assert 0 < acc.sum() < B


# ---------------------------------------------------------------------------
# The stencils inside the merged sweep

FD_EPS = 0.05
SWEEP_CASES = [("acrobot", "euler"), ("acrobot", "rk4"),
               ("double_integrator", "euler"), ("double_integrator", "rk4"),
               ("power_mass", "euler"), ("power_mass", "rk4")]
# the trig-free cases, also held without XLA's FMAs
# (tests/test_torch_fd_sweep.py)
NO_TRIG_CASES = [c for c in SWEEP_CASES if c[0] != "acrobot"]


def _sweep_inputs(name, integrator):
    """(xs, us, x_T, λ) of one 1024-lane block, T = 7: a clamped open-loop
    rollout of controls drawn so that the boxes bind on some lanes; λ
    mostly 1, some 1e-3, 1/8 negative (the divergence latch)."""
    tm = get_model(name)
    _jpack, tpack = _packs(name)
    n, m = tm.n, tm.m
    rng = np.random.default_rng(31)
    x0 = (0.5 * rng.normal(size=(n, B))).astype(np.float32)
    us_in = (3.0 * rng.normal(size=(T, m, B))).astype(np.float32)
    xs, us, xT, _c = kernel_rollout.rollout_plain(
        tm, integrator, True, tpack, _tp(x0), _tp(us_in),
        torch.zeros(T, n, B), torch.zeros(T, m, n, B))
    lam = np.ones(B, np.float32)
    lam[rng.uniform(size=B) < 0.25] = 1e-3
    lam[rng.uniform(size=B) < 0.125] = -100.0
    return xs.numpy(), us.numpy(), xT.numpy(), lam


def _port_sweep(name, integrator, xs, us, xT, lam, mode="fd"):
    _jpack, tpack = _packs(name)
    return kernel_sweep.sweep_packed(
        get_model(name), integrator, tpack, _tp(xs), _tp(xT), _tp(us),
        _tp(lam), mode=mode, eps=FD_EPS)


def _lane_rel(got, want):
    """Per-lane max |got − want| / (1 + |want|) over every other axis."""
    e = np.abs(got - want) / (1.0 + np.abs(want))
    return e.reshape(-1, B).max(axis=0)


@pytest.mark.parametrize("name,integrator", [("acrobot", "euler"),
                                             ("acrobot", "rk4")])
def test_fd_sweep_matches_jax(name, integrator):
    """The plain stencil sweep (mode="fd", eps = 0.05, the ``integrator``
    step, limits on) against the JAX sweep_packed in interpret mode, both
    in this process, on one 1024-lane block, T = 7 in time blocks of 3
    (_sweep_inputs): dense fx, fu, cx, cu, cxx, cxu, cuu at every step and
    a dense V_T Hessian. Held as a gauge, per lane over k and K: p99 ≤ 5e-3,
    max ≤ 5e-2; dv and gnorm ≤ 5e-3 relative; the latch exact. The f32
    stencils scale each rounding difference of a cost by 1/(4·eps²) = 100:
    XLA:CPU contracts a·b + c into FMAs (tests/test_torch_fd_sweep.py holds
    the trig-free models without them, to 1e-4) and its sin/cos differ from
    torch's by ulps. Measured (k, K per lane, p99 / max): 1.4e-3 / 7.8e-3
    (Euler), 1.5e-3 / 4.7e-3 (RK4); dv, gnorm ≤ 4.6e-4. ROADMAP.md §C logs
    the gap to the 1e-4 the analytic kernels hold."""
    jm = jax_get_model(name)
    jpack, _tpack = _packs(name)
    xs, us, xT, lam = _sweep_inputs(name, integrator)
    want = [_unj(w) for w in pallas_sweep.sweep_packed(
        jm, integrator, jpack, _jp(xs), _jp(xT), _jp(us), _jp(lam),
        mode="fd", eps=FD_EPS, interpret=True, use_limits=True,
        time_block=TB)]
    got = [g.numpy() for g in _port_sweep(name, integrator, xs, us, xT, lam)]
    lanes = np.maximum(_lane_rel(got[0], want[0]), _lane_rel(got[1], want[1]))
    assert np.percentile(lanes, 99) <= 5e-3 and lanes.max() <= 5e-2
    for i in (2, 4):   # dv, gnorm
        assert _rel(got[i], want[i]) <= 5e-3
    np.testing.assert_array_equal(got[3], want[3])
    _check_sweep_inputs(name, integrator, xs, us, xT, lam, got)


def _check_sweep_inputs(name, integrator, xs, us, xT, lam, got):
    """What the inputs exercise: the latch fires exactly on λ < 0; the
    acrobot's box binds somewhere (the QP's clamped branch runs); the
    stencils are not the analytic route."""
    div = np.asarray(got[3])
    assert div[lam < 0].min() == 1.0 and div[lam > 0].max() == 0.0
    if name == "acrobot":
        uk = (us + np.asarray(got[0]))[..., lam > 0]
        assert np.any(np.isclose(np.abs(uk), 5.0))
    if integrator == "euler":
        ana = _port_sweep(name, "euler", xs, us, xT, lam, mode="jvp")
        assert np.abs(ana[1].numpy() - np.asarray(got[1])).max() > 1e-5


# ---------------------------------------------------------------------------
# Whole fd solves against the JAX package's XLA path

XLA = dict(backward_kernel="xla", rollout_kernel="xla", deriv_kernel="xla")


def _solve_both(name, x0, u0, dt, **kw):
    jp, tp = _params(name)
    ref = jax_solve_batch(jax_get_model(name), jp,
                          JaxConfig(deriv_mode="fd", **XLA, **kw), dt,
                          jnp.asarray(x0), jnp.asarray(u0))
    got = solve_batch_fused(get_model(name), tp,
                            SolverConfig(deriv_mode="fd", **kw), dt, x0, u0,
                            device="cpu")
    return ref, got


def test_pendulum_fd_solve_matches_jax_xla():
    """pendulum, fd, Euler, on the inputs and under the bounds of the JAX
    package's tests/test_fused_solver.py:486-506 (x0 from default_rng(6),
    T = 10, clamped rollout, max_iter 6): costs to rtol 1e-3, controls
    within 0.05 (eps = 1e-3 stencils sit at the edge of f32 precision, so
    the two operation orders give different noise). Measured: costs 7.9e-8
    apart (relative), controls 2.4e-2."""
    rng = np.random.default_rng(6)
    x0 = (rng.normal(size=(2, 2)) * 0.2).astype(np.float32)
    u0 = np.zeros((10, 1), np.float32)
    ref, got = _solve_both("pendulum", x0, u0, 0.05, clamp_forward=True,
                           max_iter=6)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-3)
    assert np.abs(got.us.numpy() - np.asarray(ref.us)).max() < 0.05


@pytest.mark.parametrize("eps", [1e-3, 0.05])
def test_acrobot_rk4_fd_solve_matches_jax_xla(eps):
    """acrobot, fd with ``eps``, RK4, the CLI's unclamped rollout, at a
    short horizon (T = 12, 4 lanes of 0.05·normal, max_iter 5): costs to
    rtol 1e-3 and equal iteration counts; at eps = 0.05 also the controls
    within 0.05. At the default eps the f32 stencils' noise (an ulp of a
    final cost of ~4e3 over 4·eps² = 4e-6 moves cxx by ~60) flips
    saturated controls between the two implementations (measured 0.33, the
    costs 2.1e-5 apart). Measured at eps = 0.05: costs 1.2e-7, controls
    2.7e-2."""
    rng = np.random.default_rng(0)
    x0 = (0.05 * rng.normal(size=(4, 4))).astype(np.float32)
    u0 = np.zeros((12, 1), np.float32)
    ref, got = _solve_both("acrobot", x0, u0, 0.02, integrator="rk4",
                           max_iter=5, alphas=(1.0, 0.3, 0.03), fd_eps=eps)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-3)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    if eps == 0.05:
        assert np.abs(got.us.numpy() - np.asarray(ref.us)).max() < 0.05


def test_omni_thruster_fd_solve_matches_jax_xla():
    """omni_thruster (m = 6, projected Newton over the dense stencil
    Hessians), fd, Euler, against the JAX XLA path with
    boxqp_mode="pn_fixed", in the style of tests/test_torch_fused_wide.py
    (x0 0.2·normal from default_rng(5), hover u0, T = 8, B = 2,
    max_iter = 4, dt 0.05, clamped rollout), with fd_eps = 0.05: costs to
    rtol 1e-3, controls within 2e-2 and inside the box. Measured: costs
    7.5e-6, controls 8.1e-3. At the default eps the two f32 solves part by
    11% in cost over the 4 iterations (port 776.4148 / 806.7881, JAX
    876.9186 / 767.28125): the stencils' noise on costs of ~800 (an ulp of
    6e-5 over 4·eps² = 4e-6 moves cxx by ~15) decides the projected
    Newton's active sets (ROADMAP.md §C)."""
    from ilqr_tpu.models import omni_thruster as jot

    jp, tp = _params("omni_thruster")
    x0 = (0.2 * np.random.default_rng(5).normal(size=(2, 6))
          ).astype(np.float32)
    u0 = np.tile(np.asarray(jot.hover_control(jp))[None], (8, 1)).astype(
        np.float32)
    ref, got = _solve_both("omni_thruster", x0, u0, 0.05,
                           boxqp_mode="pn_fixed", clamp_forward=True,
                           max_iter=4, alphas=(1.0, 0.3, 0.03), fd_eps=0.05)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-3)
    us = got.us.numpy()
    assert np.abs(us - np.asarray(ref.us)).max() < 2e-2
    assert us.min() >= float(tp.u_min.min()) - 1e-6
    assert us.max() <= float(tp.u_max.max()) + 1e-6
