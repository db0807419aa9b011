"""Per-problem params (``params_batched=True``) in ilqr_tpu_torch against
the JAX package, on the CPU.

- ``kernel_rollout.pack_params_batched`` against
  ``pallas_rollout.pack_params_batched``: lane b's row holds the values of
  the JAX tile's lane b, dt shared (exact).
- The five ops with one params row per lane (their plain versions on the
  CPU) against the JAX kernels in Pallas interpret mode with a
  (P, 1, 8, 128) params tile: one 1024-lane block of pendulum problems,
  T = 7 in time blocks of 3, every params leaf drawn per lane (goals,
  masses, weights, an asymmetric box per lane that binds on some lanes),
  to tests/test_torch_kernels.py's 1e-4 (max |a − b| / (1 + |b|)); the
  derivative op in fd mode to tests/test_torch_split_models.py's stencil
  gauge (8 ulps of the differenced values over the stencil's denominator).
- Rows equal across the lanes give exactly the shared params' outputs, op
  by op and for whole solves on every route.
- Whole solves against the JAX package's XLA ``solve_batch(...,
  params_batched=True)`` on tests/test_fused_batched_params.py's inputs:
  pendulum goals (costs to that test's 1e-2, and equal to per-goal solves
  with shared params), the m = 2 double integrator (its 1e-3 on costs and
  1e-4 on controls), and free_flyer with per-craft thrust ceilings (T = 8,
  B = 2, max_iter = 4, ``boxqp_mode="pn_fixed"`` as in
  tests/test_torch_fused_wide.py: costs rtol 1e-3, controls 2e-2).

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu import get_model as jax_get_model
from ilqr_tpu.batch import solve_batch as jax_solve_batch
from ilqr_tpu.ops import pallas_derivs, pallas_iter, pallas_rollout
from ilqr_tpu.ops import pallas_sweep
from ilqr_tpu_torch import SolverConfig, get_model, solve_batch_fused
from ilqr_tpu_torch.ops import (
    kernel_derivs,
    kernel_iter,
    kernel_rollout,
    kernel_sweep,
    launch_counts,
    reset_launch_counts,
)

B, T, TB, DT = 1024, 7, 3, 0.05
ALPHAS = np.asarray([1.0, 0.5, 0.1], np.float32)
FAST_ALPHAS = (1.0, 0.3, 0.03)
TOL = 1e-4
FD_EPS, FD_ULPS = 0.05, 8
NAME = "pendulum"


def _port_module(name):
    return importlib.import_module(f"ilqr_tpu_torch.models.{name}")


def _jax_default(name, **kw):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jax_get_model(name).default_params(**kw))


def _per_lane(name, lanes, seed):
    """Every leaf of ``name``'s default params drawn per lane (× U(0.8,
    1.2)), numpy (lanes, *shape)."""
    base = _jax_default(name)
    rng = np.random.default_rng(seed)
    return type(base)(**{
        f: (np.asarray(getattr(base, f))[None]
            * rng.uniform(0.8, 1.2, size=(lanes,)
                          + np.shape(getattr(base, f)))).astype(np.float32)
        for f in base._fields})


def _pendulum_lanes(seed=0):
    """Pendulum problems with their own goals, physics, weights and an
    asymmetric box each (numpy leaves (B, …))."""
    p = _per_lane(NAME, B, seed)
    rng = np.random.default_rng(seed + 1)
    goal = np.stack([rng.uniform(-3.2, 3.2, B), rng.uniform(-0.5, 0.5, B)],
                    axis=1)
    return p._replace(
        goal=goal.astype(np.float32),
        u_min=-rng.uniform(0.5, 3.0, (B, 1)).astype(np.float32),
        u_max=rng.uniform(0.5, 3.0, (B, 1)).astype(np.float32))


def _packs(jp):
    """(JAX packed params, port packed params) of per-lane numpy params."""
    jpack = pallas_rollout.pack_params_batched(
        jax.tree_util.tree_map(jnp.asarray, jp), DT, 1)
    tpack = kernel_rollout.pack_params_batched(
        _port_module(NAME).params_from_numpy(jp), DT)
    return jpack, tpack


def _jp(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a.reshape(a.shape[:-1] + (1, 8, 128)))


def _tp(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _unj(y):
    y = np.asarray(y)
    return y.reshape(y.shape[:-3] + (B,))


def _assert_close(got, want, what, tol=TOL, scale=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = want if scale is None else np.broadcast_to(scale, want.shape)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok]) / (1.0 + np.abs(scale[ok]))
    assert err.max(initial=0.0) <= tol, (what, float(err.max()))


def _model():
    return get_model(NAME)


def _trajectory(tpack, rng):
    """A consistent clamped open-loop rollout under the per-lane params."""
    x0 = (0.5 * rng.normal(size=(2, B))).astype(np.float32)
    us = (2.0 * rng.normal(size=(T, 1, B))).astype(np.float32)
    xs, us_c, xT, cost = kernel_rollout.rollout_plain(
        _model(), "euler", True, tpack, _tp(x0), _tp(us),
        torch.zeros(T, 2, B), torch.zeros(T, 1, 2, B))
    return x0, us_c.numpy(), xs.numpy(), xT.numpy(), cost.numpy()


# ---------------------------------------------------------------------------
# the packing

@pytest.mark.parametrize("name", ["pendulum", "acrobot", "double_integrator",
                                  "free_flyer", "thruster_ring"])
def test_pack_params_batched_matches_jax(name):
    jp = _per_lane(name, B, 3)
    arr, _treedef, shapes = pallas_rollout.pack_params_batched(
        jax.tree_util.tree_map(jnp.asarray, jp), DT, 1)
    pp = kernel_rollout.pack_params_batched(
        _port_module(name).params_from_numpy(jp), DT)
    P = arr.shape[0]
    assert pp.vec.shape == (B, P) and kernel_rollout.is_batched(pp)
    assert kernel_rollout.param_stride(pp) == P
    assert pp.shapes == tuple(tuple(s) for s in shapes)
    np.testing.assert_array_equal(pp.vec.numpy().T,
                                  np.asarray(arr).reshape(P, B))
    # unpacked leaves are lane-last, each lane its own problem's; dt 0-d
    p, dt = kernel_rollout.unpack_params(pp)
    for f in jp._fields:
        leaf = np.asarray(getattr(jp, f))
        np.testing.assert_array_equal(
            getattr(p, f).numpy(), np.moveaxis(leaf, 0, -1))
    assert dt.shape == () and float(dt) == np.float32(DT)
    # the shared packing is the same layout with stride 0
    shared = kernel_rollout.pack_params(
        _port_module(name).params_from_numpy(_jax_default(name)), DT)
    assert shared.vec.shape == (P,) and shared.shapes == pp.shapes
    assert kernel_rollout.param_stride(shared) == 0


def test_pack_params_batched_rejects_ragged_leaves():
    jp = _per_lane(NAME, 4, 0)
    bad = jp._replace(goal=jp.goal[:3])
    with pytest.raises(ValueError, match="leading batch axis"):
        kernel_rollout.pack_params_batched(
            _port_module(NAME).params_from_numpy(bad), DT)


# ---------------------------------------------------------------------------
# the five ops with one params row per lane, against the JAX kernels

def test_rollout_per_lane_matches_jax():
    rng = np.random.default_rng(10)
    jpack, tpack = _packs(_pendulum_lanes(10))
    x0 = (0.5 * rng.normal(size=(2, B))).astype(np.float32)
    uff = (3.0 * rng.normal(size=(T, 1, B))).astype(np.float32)
    xsr = (0.5 * rng.normal(size=(T, 2, B))).astype(np.float32)
    K = (0.5 * rng.normal(size=(T, 1, 2, B))).astype(np.float32)
    want = pallas_rollout.rollout_packed(
        jax_get_model(NAME), "euler", True, jpack, _jp(x0), _jp(uff),
        _jp(xsr), _jp(K), interpret=True)
    reset_launch_counts()
    got = kernel_rollout.rollout_packed(
        _model(), "euler", True, tpack, _tp(x0), _tp(uff), _tp(xsr), _tp(K))
    assert launch_counts()["rollout_packed"] == 0
    for g, w, what in zip(got, want, ("xs", "us", "x_final", "cost")):
        _assert_close(g, _unj(w), what)
    # each lane clamps to its own box, and both bounds bind somewhere
    us = got[1].numpy()
    lo = tpack.vec[:, 11].numpy()
    hi = tpack.vec[:, 12].numpy()
    assert np.all(us >= lo - 1e-6) and np.all(us <= hi + 1e-6)
    assert np.any(us == lo) and np.any(us == hi)


def test_sweep_per_lane_matches_jax():
    rng = np.random.default_rng(11)
    jpack, tpack = _packs(_pendulum_lanes(11))
    _x0, us, xs, xT, _c = _trajectory(tpack, rng)
    lam = np.where(rng.uniform(size=B) < 0.25, 1e-3, 1.0).astype(np.float32)
    want = pallas_sweep.sweep_packed(
        jax_get_model(NAME), "euler", jpack, _jp(xs), _jp(xT), _jp(us),
        _jp(lam), mode="jvp", interpret=True, use_limits=True,
        time_block=TB)
    got = kernel_sweep.sweep_packed(
        _model(), "euler", tpack, _tp(xs), _tp(xT), _tp(us), _tp(lam))
    for g, w, what in zip(got, want, ("k", "K", "dv", "diverged", "gnorm")):
        _assert_close(g, _unj(w), what)
    # the per-lane boxes bind: some u + k sit on their own lane's bound
    uk = us[:, 0] + got[0].numpy()[:, 0]
    lo = tpack.vec[:, 11].numpy()
    hi = tpack.vec[:, 12].numpy()
    assert np.any(np.isclose(uk, lo)) and np.any(np.isclose(uk, hi))


def test_linesearch_per_lane_matches_jax():
    rng = np.random.default_rng(12)
    jpack, tpack = _packs(_pendulum_lanes(12))
    x0, us, xs, xT, cost0 = _trajectory(tpack, rng)
    k = (0.5 * rng.normal(size=(T, 1, B))).astype(np.float32)
    K = (0.1 * rng.normal(size=(T, 1, 2, B))).astype(np.float32)
    kold = rng.normal(size=(T, 1, B)).astype(np.float32)
    Kold = rng.normal(size=(T, 1, 2, B)).astype(np.float32)
    dv = np.stack([-np.abs(rng.normal(size=B)) * 5.0,
                   rng.normal(size=B) * 0.1]).astype(np.float32)
    cprev = (cost0 + rng.normal(size=B)).astype(np.float32)
    gate = (rng.uniform(size=B) > 0.5).astype(np.float32)
    keep = (rng.uniform(size=B) > 0.5).astype(np.float32)
    want = pallas_rollout.linesearch_packed(
        jax_get_model(NAME), "euler", True, jpack, _jp(x0), _jp(us), _jp(xs),
        _jp(xT), _jp(K), _jp(k), _jp(Kold), _jp(kold), jnp.asarray(ALPHAS),
        _jp(dv), _jp(cprev), _jp(gate), _jp(keep), 0.0, interpret=True,
        time_block=TB)
    got = kernel_rollout.linesearch_packed(
        _model(), "euler", True, tpack, _tp(x0), _tp(us), _tp(xs), _tp(xT),
        _tp(K), _tp(k), _tp(Kold), _tp(kold), _tp(ALPHAS), _tp(dv),
        _tp(cprev), _tp(gate), _tp(keep), 0.0)
    names = ("xs", "us", "x_final", "k_keep", "K_keep", "ls_cost",
             "alpha_sel", "accepted", "dcost", "expected")
    for g, w, what in zip(got, want, names):
        _assert_close(g, _unj(w), what,
                      scale=cprev if what == "dcost" else None)
    acc = got[7].numpy()
    np.testing.assert_array_equal(acc, _unj(want[7]))
    assert 0 < acc.sum() < B


def test_iteration_per_lane_matches_jax():
    rng = np.random.default_rng(13)
    jpack, tpack = _packs(_pendulum_lanes(13))
    x0, us, xs, xT, cost0 = _trajectory(tpack, rng)
    kold = rng.normal(size=(T, 1, B)).astype(np.float32)
    Kold = rng.normal(size=(T, 1, 2, B)).astype(np.float32)
    lam = np.where(rng.uniform(size=B) < 0.25, 1e-3, 1.0).astype(np.float32)
    live = (rng.uniform(size=B) > 0.25).astype(np.float32)
    cprev = (cost0 + rng.normal(size=B)).astype(np.float32)
    want = pallas_iter.iteration_packed(
        jax_get_model(NAME), "euler", True, jpack, _jp(x0), _jp(xs), _jp(xT),
        _jp(us), _jp(kold), _jp(Kold), _jp(lam), _jp(cprev), _jp(live),
        jnp.asarray(ALPHAS), mode="jvp", use_limits=True, z_min=0.0,
        tol_grad=1e-6, lambda_grad_term=1e-5, interpret=True, time_block=TB)
    got = kernel_iter.iteration_packed(
        _model(), "euler", True, tpack, _tp(x0), _tp(xs), _tp(xT), _tp(us),
        _tp(kold), _tp(Kold), _tp(lam), _tp(cprev), _tp(live), _tp(ALPHAS),
        mode="jvp", use_limits=True, z_min=0.0, tol_grad=1e-6,
        lambda_grad_term=1e-5)
    names = ("xs", "us", "x_final", "k_keep", "K_keep", "ls_cost",
             "alpha_sel", "accepted", "dcost", "expected", "diverged",
             "gnorm")
    for g, w, what in zip(got, want, names):
        _assert_close(g, _unj(w), what,
                      scale=cprev if what == "dcost" else None)
    acc = got[7].numpy()
    np.testing.assert_array_equal(acc, _unj(want[7]))
    assert 0 < acc.sum() < B


def _fd_tolerance(what, tp, xs, us):
    """tests/test_torch_split_models.py's stencil gauge: FD_ULPS ulps of the
    largest value a stencil differences, over its denominator (running
    rows; the terminal row of cx/cxx by the final cost's)."""
    m = _model()
    p, _dt = kernel_rollout.unpack_params(tp)
    x = torch.from_numpy(xs).permute(1, 0, 2)             # (n, T+1, B)
    u = torch.from_numpy(us).permute(1, 0, 2)
    run = m.cost_soa(p, x[:, :-1], u).abs().max().item()
    fin = m.final_cost_soa(p, x[:, -1]).abs().max().item()
    step = np.abs(xs).max() + 1.0
    ulp = lambda f: FD_ULPS * float(np.spacing(np.float32(f)))
    g, h = 2.0 * FD_EPS, 4.0 * FD_EPS * FD_EPS
    return {"fx": ulp(step) / g, "fu": ulp(step) / g,
            "cx": (ulp(run) / g, ulp(fin) / g), "cu": ulp(run) / g,
            "cxx": (ulp(run) / h, ulp(fin) / h), "cxu": ulp(run) / h,
            "cuu": ulp(run) / h}[what]


@pytest.mark.parametrize("mode", ["jvp", "fd"])
def test_derivs_per_lane_matches_jax(mode):
    rng = np.random.default_rng(14)
    jpack, tpack = _packs(_pendulum_lanes(14))
    xs = (0.5 * rng.normal(size=(T + 1, 2, B))).astype(np.float32)
    us = (2.0 * rng.normal(size=(T, 1, B))).astype(np.float32)
    want = pallas_derivs.derivs_packed(
        jax_get_model(NAME), "euler", jpack, _jp(xs), _jp(us), mode=mode,
        eps=FD_EPS, interpret=True)
    got = kernel_derivs.derivs_packed(_model(), "euler", tpack, _tp(xs),
                                      _tp(us), mode=mode, eps=FD_EPS)
    for what, g, w in zip(("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu"),
                          got, want):
        w = _unj(w)
        if mode == "jvp":
            _assert_close(g, w, what)
            continue
        tol = _fd_tolerance(what, tpack, xs, us)
        g = g.numpy().astype(np.float64)
        if isinstance(tol, tuple):   # running rows, then the terminal row
            np.testing.assert_allclose(g[:-1], w[:-1], rtol=0, atol=tol[0],
                                       err_msg=what)
            np.testing.assert_allclose(g[-1], w[-1], rtol=0, atol=tol[1],
                                       err_msg=what)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=what)
    # the per-lane goals reach the cost gradient: cx differs across lanes
    # that share a state
    assert np.unique(got[2][0, 0].numpy()).size > B // 2


# ---------------------------------------------------------------------------
# rows equal across the lanes: exactly the shared params' outputs

def _op_args(op, pp, rng, lanes=64):
    """Inputs of ``op`` on ``lanes`` pendulum lanes, and the op itself."""
    f = lambda *s: torch.as_tensor(0.5 * rng.normal(size=s),
                                   dtype=torch.float32)
    m = _model()
    x0, xs, xT, us = f(2, lanes), f(T, 2, lanes), f(2, lanes), f(T, 1, lanes)
    K, k = f(T, 1, 2, lanes), f(T, 1, lanes)
    lam = torch.ones(lanes)
    cprev = 100.0 + f(lanes)
    mask = (f(lanes) > 0).float()
    al = torch.as_tensor(ALPHAS)
    dv = torch.stack([-f(lanes).abs(), f(lanes)])
    return {
        "rollout": (kernel_rollout.rollout_packed,
                    (m, "rk4", True, pp, x0, us, xs, K)),
        "sweep": (kernel_sweep.sweep_packed,
                  (m, "euler", pp, xs, xT, us, lam, "fd", True)),
        "linesearch": (kernel_rollout.linesearch_packed,
                       (m, "euler", True, pp, x0, us, xs, xT, K, k, K, k, al,
                        dv, cprev, mask, mask, 0.0)),
        "iteration": (kernel_iter.iteration_packed,
                      (m, "rk4", True, pp, x0, xs, xT, us, k, K, lam, cprev,
                       mask, al, "jvp", True)),
        "derivs": (kernel_derivs.derivs_packed,
                   (m, "euler", pp, torch.cat([xs, xT[None]]), us, "jvp")),
    }[op]


@pytest.mark.parametrize("op", ["rollout", "sweep", "linesearch",
                                "iteration", "derivs"])
def test_identical_rows_equal_shared_op(op):
    base = _jax_default(NAME)
    lanes = 64
    rows = type(base)(**{f: np.repeat(np.asarray(getattr(base, f))[None],
                                      lanes, axis=0) for f in base._fields})
    mod = _port_module(NAME)
    shared = kernel_rollout.pack_params(mod.params_from_numpy(base), DT)
    batched = kernel_rollout.pack_params_batched(
        mod.params_from_numpy(rows), DT)
    fn, args = _op_args(op, shared, np.random.default_rng(20), lanes)
    _fn, bargs = _op_args(op, batched, np.random.default_rng(20), lanes)
    for a, b in zip(fn(*args), fn(*bargs)):
        torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# whole solves

ROUTES = {"whole-iteration": {}, "split iteration": dict(iter_kernel="split"),
          "split sweep": dict(sweep_kernel="split")}


def _stack_lanes(base, lanes, **per_lane):
    """numpy params with every leaf of ``base`` repeated on ``lanes`` lanes,
    then the fields of ``per_lane`` replaced."""
    rows = {f: np.repeat(np.asarray(getattr(base, f), np.float32)[None],
                         lanes, axis=0) for f in base._fields}
    rows.update({k: np.asarray(v, np.float32) for k, v in per_lane.items()})
    return type(base)(**rows)


def _lane(params, b):
    return type(params)(**{f: getattr(params, f)[b] for f in params._fields})


@functools.lru_cache(maxsize=None)
def _pendulum_goals_reference():
    """tests/test_fused_batched_params.py:37-64's problem through the JAX
    package's XLA solve_batch with per-problem params."""
    jp = _pendulum_goals_params()
    sol = jax_solve_batch(
        jax_get_model(NAME), jax.tree_util.tree_map(jnp.asarray, jp),
        JaxConfig(backward_kernel="xla", rollout_kernel="xla",
                  deriv_kernel="xla", **_pendulum_goals_cfg()), DT,
        jnp.zeros((3, 2), jnp.float32), jnp.zeros((25, 1), jnp.float32),
        params_batched=True)
    return np.asarray(sol.cost), np.asarray(sol.us)


def _pendulum_goals_params():
    goals = np.asarray([[3.14159, 0.0], [2.0, 0.0], [-2.5, 0.0]], np.float32)
    return _stack_lanes(_jax_default(NAME), 3, goal=goals,
                        u_min=np.full((3, 1), -8.0), u_max=np.full((3, 1), 8.0))


def _pendulum_goals_cfg():
    return dict(deriv_mode="analytic", clamp_forward=True, max_iter=8)


@pytest.mark.parametrize("route", list(ROUTES))
def test_batched_goals_match_jax_and_per_goal_solves(route):
    """Each lane reaches its own goal: costs within the JAX test's 1e-2 of
    the JAX package's batched solve, and equal to the port's solve of that
    goal alone with shared params."""
    jp = _pendulum_goals_params()
    mod = _port_module(NAME)
    cfg = SolverConfig(**_pendulum_goals_cfg(), **ROUTES[route])
    x0 = np.zeros((3, 2), np.float32)
    u0 = np.zeros((25, 1), np.float32)
    got = solve_batch_fused(_model(), mod.params_from_numpy(jp), cfg, DT, x0,
                            u0, device="cpu", params_batched=True)
    ref_cost, ref_us = _pendulum_goals_reference()
    assert np.abs(got.cost.numpy() - ref_cost).max() < 1e-2
    assert np.all(np.isfinite(got.cost.numpy()))
    for b in range(3):
        one = solve_batch_fused(_model(), mod.params_from_numpy(_lane(jp, b)),
                                cfg, DT, x0[b:b + 1], u0, device="cpu")
        np.testing.assert_array_equal(got.cost.numpy()[b], one.cost.numpy()[0])
        np.testing.assert_array_equal(got.us.numpy()[b], one.us.numpy()[0])
    # the goals differ, so the solutions do
    assert len(np.unique(got.cost.numpy())) == 3


@pytest.mark.parametrize("route", list(ROUTES))
def test_identical_batched_params_equal_shared(route):
    """tests/test_fused_batched_params.py:67-90: batched params equal across
    the batch give the shared-params solve, here bit for bit."""
    base = _jax_default(NAME)
    mod = _port_module(NAME)
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True, max_iter=4,
                       alphas=FAST_ALPHAS, **ROUTES[route])
    x0 = np.asarray([[0.3, 0.0], [-0.2, 0.1]], np.float32)
    u0 = np.zeros((8, 1), np.float32)
    shared = solve_batch_fused(_model(), mod.params_from_numpy(base), cfg, DT,
                               x0, u0, device="cpu")
    batched = solve_batch_fused(
        _model(), mod.params_from_numpy(_stack_lanes(base, 2)), cfg, DT, x0,
        u0, device="cpu", params_batched=True)
    for a, b in zip(shared, batched):
        np.testing.assert_array_equal(b.numpy(), a.numpy())


def test_batched_goals_m2_integrator():
    """tests/test_fused_batched_params.py:93-122 (m = 2): per-lane goals on
    the merged sweep's enumeration QP, against the JAX package's batched
    XLA solve (its 1e-3 on costs, 1e-4 on controls) and equal to the
    per-goal shared solves."""
    name = "double_integrator"
    base = _jax_default(name, goal=(1.0, 0.5, 0.0, 0.0))
    goals = np.asarray([[1.0, 0.5, 0.0, 0.0], [-0.5, 0.8, 0.0, 0.0]])
    jp = _stack_lanes(base, 2, goal=goals)
    kw = dict(deriv_mode="analytic", clamp_forward=True, max_iter=4,
              alphas=FAST_ALPHAS)
    x0 = np.asarray([[-1.0, 0.0, 0.0, -0.2], [0.3, -0.4, 0.0, 0.0]],
                    np.float32)
    u0 = np.zeros((8, 2), np.float32)
    ref = jax_solve_batch(
        jax_get_model(name), jax.tree_util.tree_map(jnp.asarray, jp),
        JaxConfig(backward_kernel="xla", rollout_kernel="xla",
                  deriv_kernel="xla", **kw), 0.02, jnp.asarray(x0),
        jnp.asarray(u0), params_batched=True)
    mod = _port_module(name)
    got = solve_batch_fused(get_model(name), mod.params_from_numpy(jp),
                            SolverConfig(**kw), 0.02, x0, u0, device="cpu",
                            params_batched=True)
    assert np.abs(got.cost.numpy() - np.asarray(ref.cost)).max() < 1e-3
    assert np.abs(got.us.numpy() - np.asarray(ref.us)).max() < 1e-4
    for b in range(2):
        one = solve_batch_fused(get_model(name),
                                mod.params_from_numpy(_lane(jp, b)),
                                SolverConfig(**kw), 0.02, x0[b:b + 1], u0,
                                device="cpu")
        np.testing.assert_array_equal(got.us.numpy()[b], one.us.numpy()[0])


def test_free_flyer_per_craft_thrust_ceilings():
    """examples/free_flyer_docking.py cut to T = 8, B = 2, max_iter = 4:
    per-craft goals and thrust ceilings on projected Newton, against the
    JAX package's batched XLA solve with boxqp_mode="pn_fixed" (costs rtol
    1e-3, controls 2e-2, tests/test_torch_fused_wide.py's bounds); every
    craft's thrust stays under its own ceiling, and the lower ceiling
    binds."""
    name, Tf, dt = "free_flyer", 8, 0.05
    base = _jax_default(name)
    goals = np.zeros((2, 6), np.float32)
    goals[:, :2] = [[2.0, 0.0], [0.0, -2.0]]
    fmax = np.asarray([2.5, 4.0], np.float32)
    jp = _stack_lanes(base, 2, goal=goals,
                      u_max=np.repeat(fmax[:, None], 8, axis=1))
    kw = dict(deriv_mode="analytic", clamp_forward=True, max_iter=4,
              alphas=FAST_ALPHAS)
    x0 = (0.2 * np.random.default_rng(0).normal(size=(2, 6))).astype(
        np.float32)
    u0 = np.zeros((Tf, 8), np.float32)
    ref = jax_solve_batch(
        jax_get_model(name), jax.tree_util.tree_map(jnp.asarray, jp),
        JaxConfig(backward_kernel="xla", rollout_kernel="xla",
                  deriv_kernel="xla", boxqp_mode="pn_fixed", **kw), dt,
        jnp.asarray(x0), jnp.asarray(u0), params_batched=True)
    got = solve_batch_fused(get_model(name),
                            _port_module(name).params_from_numpy(jp),
                            SolverConfig(**kw), dt, x0, u0, device="cpu",
                            params_batched=True)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-3)
    us = got.us.numpy()
    assert np.abs(us - np.asarray(ref.us)).max() < 2e-2
    peak = us.max(axis=(1, 2))
    assert np.all(peak <= fmax + 1e-6) and np.all(us >= -1e-6)
    assert np.isclose(peak[0], fmax[0]) and peak[1] > fmax[0]
