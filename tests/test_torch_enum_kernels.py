"""The plain versions of the merged sweep and the whole-iteration kernel at
m = 2 (double integrator) and m = 3 (3-D point mass), with the enumeration
box QP and with the unconstrained Newton step, against ilqr_tpu's Pallas
kernels in interpret mode.

One 1024-lane block, T = 30, a time block of 1 (the interpret-mode compile
grows with the block; the edge-row masking of blocks that do not divide T
is exercised at m = 1 by tests/test_torch_kernels.py). Inputs are drawn
with numpy and handed to both sides in the lane-last layout; the
trajectory comes from a clamped open-loop rollout from states far enough
from the goal that the ±0.5 box binds; λ is 1 on most lanes, 1e-3 on some
and −100 on 1/8 (QuuF indefinite: the divergence latch fires).

Tolerance: max |a − b| / (1 + |b|) ≤ 1e-5 (dcost against the costs it is
a difference of); the divergence flag, the accepted flag and the chosen α
exactly. These models have no trig, so both sides run the same IEEE f32
operations and agree to an ulp or better.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import get_model as jax_get_model
from ilqr_tpu.models import double_integrator as jdi
from ilqr_tpu.models import point_mass_3d as jpm
from ilqr_tpu.ops import pallas_iter, pallas_rollout, pallas_sweep
from ilqr_tpu_torch import get_model
from ilqr_tpu_torch.models import double_integrator as tdi
from ilqr_tpu_torch.models import point_mass_3d as tpm
from ilqr_tpu_torch.ops import kernel_iter, kernel_rollout, kernel_sweep

B, T, TB, DT = 1024, 30, 1, 0.02
ALPHAS = np.asarray([1.0, 0.5, 0.1], np.float32)
TOL = 1e-5
MODS = {"double_integrator": (jdi, tdi), "point_mass_3d": (jpm, tpm)}


def _setup(name, seed):
    jmod, tmod = MODS[name]
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                jmod.default_params())
    jpack = pallas_rollout.pack_params(
        jax.tree_util.tree_map(jnp.asarray, jp), DT)
    tpack = kernel_rollout.pack_params(tmod.params_from_numpy(jp), DT)
    tm = get_model(name)
    n, m = tm.n, tm.m
    rng = np.random.default_rng(seed)
    x0 = (2.0 * rng.normal(size=(n, B))).astype(np.float32)
    us = (0.6 * rng.normal(size=(T, m, B))).astype(np.float32)
    z = lambda *s: torch.zeros(s)
    xs, us_c, xT, cost = kernel_rollout.rollout_plain(
        tm, "euler", True, tpack, torch.from_numpy(x0), torch.from_numpy(us),
        z(T, n, B), z(T, m, n, B))
    lam = np.ones(B, np.float32)
    lam[rng.uniform(size=B) < 0.25] = 1e-3
    lam[rng.uniform(size=B) < 0.125] = -100.0
    return dict(jm=jax_get_model(name), tm=tm, n=n, m=m, jpack=jpack,
                tpack=tpack, x0=x0, xs=xs.numpy(), us=us_c.numpy(),
                xT=xT.numpy(), cost=cost.numpy(), lam=lam, rng=rng)


def _jp(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a.reshape(a.shape[:-1] + (1, 8, 128)))


def _tp(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _unj(y):
    y = np.asarray(y)
    return y.reshape(y.shape[:-3] + (B,))


def _close(got, want, what, scale=None):
    got = got.numpy()
    scale = want if scale is None else scale
    assert got.shape == want.shape, what
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok]) / (1.0 + np.abs(scale[ok]))
    assert err.max(initial=0.0) <= TOL, (what, float(err.max()))


@pytest.mark.parametrize("name,use_limits", [
    ("double_integrator", True), ("point_mass_3d", False)])
def test_sweep_matches_jax(name, use_limits):
    s = _setup(name, 21)
    want = pallas_sweep.sweep_packed(
        s["jm"], "euler", s["jpack"], _jp(s["xs"]), _jp(s["xT"]),
        _jp(s["us"]), _jp(s["lam"]), mode="jvp", interpret=True,
        use_limits=use_limits, time_block=TB)
    got = kernel_sweep.sweep_packed(
        s["tm"], "euler", s["tpack"], _tp(s["xs"]), _tp(s["xT"]),
        _tp(s["us"]), _tp(s["lam"]), use_limits=use_limits)
    for g, w, what in zip(got, want, ("k", "K", "dv", "diverged", "gnorm")):
        _close(g, _unj(w), what)
    div = got[3].numpy()
    np.testing.assert_array_equal(div, _unj(want[3]))
    lam = s["lam"]
    assert div[lam < 0].min() == 1.0 and div[lam > 0].max() == 0.0
    if use_limits:   # some controls end on the box, some inside it
        u_new = s["us"] + got[0].numpy()
        on_box = np.isclose(np.abs(u_new), 0.5)
        assert on_box[:, :, lam > 0].any() and (~on_box).any()


@pytest.mark.parametrize("name,use_limits", [
    ("double_integrator", False), ("point_mass_3d", True)])
def test_iteration_matches_jax(name, use_limits):
    s = _setup(name, 22)
    rng, n, m = s["rng"], s["n"], s["m"]
    kold = rng.normal(size=(T, m, B)).astype(np.float32)
    Kold = rng.normal(size=(T, m, n, B)).astype(np.float32)
    live = (rng.uniform(size=B) > 0.3).astype(np.float32)
    # previous costs spread around the current ones so that some lanes
    # accept a step and some do not
    cprev = (s["cost"] * rng.uniform(0.5, 1.5, size=B)).astype(np.float32)
    want = pallas_iter.iteration_packed(
        s["jm"], "euler", True, s["jpack"], _jp(s["x0"]), _jp(s["xs"]),
        _jp(s["xT"]), _jp(s["us"]), _jp(kold), _jp(Kold), _jp(s["lam"]),
        _jp(cprev), _jp(live), jnp.asarray(ALPHAS), mode="jvp",
        use_limits=use_limits, z_min=0.0, tol_grad=1e-6,
        lambda_grad_term=1e-5, interpret=True, time_block=TB)
    got = kernel_iter.iteration_packed(
        s["tm"], "euler", True, s["tpack"], _tp(s["x0"]), _tp(s["xs"]),
        _tp(s["xT"]), _tp(s["us"]), _tp(kold), _tp(Kold), _tp(s["lam"]),
        _tp(cprev), _tp(live), _tp(ALPHAS), mode="jvp",
        use_limits=use_limits, z_min=0.0, tol_grad=1e-6,
        lambda_grad_term=1e-5)
    names = ("xs", "us", "x_final", "k_keep", "K_keep", "ls_cost",
             "alpha_sel", "accepted", "dcost", "expected", "diverged",
             "gnorm")
    assert len(got) == len(want) == 12
    for g, w, what in zip(got, want, names):
        _close(g, _unj(w), what, scale=cprev if what == "dcost" else None)
    for i in (6, 7, 10):   # α, accepted and diverged are exact
        np.testing.assert_array_equal(got[i].numpy(), _unj(want[i]))
    acc, div = got[7].numpy(), got[10].numpy()
    take = (acc > 0.5) & (div < 0.5) & (live > 0.5)
    assert take.any() and (~take).any()
    np.testing.assert_array_equal(got[0].numpy()[..., ~take],
                                  s["xs"][..., ~take])
