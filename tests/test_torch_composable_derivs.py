"""The derivative stage of the m ≥ 2 models (``kernel_derivs.derivs_plain``,
the plain version of csrc/derivs.cuh, which the composable solver runs on
the CPU) against the JAX package.

- Against ``pallas_derivs.derivs_batched`` in Pallas interpret mode (one
  lane block, T = 4): the double integrator (m = 2; jvp with Euler, fd
  with RK4); bicycle (``tan`` steering) and power_mass (the live cxu,
  full cxx and cuu) in jvp and fd mode, Euler and RK4 between them; and
  per-lane params (one row of params per lane, every leaf drawn per lane)
  on a (1, 8, 128) tile for the double integrator and power_mass.
- The other eight models (point_mass_3d, the quadrotor, omni_thruster,
  free_flyer and the four rings, m = 3…24, the dense cuu and cxu pairs up
  to 24 × 24 and 6 × 24) against the JAX package's XLA derivative routes,
  ``analytic_derivs`` (autodiff) for jvp mode and ``fd_derivs`` (the
  reference's stencils) for fd mode, vmapped: their interpret-mode kernel
  takes 25-130 s per case at the quadrotor's n = 12 on XLA:CPU (measured
  69.1-131.3 s) and longer at m = 24, past this file's budget.

Bounds are those of tests/test_torch_split_models.py (and
test_torch_jvp_rk4.py / test_torch_fd_rk4.py): jvp mode atol 1e-4 (the
same dual-number rules in the same order against the kernel; against
autodiff, max |a − b| / (1 + |b|) ≤ 1e-4), fd mode (eps = 0.05) FD_ULPS
ulps of the largest value each stencil differences over its denominator
(an ulp of f that XLA and PyTorch round differently, FMA included, becomes
ulp(f)/(2·eps) in a gradient and ulp(f)/(4·eps²) in a Hessian; ROADMAP.md
§C).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu import get_model as jax_get_model
from ilqr_tpu.ops import derivatives as jax_derivatives
from ilqr_tpu.ops import pallas_derivs, pallas_rollout
from ilqr_tpu_torch import get_model
from ilqr_tpu_torch.ops import kernel_derivs, kernel_rollout
from ilqr_tpu_torch.ops import launch_counts, reset_launch_counts

B, T, DT, EPS = 3, 4, 0.05, 0.05
JVP_ATOL = 1e-4
FD_ULPS = 8
NAMES = ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu")


def _jparams(name):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jax_get_model(name).default_params())


def _tparams(name, jp):
    module = "thruster_ring" if name.startswith("thruster_ring") else name
    return importlib.import_module(
        f"ilqr_tpu_torch.models.{module}").params_from_numpy(jp)


def _inputs(name, seed, lanes=B, t=T):
    model = get_model(name)
    rng = np.random.default_rng(seed)
    xs = (0.5 * rng.normal(size=(lanes, t + 1, model.n))).astype(np.float32)
    us = rng.normal(size=(lanes, t, model.m)).astype(np.float32)
    return xs, us


def _fd_tolerances(model, pp, xs, us):
    """FD_ULPS ulps of the largest function value each stencil differences
    over its denominator (running rows, then the terminal row of cx/cxx):
    xs (B, T+1, n), us (B, T, m) batch-major."""
    p, _dt = kernel_rollout.unpack_params(pp)
    x = torch.from_numpy(xs).permute(2, 1, 0)            # (n, T+1, B)
    u = torch.from_numpy(us).permute(2, 1, 0)
    run = model.cost_soa(p, list(x[:, :-1]), list(u)).abs().max().item()
    fin = model.final_cost_soa(p, list(x[:, -1])).abs().max().item()
    step = np.abs(xs).max() + 1.0
    ulp = lambda f: FD_ULPS * float(np.spacing(np.float32(f)))
    g, h = 2.0 * EPS, 4.0 * EPS * EPS
    return {"fx": ulp(step) / g, "fu": ulp(step) / g,
            "cx": (ulp(run) / g, ulp(fin) / g), "cu": ulp(run) / g,
            "cxx": (ulp(run) / h, ulp(fin) / h), "cxu": ulp(run) / h,
            "cuu": ulp(run) / h}


def _compare(got, want, mode, tols, rel=False):
    """got/want batch-major (B, T', …): jvp to JVP_ATOL (relative to
    1 + |want| with ``rel``), fd to the stencil tolerances, the time axis
    second."""
    for what, g, w in zip(NAMES, got, want):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, g.shape, w.shape)
        if mode == "jvp":
            err = np.abs(g - w) / ((1.0 + np.abs(w)) if rel else 1.0)
            assert err.max() <= JVP_ATOL, (what, float(err.max()))
            continue
        tol = tols[what]
        if isinstance(tol, tuple):
            np.testing.assert_allclose(g[:, :-1], w[:, :-1], rtol=0,
                                       atol=tol[0], err_msg=what)
            np.testing.assert_allclose(g[:, -1], w[:, -1], rtol=0,
                                       atol=tol[1], err_msg=what)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("name,integrator,mode", [
    ("double_integrator", "euler", "jvp"), ("double_integrator", "rk4", "fd"),
    ("bicycle", "euler", "jvp"), ("bicycle", "rk4", "fd"),
    ("power_mass", "rk4", "jvp"), ("power_mass", "euler", "fd")])
def test_derivs_plain_matches_pallas(name, integrator, mode):
    jp = _jparams(name)
    model = get_model(name)
    pp = kernel_rollout.pack_params(_tparams(name, jp), DT)
    xs, us = _inputs(name, 3)
    want = pallas_derivs.derivs_batched(
        jax_get_model(name), integrator,
        jax.tree_util.tree_map(jnp.asarray, jp), DT, jnp.asarray(xs),
        jnp.asarray(us), mode=mode, eps=EPS, interpret=True)
    reset_launch_counts()
    got = kernel_derivs.derivs_batched(model, integrator, pp,
                                       torch.from_numpy(xs),
                                       torch.from_numpy(us), mode, EPS)
    assert launch_counts()["derivs_packed"] == 0
    _compare(got, want, mode, _fd_tolerances(model, pp, xs, us))
    if name == "power_mass":   # the live cxu is exercised
        assert np.abs(got[5].numpy()).max() > 1e-2


@pytest.mark.slow
@pytest.mark.parametrize("name,integrator,mode", [
    ("point_mass_3d", "rk4", "jvp"), ("omni_thruster", "euler", "fd"),
    ("free_flyer", "euler", "jvp"), ("thruster_ring", "rk4", "fd"),
    ("quadrotor", "euler", "jvp")])
def test_derivs_plain_matches_pallas_wide(name, integrator, mode):
    """The wider models against the JAX kernel in interpret mode too
    (15-130 s per case on XLA:CPU; the tier-1 run holds them against the
    JAX XLA routes below)."""
    test_derivs_plain_matches_pallas(name, integrator, mode)


TILE = 1024   # one (1, 8, 128) lane tile of the JAX kernel


@pytest.mark.parametrize("name,mode", [("double_integrator", "jvp"),
                                       ("power_mass", "fd")])
def test_derivs_per_lane_params_match_pallas(name, mode):
    """One row of params per lane: every leaf of the defaults × U(0.8,
    1.2) per lane (goals, weights, physics and the box)."""
    base = _jparams(name)
    rng = np.random.default_rng(7)
    jp = type(base)(**{
        f: (np.asarray(getattr(base, f))[None] * rng.uniform(
            0.8, 1.2, size=(TILE,) + np.shape(getattr(base, f)))
            ).astype(np.float32) for f in base._fields})
    jpack = pallas_rollout.pack_params_batched(
        jax.tree_util.tree_map(jnp.asarray, jp), DT, 1)
    tpack = kernel_rollout.pack_params_batched(_tparams(name, jp), DT)
    model = get_model(name)
    t = 3
    xs, us = _inputs(name, 8, lanes=TILE, t=t)
    lane_last = lambda a: np.ascontiguousarray(np.moveaxis(a, 0, -1))
    tile = lambda a: jnp.asarray(a.reshape(a.shape[:-1] + (1, 8, 128)))
    want = pallas_derivs.derivs_packed(
        jax_get_model(name), "euler", jpack, tile(lane_last(xs)),
        tile(lane_last(us)), mode=mode, eps=EPS, interpret=True)
    got = kernel_derivs.derivs_packed(
        model, "euler", tpack, torch.from_numpy(lane_last(xs)),
        torch.from_numpy(lane_last(us)), mode=mode, eps=EPS)
    back = lambda a: np.moveaxis(np.asarray(a).reshape(
        np.shape(a)[:-3] + (TILE,)), -1, 0)
    _compare([np.moveaxis(g.numpy(), -1, 0) for g in got],
             [back(w) for w in want], mode,
             _fd_tolerances(model, tpack, xs, us))
    # the lanes' own params matter: lane 0 alone with shared params agrees
    lane0 = type(base)(**{f: getattr(jp, f)[0] for f in base._fields})
    one = kernel_derivs.derivs_packed(
        model, "euler", kernel_rollout.pack_params(_tparams(name, lane0), DT),
        torch.from_numpy(lane_last(xs)[..., :1].copy()),
        torch.from_numpy(lane_last(us)[..., :1].copy()), mode=mode, eps=EPS)
    for g, o in zip(got, one):
        np.testing.assert_array_equal(g.numpy()[..., :1], o.numpy())


XLA_CASES = [("point_mass_3d", "jvp", "rk4"), ("point_mass_3d", "fd", "euler"),
             ("quadrotor", "jvp", "euler"), ("quadrotor", "fd", "rk4"),
             ("omni_thruster", "jvp", "rk4"), ("omni_thruster", "fd", "euler"),
             ("free_flyer", "jvp", "euler"), ("free_flyer", "fd", "rk4"),
             ("thruster_ring", "jvp", "euler"), ("thruster_ring", "fd", "euler"),
             ("thruster_ring16", "jvp", "rk4"), ("thruster_ring20", "fd", "euler"),
             ("thruster_ring24", "jvp", "euler"), ("thruster_ring24", "fd", "rk4")]


@pytest.mark.parametrize("name,mode,integrator", XLA_CASES)
def test_derivs_plain_matches_jax_xla(name, mode, integrator):
    jp = _jparams(name)
    model = get_model(name)
    pp = kernel_rollout.pack_params(_tparams(name, jp), DT)
    xs, us = _inputs(name, 11, t=3)
    jm = jax_get_model(name)
    cfg = JaxConfig(integrator=integrator, fd_eps=EPS)
    impl = (jax_derivatives.analytic_derivs if mode == "jvp"
            else jax_derivatives.fd_derivs)
    want = jax.vmap(lambda x, u: impl(
        jm, jax.tree_util.tree_map(jnp.asarray, jp), cfg, DT, x, u))(
            jnp.asarray(xs), jnp.asarray(us))
    got = kernel_derivs.derivs_batched(model, integrator, pp,
                                       torch.from_numpy(xs),
                                       torch.from_numpy(us), mode, EPS)
    _compare(got, [want.fx, want.fu, want.cx, want.cu, want.cxx, want.cxu,
                   want.cuu], mode, _fd_tolerances(model, pp, xs, us),
             rel=True)
