"""ilqr_tpu_torch's derivative stage against ilqr_tpu's.

- ``kernel_derivs.derivs_batched`` (on the CPU: the plain version of the
  derivative kernel) against ``pallas_derivs.derivs_batched`` in Pallas
  interpret mode, in both modes, terminal row included;
- ``ops.derivatives.analytic_derivs`` / ``fd_derivs`` (the "xla" route)
  against ``ilqr_tpu.ops.derivatives``'s, vmapped over the batch.

Inputs are drawn with numpy (B = 5 problems, T = 6) and handed to both
sides; params go through ``params_from_numpy``.

Tolerances. Forward mode: both sides run the same dual-number rules in the
same order, so only the libraries' sinf/cosf differ, by an ulp of the
dynamics (measured max |a − b| 4.5e-8 on fx): max |a − b| / (1 + |b|) ≤
1e-5. Stencils: an ulp of a function value f, which XLA and PyTorch may
round differently, becomes ulp(f)/(2 eps) in a gradient and ulp(f)/(4 eps²)
in a Hessian (≈ 1e2 for a final cost near 5e3 — the f32 stencil's own
noise, as the reference's eps = 1e-3 makes it). Each stencil output is held
to 8 such ulps of the largest f it differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu.models import acrobot as jac
from ilqr_tpu.ops import derivatives as jax_derivatives
from ilqr_tpu.ops import pallas_derivs
from ilqr_tpu_torch import SolverConfig
from ilqr_tpu_torch.models import acrobot as tac
from ilqr_tpu_torch.ops import derivatives, kernel_derivs, kernel_rollout
from ilqr_tpu_torch.ops import launch_counts, reset_launch_counts

B, T, N, M = 5, 6, 4, 1
DT, EPS = 0.02, 1e-3
JVP_TOL = 1e-5
FD_ULPS = 8
NAMES = ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu")


def _jparams():
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jac.default_params())


def _inputs(seed):
    rng = np.random.default_rng(seed)
    xs = (0.5 * rng.normal(size=(B, T + 1, N))).astype(np.float32)
    us = (2.0 * rng.normal(size=(B, T, M))).astype(np.float32)
    return xs, us


def _pp():
    return kernel_rollout.pack_params(tac.params_from_numpy(_jparams()), DT)


def _rel_close(got, want, what, tol=JVP_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max() <= tol, (what, float(err.max()))


def _fd_tolerances(xs, us):
    """Per-output absolute tolerance: FD_ULPS ulps of the largest function
    value each stencil differences, over its denominator."""
    p, _dt = kernel_rollout.unpack_params(_pp())
    x = torch.from_numpy(xs).permute(2, 0, 1)            # (n, B, T+1)
    u = torch.from_numpy(us).permute(2, 0, 1)
    run = tac.cost_soa(p, x[:, :, :-1], u).abs().max().item()
    fin = tac.final_cost_soa(p, x[:, :, -1]).abs().max().item()
    step = np.abs(xs).max() + 1.0
    ulp = lambda f: FD_ULPS * float(np.spacing(np.float32(f)))
    g, h = 2.0 * EPS, 4.0 * EPS * EPS
    return {"fx": ulp(step) / g, "fu": ulp(step) / g,
            "cx": (ulp(run) / g, ulp(fin) / g), "cu": ulp(run) / g,
            "cxx": (ulp(run) / h, ulp(fin) / h), "cxu": ulp(run) / h,
            "cuu": ulp(run) / h}


def _fd_close(got, want, what, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if isinstance(tol, tuple):       # running rows, then the terminal row
        np.testing.assert_allclose(got[:, :-1], want[:, :-1], rtol=0,
                                   atol=tol[0], err_msg=what)
        np.testing.assert_allclose(got[:, -1], want[:, -1], rtol=0,
                                   atol=tol[1], err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("mode", ["jvp", "fd"])
def test_derivs_plain_matches_pallas(mode):
    xs, us = _inputs(20)
    jp = jax.tree_util.tree_map(jnp.asarray, _jparams())
    want = pallas_derivs.derivs_batched(
        jac.MODEL, "euler", jp, DT, jnp.asarray(xs), jnp.asarray(us),
        mode=mode, eps=EPS, interpret=True)
    reset_launch_counts()
    got = kernel_derivs.derivs_batched(
        tac.MODEL, "euler", _pp(), torch.from_numpy(xs),
        torch.from_numpy(us), mode=mode, eps=EPS)
    assert launch_counts()["derivs_packed"] == 0
    tols = _fd_tolerances(xs, us)
    for name, g, w in zip(NAMES, got, want):
        if mode == "jvp":
            _rel_close(g, w, name)
        else:
            _fd_close(g, w, name, tols[name])
    if mode == "jvp":
        # the terminal row is the final cost's exact gradient and Hessian
        p, _dt = kernel_rollout.unpack_params(_pp())
        wts = np.array([20.0 ** 2] * 2 + [20.0 ** 2] * 2, np.float32)
        goal = p.goal.numpy()
        np.testing.assert_allclose(got[2][:, -1].numpy(),
                                   -2.0 * wts * (goal - xs[:, -1]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(
            got[4][:, -1].numpy(), np.broadcast_to(np.diag(2.0 * wts),
                                                   (B, N, N)))


@pytest.mark.parametrize("deriv_mode", ["analytic", "fd"])
def test_xla_route_matches_jax(deriv_mode):
    xs, us = _inputs(21)
    jp = jax.tree_util.tree_map(jnp.asarray, _jparams())
    jfn = (jax_derivatives.analytic_derivs if deriv_mode == "analytic"
           else jax_derivatives.fd_derivs)
    want = jax.vmap(lambda x, u: jfn(jac.MODEL, jp,
                                     JaxConfig(deriv_mode=deriv_mode), DT,
                                     x, u))(jnp.asarray(xs), jnp.asarray(us))
    cfg = SolverConfig(deriv_mode=deriv_mode, deriv_kernel="xla")
    got = derivatives.compute_derivs(tac.MODEL, _pp(), cfg,
                                     torch.from_numpy(xs),
                                     torch.from_numpy(us))
    tols = _fd_tolerances(xs, us)
    for name in NAMES:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if deriv_mode == "analytic":
            _rel_close(g, w, name)
        else:
            _fd_close(g, w, name, tols[name])


def test_compute_derivs_routes():
    """"auto" and "pallas" run the derivative op — its plain version on CPU
    tensors — in the mode deriv_mode names; "xla" runs torch.func. The two
    exact routes agree to the trig's ulp."""
    xs, us = (torch.from_numpy(a) for a in _inputs(22))
    pp = _pp()
    reset_launch_counts()
    for route in ("auto", "pallas"):
        for deriv_mode, mode in (("analytic", "jvp"), ("fd", "fd")):
            got = derivatives.compute_derivs(
                tac.MODEL, pp, SolverConfig(deriv_mode=deriv_mode,
                                            deriv_kernel=route), xs, us)
            want = kernel_derivs.derivs_batched(tac.MODEL, "euler", pp, xs,
                                                us, mode=mode, eps=EPS)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    assert launch_counts()["derivs_packed"] == 0
    xla = derivatives.compute_derivs(tac.MODEL, pp,
                                     SolverConfig(deriv_kernel="xla"), xs, us)
    auto = derivatives.compute_derivs(tac.MODEL, pp, SolverConfig(), xs, us)
    for name, g, w in zip(NAMES, xla, auto):
        _rel_close(g.numpy(), w.numpy(), name)
    with pytest.raises(ValueError, match="deriv_mode"):
        derivatives.compute_derivs(tac.MODEL, pp,
                                   SolverConfig(deriv_mode="bogus"), xs, us)
