"""ilqr_tpu_torch's box QPs (ops/boxqp.py) against ilqr_tpu's, vmapped.

The same problems, drawn with numpy from a seed, go through the JAX
functions under ``jax.vmap`` and the port's batched ones, in f32, at
m = 2, 3, 4, 6, 8 and 12: one batch per m of positive definite,
indefinite (a negative eigenvalue) and all-clamped (a gradient that
pushes every dim onto its bound) problems, 24 lanes of each.

Tolerances. The port runs JAX's operations in JAX's order; XLA:CPU's
dot products (fused multiply-adds, their own summation order) and LAPACK's
factorizations round the last bits otherwise. x, the chosen line-search
point and value, and the factors are held within 1e-5 relative
(|a − b| ≤ 1e-5·(1 + |b|)); the free set, the line-search failure flag
and step count, and the failure statuses (−1, 0) and 6 are equal. Once
the iterative QP has converged, its free gradient is f32 rounding noise
(~1e-7 against ``min_grad`` = 1e-8) and the next search's slope has a
random sign, so which of the converged statuses 2, 4 and 5 ends it, and
whether one more iteration runs, follows the last bits (22 of these 432
lanes, also with XLA's FMA off; ROADMAP.md §C): there both sides must
report one of them, with iteration counts within one. The backward pass
reads only x, the free set, the factor and status < 1. Where a QP stops
before it has fully converged (a relative improvement below 1.19e-6, or
projected Newton's fixed m + 6 iterations on a flat valley), those bits
also move x along the valley: up to 3.6e-4 on 3 of the 1 080 QP lanes
here, at the same status and count, with the value ½xᵀQx + cᵀx equal to
5.3e-8 relative. So x is held to 1e-5 on all but one lane in 24 and to
1e-3 on every lane, and the value to 1e-6 relative on every lane
(ROADMAP.md §C).
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from ilqr_tpu.config import BoxQPConfig as JaxBoxQPConfig
from ilqr_tpu_torch.config import BoxQPConfig
from ilqr_tpu_torch.ops import boxqp as tbq

# the module: ilqr_tpu.ops exports the function boxqp under the same name
jbq = importlib.import_module("ilqr_tpu.ops.boxqp")

X_TOL, X_TOL_ALL, VALUE_TOL = 1e-5, 1e-3, 1e-6
LANES = 24
MS = (2, 3, 4, 6, 8, 12)


def _problems(m, kind, seed):
    """LANES box QPs of ``kind``: Q (L, m, m), c, x0, lower, upper."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(LANES, m, m))
    Q = A @ A.transpose(0, 2, 1) / m + 0.1 * np.eye(m)
    if kind == "indefinite":   # every other lane
        v = rng.normal(size=(LANES, m, 1))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        top = np.linalg.eigvalsh(Q)[:, -1:, None]
        flip = (np.arange(LANES) % 2)[:, None, None]
        Q = Q - 3.0 * flip * top * (v @ v.transpose(0, 2, 1))
    Q = 0.5 * (Q + Q.transpose(0, 2, 1))
    # an asymmetric rounding, as the backward pass's QuuF has
    Q = Q + 1e-7 * rng.normal(size=Q.shape)
    c = rng.normal(size=(LANES, m))
    if kind == "clamped":
        c = 50.0 * np.sign(c)
    lower = -rng.uniform(0.2, 1.5, size=(LANES, m))
    upper = rng.uniform(0.2, 1.5, size=(LANES, m))
    x0 = rng.uniform(-2.0, 2.0, size=(LANES, m))
    f = lambda a: np.asarray(a, np.float32)
    return f(Q), f(c), f(x0), f(lower), f(upper)


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    both_nan = np.isnan(got) & np.isnan(want)
    err = np.where(both_nan, 0.0, np.abs(got - want) / (1.0 + np.abs(want)))
    return np.nan_to_num(err, nan=np.inf)


def _x_close(got, want, what):
    err = _rel_err(got, want)
    assert err.size == 0 or err.max() <= X_TOL, (what, float(err.max()))


def _qp_x_close(got, want, Q, c, what):
    """x per lane (see the module docstring), and the QP's value at it."""
    err = _rel_err(got, want).max(axis=-1)
    assert (err > X_TOL).sum() <= len(err) // 24, (what, np.sort(err)[-3:])
    assert err.max() <= X_TOL_ALL, (what, float(err.max()))
    q, cc = Q.astype(np.float64), c.astype(np.float64)
    value = lambda x: (0.5 * np.einsum("bi,bij,bj->b", x, q, x)
                       + (x * cc).sum(-1))
    vg = value(np.asarray(got, np.float64))
    vw = value(np.asarray(want, np.float64))
    ok = ~np.isnan(vw)
    assert (np.abs(vg - vw)[ok] <= VALUE_TOL * np.abs(vw)[ok]).all(), what


CONVERGED = (2, 4, 5)


def _check(got, want, what, Q, c):
    gs, ws = got.status.numpy(), np.asarray(want.status)
    conv = np.isin(ws, CONVERGED)
    np.testing.assert_array_equal(gs[~conv], ws[~conv], err_msg=what)
    assert np.isin(gs[conv], CONVERGED).all(), (what, gs, ws)
    np.testing.assert_array_equal(got.free.numpy(), np.asarray(want.free),
                                  err_msg=what)
    gi, wi = got.n_iters.numpy(), np.asarray(want.n_iters)
    np.testing.assert_array_equal(gi[gs == ws], wi[gs == ws], err_msg=what)
    assert (np.abs(gi - wi) <= 1).all(), (what, gi, wi)
    _qp_x_close(got.x.numpy(), want.x, Q, c, f"{what} x")
    ok = np.asarray(want.status) >= 1
    _x_close(got.chol_free.numpy()[ok], np.asarray(want.chol_free)[ok],
             f"{what} chol_free")


KINDS = ("pd", "indefinite", "clamped")


def _all_kinds(m, base):
    """The three kinds' problems of one m in one batch (3 × 24 lanes)."""
    parts = [_problems(m, kind, seed=base * m + i)
             for i, kind in enumerate(KINDS)]
    return tuple(np.concatenate(a) for a in zip(*parts))


@pytest.mark.parametrize("m", MS)
def test_boxqp_matches_jax(m):
    """The iterative projected Newton: iterates, status, free set and
    iteration count per lane."""
    Q, c, x0, lo, hi = _all_kinds(m, 10)
    want = jax.vmap(lambda *a: jbq.boxqp(*a, JaxBoxQPConfig()))(
        Q, c, x0, lo, hi)
    got = tbq.boxqp(*_torch(Q, c, x0, lo, hi), BoxQPConfig())
    _check(got, want, f"boxqp m={m}", Q, c)


@pytest.mark.parametrize("m", MS)
def test_boxqp_pn_matches_jax(m):
    Q, c, _x0, lo, hi = _all_kinds(m, 20)
    want = jax.vmap(jbq.boxqp_pn)(Q, c, lo, hi)
    got = tbq.boxqp_pn(*_torch(Q, c, lo, hi))
    _check(got, want, f"boxqp_pn m={m}", Q, c)


@pytest.mark.parametrize("m", (2, 3, 4))
def test_boxqp_enum_matches_jax(m):
    Q, c, _x0, lo, hi = _all_kinds(m, 30)
    want = jax.vmap(jbq.boxqp_enum)(Q, c, lo, hi)
    got = tbq.boxqp_enum(*_torch(Q, c, lo, hi))
    _check(got, want, f"boxqp_enum m={m}", Q, c)


@pytest.mark.parametrize("m", MS)
def test_quadclamp_line_search_matches_jax(m):
    """The backtracking on descent and non-descent directions: the chosen
    point, its value, the failure flag and the number of steps."""
    Q, c, x0, lo, hi = _problems(m, "pd", seed=40 + m)
    rng = np.random.default_rng(m)
    search = (rng.normal(size=x0.shape) * rng.uniform(
        0.01, 30.0, size=(LANES, 1))).astype(np.float32)
    cfg = JaxBoxQPConfig()
    want = jax.vmap(lambda *a: jbq.quadclamp_line_search(*a, cfg))(
        x0, search, Q, c, lo, hi)
    got = tbq.quadclamp_line_search(*_torch(x0, search, Q, c, lo, hi),
                                    BoxQPConfig())
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert np.asarray(want[2]).any() and not np.asarray(want[2]).all()
    _x_close(got[0].numpy(), want[0], "x")
    _x_close(got[1].numpy(), want[1], "v")


@pytest.mark.parametrize("m", MS)
def test_free_solve_and_masked_cholesky_match_jax(m):
    """The identity-padded factor of the free block and the solve on it,
    unrolled at m ≤ 4 and LAPACK's above, NaN where the free block is not
    positive definite."""
    Q, c, _x0, _lo, _hi = _problems(m, "indefinite", seed=50 + m)
    rng = np.random.default_rng(60 + m)
    free = rng.uniform(size=(LANES, m)) > 0.3
    wantL = jax.vmap(jbq.masked_cholesky)(Q, free)
    want = jax.vmap(jbq.free_solve)(wantL, c, free)
    gotL = tbq.masked_cholesky(*_torch(Q, free))
    got = tbq.free_solve(gotL, torch.from_numpy(c), torch.from_numpy(free))
    bad = np.isnan(np.asarray(wantL)).any(axis=(1, 2))
    np.testing.assert_array_equal(
        torch.isnan(gotL).any(dim=(1, 2)).numpy(), bad)
    assert bad.any() and not bad.all()
    _x_close(gotL.numpy()[~bad], np.asarray(wantL)[~bad], "L")
    _x_close(got.numpy()[~bad], np.asarray(want)[~bad], "z")


def test_small_factor_matches_jax():
    """The unrolled m ≤ 4 factor and substitution, NaN on a non-positive
    pivot."""
    for m in (1, 2, 3, 4):
        Q, c, _x0, _lo, _hi = _problems(m, "indefinite", seed=70 + m)
        wantL = jax.vmap(jbq._chol_small)(Q)
        gotL = tbq._chol_small(torch.from_numpy(Q))
        np.testing.assert_array_equal(np.isnan(gotL.numpy()),
                                      np.isnan(np.asarray(wantL)))
        ok = ~np.isnan(np.asarray(wantL)).any(axis=(1, 2))
        _x_close(gotL.numpy()[ok], np.asarray(wantL)[ok], f"L m={m}")
        want = jax.vmap(jbq._cho_solve_small)(wantL[ok], c[ok])
        got = tbq._cho_solve_small(gotL[ok], torch.from_numpy(c[ok]))
        _x_close(got.numpy(), want, f"solve m={m}")
