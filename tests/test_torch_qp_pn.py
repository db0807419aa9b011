"""ilqr_tpu_torch.ops.qp for 5 ≤ m ≤ 24 (the masked Cholesky, its solve,
projected Newton, the Newton step and the feedback rows) against the JAX
kernel's own tile functions, called on arrays directly as
tests/test_qp_tiles.py calls them: _chol_masked_tiles, _chol_solve_tiles,
_qp_pn, _qp_newton and _free_solve_rows.

Both sides run the same f32 operations in the same order except the
reciprocal square root of each pivot: the port takes the IEEE-rounded
1/√d, the JAX tile code ``jax.lax.rsqrt``, which on XLA:CPU differs from
it by up to 2 ulp on about 29% of inputs. So the tests hold:

- the factor, its reciprocal diagonal, solves, Newton steps and feedback
  rows to 1e-5 relative, |port − JAX| ≤ 1e-5·(1 + |JAX|), and the PD flag
  exactly;
- projected Newton's PD flag exactly; its k to 1e-4 relative on at least
  99% of the lanes and to 1e-3 on every lane, with the objective at k
  within 1e-5·(1 + |v|) of the JAX k's on every lane. Its m + 6
  iterations leave a few lanes short of convergence, where an ulp of a
  pivot can pick another step of the ladder: on these inputs 8 lanes of
  the 2 560 lie beyond 1e-4 (at most 3.4e-4, each logged in ROADMAP.md
  §C), none beyond 1e-3, and the objectives differ by at most 1.7e-6
  (absolute).
  With ``jax.lax.rsqrt`` replaced by the IEEE 1/√d, the JAX tile code and
  the port agree bit for bit on the same inputs (k, free set, flag): the
  rsqrt ulps are the whole of the gap;
- its final free set exactly on the well-separated lanes, where every
  control of the JAX solution is free at least 1e-3 inside its box or
  sits on a face with a gradient of at least 1e-3 pressing on it (an ulp
  can flip a true near-tie);
- for m ≤ 8, the objective of the port's k within 1e-5 (absolute, in
  float64) of the exact 3^m enumeration's optimum
  (tests/test_qp_tiles.py:201-220).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.ops import pallas_sweep as ps
from ilqr_tpu_torch.ops import qp

sys.path.insert(0, os.path.dirname(__file__))
from test_qp_tiles import _enum_oracle  # noqa: E402

B = 256
REL = 1e-5      # deterministic algebra: only the rsqrt ulps differ
PN_REL, PN_SHARE, PN_MAX = 1e-4, 0.99, 1e-3   # projected Newton's k
SEP = 1e-3      # well-separated lanes for the free-set comparison
MS = (5, 6, 8, 12, 24)


def _qps(seed, m, scale, ridge=None):
    """B random symmetric PD QuuF = A·Aᵀ + r·I (r uniform in [0.2, 3] per
    lane unless given), gradients at ``scale``, boxes around 0."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, m))
    r = rng.uniform(0.2, 3.0, size=(B, 1, 1)) if ridge is None else ridge
    Q = A @ np.swapaxes(A, 1, 2) + r * np.eye(m)
    g = scale * rng.normal(size=(B, m))
    lo = -rng.uniform(0.05, 1.0, size=(B, m))
    hi = rng.uniform(0.05, 1.0, size=(B, m))
    return [a.astype(np.float32) for a in (Q, g, lo, hi)]


def _mat(Q, lib):
    m = Q.shape[-1]
    conv = jnp.asarray if lib == "jax" else (
        lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    return [[conv(Q[:, i, j]) for j in range(m)] for i in range(m)]


def _vec(v, lib):
    conv = jnp.asarray if lib == "jax" else (
        lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    return [conv(v[:, i]) for i in range(v.shape[-1])]


def _np(lanes):
    return np.stack([np.asarray(a) for a in lanes], -1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (1.0 + np.abs(want)),
                        initial=0.0))


def _separated(Q, g, lo, hi, x):
    """Lanes whose every control is free at least SEP inside its box, or
    on a face with a gradient of at least SEP pressing on it."""
    gr = np.einsum("bij,bj->bi", Q.astype(np.float64), x) + g
    interior = (x - lo > SEP) & (hi - x > SEP)
    pressed = (((x == lo) & (gr > SEP)) | ((x == hi) & (gr < -SEP)))
    return np.all(interior | pressed, axis=-1)


def _value(Q, g, x):
    x = x.astype(np.float64)
    return (0.5 * np.einsum("bi,bij,bj->b", x, Q.astype(np.float64), x)
            + np.einsum("bi,bi->b", g, x))


@pytest.mark.parametrize("m", MS)
def test_chol_masked_and_solve_match_jax(m):
    Q, g, _lo, _hi = _qps(100 + m, m, 1.0)
    rng = np.random.default_rng(200 + m)
    free = (rng.uniform(size=(B, m)) > 0.3).astype(np.float32)
    Lj, rdj, badj = ps._chol_masked_tiles(_mat(Q, "jax"), _vec(free, "jax"),
                                          m)
    Qt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(Q, 0, -1)))
    ft = torch.from_numpy(np.ascontiguousarray(free.T))
    Lt, rdt, badt = qp.chol_masked(Qt, ft)
    Lj_np = np.array([[np.asarray(Lj[i][j]) for j in range(m)]
                      for i in range(m)])
    assert _rel(np.tril(np.moveaxis(Lt.numpy(), -1, 0)),
                np.tril(np.moveaxis(Lj_np, -1, 0))) <= REL
    assert _rel(rdt.numpy().T, _np(rdj)) <= REL
    np.testing.assert_array_equal(badt.numpy(), np.asarray(badj))
    assert not badt.any()
    # clamped rows and columns of the factor are the identity's
    Ln = np.moveaxis(Lt.numpy(), -1, 0)
    for i in range(m):
        cl = free[:, i] == 0.0
        assert np.all(Ln[cl, i, i] == 1.0)
        assert np.all(Ln[cl, i + 1:, i] == 0.0)
    # the solve, on the JAX factor and the port's own
    b = g
    xj = ps._chol_solve_tiles(Lj, rdj, _vec(b, "jax"), m)
    xt = qp.chol_solve(Lt, rdt, torch.from_numpy(np.ascontiguousarray(b.T)))
    assert _rel(xt.numpy().T, _np(xj)) <= REL


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_qp_pn_matches_jax(m, scale):
    Q, g, lo, hi = _qps(10 * m + int(scale), m, scale)
    kj, fj, bj = ps._qp_pn(_mat(Q, "jax"), _vec(g, "jax"), _vec(lo, "jax"),
                           _vec(hi, "jax"), m)
    kt, ft, bt = qp.box_qp(_mat(Q, "torch"), _vec(g, "torch"),
                           _vec(lo, "torch"), _vec(hi, "torch"), m)
    kj, kt, fj, ft = _np(kj), _np(kt), _np(fj), _np(ft)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert not bt.any()
    lane_rel = np.max(np.abs(kt.astype(np.float64) - kj)
                      / (1.0 + np.abs(kj)), axis=-1)
    assert (lane_rel <= PN_REL).mean() >= PN_SHARE, np.sort(lane_rel)[-5:]
    assert lane_rel.max() <= PN_MAX, lane_rel.max()
    vj, vt = _value(Q, g, kj), _value(Q, g, kt)
    assert np.all(np.abs(vt - vj) <= 1e-5 * (1.0 + np.abs(vj)))
    assert np.all(kt >= lo) and np.all(kt <= hi)
    sep = _separated(Q, g, lo, hi, kj.astype(np.float64))
    assert sep.mean() > 0.5, sep.mean()
    np.testing.assert_array_equal(ft[sep], fj[sep])
    # the one-sided work the workloads give it: clamped and free controls
    assert fj.any() and (~fj).any()
    if m <= 8:
        xo, vo = _enum_oracle(Q.astype(np.float64), g.astype(np.float64),
                              lo.astype(np.float64), hi.astype(np.float64))
        gap = _value(Q, g, kt) - vo
        assert gap.max() < 1e-5, gap.max()



@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_qp_pn_matches_jax_bitwise_on_ieee_rsqrt(m, scale, monkeypatch):
    """The inputs of test_qp_pn_matches_jax, with ``jax.lax.rsqrt`` in the
    JAX tile code replaced by the IEEE 1/√d the port takes: k, the free set
    and the PD flag agree bit for bit."""
    monkeypatch.setattr(jax.lax, "rsqrt", lambda d: 1.0 / jnp.sqrt(d))
    Q, g, lo, hi = _qps(10 * m + int(scale), m, scale)
    kj, fj, bj = ps._qp_pn(_mat(Q, "jax"), _vec(g, "jax"), _vec(lo, "jax"),
                           _vec(hi, "jax"), m)
    kt, ft, bt = qp.box_qp(_mat(Q, "torch"), _vec(g, "torch"),
                           _vec(lo, "torch"), _vec(hi, "torch"), m)
    np.testing.assert_array_equal(_np(kt), _np(kj))
    np.testing.assert_array_equal(_np(ft), _np(fj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


def _ieee_rsqrt(d):
    """The IEEE 1/√d of f32 d: the correctly rounded square root, then the
    correctly rounded division (each exact in float64, then rounded)."""
    s = np.sqrt(d.astype(np.float64)).astype(np.float32)
    return (1.0 / s.astype(np.float64)).astype(np.float32)


def _pivots():
    return np.random.default_rng(7).uniform(1e-3, 1e3, 10**5).astype(
        np.float32)


def test_rsqrt_is_ieee_on_the_cpu():
    """The plain Cholesky's 1/√d on the CPU is the IEEE one, bit for bit."""
    d = _pivots()
    np.testing.assert_array_equal(qp._rsqrt(torch.from_numpy(d)).numpy(),
                                  _ieee_rsqrt(d))


def test_cpu_sqrt_is_not_correctly_rounded():
    """Why qp._rsqrt takes torch.rsqrt on the CPU: there 1.0 / torch.sqrt
    misses the IEEE 1/√d, as the f32 torch.sqrt misses the correctly
    rounded square root (on about 0.6% of these inputs)."""
    d = _pivots()
    t = torch.from_numpy(d)
    s = np.sqrt(d.astype(np.float64)).astype(np.float32)
    assert (torch.sqrt(t).numpy() != s).any()
    assert ((1.0 / torch.sqrt(t)).numpy() != _ieee_rsqrt(d)).any()

def test_qp_pn_flags_non_pd():
    """A broken last pivot on every lane: bad everywhere, k = 0 and no free
    control, as the JAX tile function (tests/test_qp_tiles.py:223-232)."""
    m = 6
    Q, g, lo, hi = _qps(31, m, 1.0)
    Q[:, 5, 5] = -1.0
    kj, fj, bj = ps._qp_pn(_mat(Q, "jax"), _vec(g, "jax"), _vec(lo, "jax"),
                           _vec(hi, "jax"), m)
    kt, ft, bt = qp.qp_pn(_mat(Q, "torch"), _vec(g, "torch"),
                          _vec(lo, "torch"), _vec(hi, "torch"), m)
    assert bt.all() and np.asarray(bj).all()
    assert not _np(ft).any() and not _np(fj).any()
    assert np.all(_np(kt) == 0.0) and np.all(_np(kj) == 0.0)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("ridge", [0.5, -2.0])
def test_newton_matches_jax(m, ridge):
    Q, g, _lo, _hi = _qps(40 + m, m, 1.0, ridge=ridge)
    kj, fj, bj = ps._qp_newton(_mat(Q, "jax"), _vec(g, "jax"), m)
    kt, ft, bt = qp.qp_newton(_mat(Q, "torch"), _vec(g, "torch"), m)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(_np(ft), _np(fj))
    assert _rel(_np(kt), _np(kj)) <= REL
    good = ~bt.numpy()
    if ridge > 0:
        assert good.all()
        ref = -np.linalg.solve(Q.astype(np.float64),
                               g[..., None].astype(np.float64))[..., 0]
        np.testing.assert_allclose(_np(kt), ref, rtol=2e-3, atol=2e-3)
    else:
        # A·Aᵀ − 2·I is indefinite on most lanes: flagged, k = 0
        assert (~good).mean() > 0.5
        assert np.all(_np(kt)[~good] == 0.0)


@pytest.mark.parametrize("m", MS)
def test_free_solve_rows_matches_jax(m):
    Q, _g, _lo, _hi = _qps(50 + m, m, 1.0)
    rng = np.random.default_rng(60 + m)
    n = 6
    cols = rng.normal(size=(B, m, n)).astype(np.float32)
    free = rng.uniform(size=(B, m)) > 0.4
    rj = ps._free_solve_rows(
        _mat(Q, "jax"), [jnp.asarray(free[:, i]) for i in range(m)],
        [[jnp.asarray(cols[:, j, i]) for i in range(n)] for j in range(m)], m)
    rt = qp.free_solve_rows(
        _mat(Q, "torch"), [torch.from_numpy(free[:, i].copy())
                           for i in range(m)],
        [[torch.from_numpy(cols[:, j, i].copy()) for i in range(n)]
         for j in range(m)], m)
    rj = np.array([[np.asarray(a) for a in row] for row in rj])
    rt = np.array([[a.numpy() for a in row] for row in rt])
    assert _rel(rt, rj) <= REL
    # clamped rows are exactly zero; free rows solve the padded system
    assert np.all(rt.transpose(2, 0, 1)[~free] == 0.0)
    P = np.where(free[:, :, None] & free[:, None, :], Q, np.eye(m))
    ref = -np.linalg.solve(P.astype(np.float64), cols.astype(np.float64))
    ref = np.where(free[:, :, None], ref, 0.0)
    np.testing.assert_allclose(rt.transpose(2, 0, 1), ref, rtol=3e-3,
                               atol=3e-3)


def test_past_the_cap_raises():
    """m > 24 is past the JAX package's MAX_FUSED_M: ValueError, as its
    tile functions raise."""
    m = qp.MAX_FUSED_M + 1
    one = [[torch.ones(2)] * m for _ in range(m)]
    v = [torch.ones(2)] * m
    with pytest.raises(ValueError, match="24"):
        qp.box_qp(one, v, v, v, m)
    with pytest.raises(ValueError, match="24"):
        qp.qp_newton(one, v, m)
