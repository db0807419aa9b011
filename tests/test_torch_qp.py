"""ilqr_tpu_torch.ops.qp (the plain versions of the in-kernel QPs for
m ≤ 4) against the JAX kernel's own tile functions, called on arrays
directly as tests/test_qp_tiles.py calls them: _qp_m2, _qp_m3, _qp_m4,
_qp_newton and _free_solve_rows.

Both sides run the same IEEE f32 operations in the same order, so on the
CPU they agree to the bit on every lane tried. The tests hold them to what
must hold on any backend: the PD flag exactly; k and the free set exactly
on lanes where the QP is well separated — every control free at least
1e-4 inside its box or pressed onto a face by a gradient of at least 1e-4
(near a face the free and clamped candidates tie, and the first in
product order wins: the tie case below checks that rule on its own); k
elsewhere and the feedback rows to 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.ops import pallas_sweep as ps
from ilqr_tpu_torch.ops import qp

B = 1024
REL = 1e-5
JAX_BOX = {2: ps._qp_m2, 3: ps._qp_m3, 4: ps._qp_m4}


def _qps(seed, m, scale, ridge):
    """B random symmetric Quu = A·Aᵀ + ridge·I (ridge < 0 makes most lanes
    indefinite), gradients at ``scale``, boxes around 0."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, m))
    Q = A @ np.swapaxes(A, 1, 2) + ridge * np.eye(m)
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
    return float(np.max(np.abs(got - want) / (1.0 + np.abs(want)),
                        initial=0.0))


def _decisive(Q, g, lo, hi, x):
    """Lanes whose every control is free at least 1e-4 inside its box, or
    on a face with a gradient of at least 1e-4 pressing on it."""
    gr = np.einsum("bij,bj->bi", Q.astype(np.float64), x) + g
    interior = (x - lo > 1e-4) & (hi - x > 1e-4)
    pressed = (((x == lo) & (gr > 1e-4)) | ((x == hi) & (gr < -1e-4)))
    return np.all(interior | pressed, axis=-1)


CASES = [(m, seed, scale, ridge)
         for m in (2, 3, 4)
         for seed, scale, ridge in ((1, 1.0, 0.5), (2, 4.0, -1.0),
                                    (3, 0.2, 0.05), (4, 20.0, 2.0))]


@pytest.mark.parametrize("m,seed,scale,ridge", CASES)
def test_box_qp_matches_jax(m, seed, scale, ridge):
    Q, g, lo, hi = _qps(10 * m + seed, m, scale, ridge)
    kj, fj, bj = JAX_BOX[m](_mat(Q, "jax"), _vec(g, "jax"), _vec(lo, "jax"),
                            _vec(hi, "jax"))
    kt, ft, bt = qp.box_qp(_mat(Q, "torch"), _vec(g, "torch"),
                           _vec(lo, "torch"), _vec(hi, "torch"), m)
    kj, kt, fj, ft = _np(kj), _np(kt), _np(fj), _np(ft)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    decisive = _decisive(Q, g, lo, hi, kj) | np.asarray(bj)
    assert decisive.mean() > 0.9
    np.testing.assert_array_equal(kt[decisive], kj[decisive])
    np.testing.assert_array_equal(ft[decisive], fj[decisive])
    assert _rel(kt, kj) <= REL
    # the cases cover PD and indefinite lanes, clamped and free controls
    bad = np.asarray(bj)
    if ridge < 0:
        assert bad.mean() > 0.5 and (~bad).any()
    else:
        assert not bad.any()
        assert fj.any() and (~fj).any()


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("ridge", [0.5, -1.0])
def test_newton_matches_jax(m, ridge):
    Q, g, _lo, _hi = _qps(40 + m, m, 1.0, ridge)
    kj, fj, bj = ps._qp_newton(_mat(Q, "jax"), _vec(g, "jax"), m)
    kt, ft, bt = qp.qp_newton(_mat(Q, "torch"), _vec(g, "torch"), m)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(_np(ft), _np(fj))
    assert _rel(_np(kt), _np(kj)) <= REL
    good = ~np.asarray(bj)
    assert good.any()
    ref = -np.linalg.solve(Q[good].astype(np.float64),
                           g[good, :, None].astype(np.float64))[..., 0]
    np.testing.assert_allclose(_np(kt)[good], ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_free_solve_rows_matches_jax(m):
    Q, _g, _lo, _hi = _qps(50 + m, m, 1.0, 0.5)
    rng = np.random.default_rng(60 + m)
    n = 5
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
    # clamped rows are exactly zero
    assert np.all(rt.transpose(0, 2, 1)[~free.T] == 0.0)


def test_qp_m4_boundary_tie_matches_jax():
    """The optimum of dim 0 lies exactly on its upper face, where the free
    and the clamped candidate sets tie: both sides keep the first in
    product order (tests/test_qp_tiles.py:138)."""
    Q = np.eye(4, dtype=np.float32)[None].repeat(B, 0)
    g = np.tile(np.asarray([-0.5, 0.25, 0.0, 0.1], np.float32), (B, 1))
    lo = np.full((B, 4), -0.5, np.float32)
    hi = np.full((B, 4), 0.5, np.float32)
    kj, fj, bj = ps._qp_m4(_mat(Q, "jax"), _vec(g, "jax"), _vec(lo, "jax"),
                           _vec(hi, "jax"))
    kt, ft, bt = qp.qp_m4(_mat(Q, "torch"), _vec(g, "torch"),
                          _vec(lo, "torch"), _vec(hi, "torch"))
    assert not bt.any()
    np.testing.assert_array_equal(_np(kt), _np(kj))
    np.testing.assert_array_equal(_np(ft), _np(fj))
    np.testing.assert_allclose(_np(kt), np.tile([0.5, -0.25, 0.0, -0.1],
                                                (B, 1)), atol=1e-6)


def test_m5_raises():
    """m = 5 takes projected Newton (tests/test_torch_qp_pn.py holds it
    against JAX); past m = 24, the JAX package's cap, the QPs raise."""
    eye = [[torch.full((2,), float(i == j)) for j in range(5)]
           for i in range(5)]
    k, free, bad = qp.box_qp(eye, [torch.ones(2)] * 5, [-torch.ones(2)] * 5,
                             [torch.ones(2)] * 5, 5)
    assert not bad.any() and all(bool((ki == -1.0).all()) for ki in k)
    one = [[torch.ones(2)] * 25 for _ in range(25)]
    with pytest.raises(ValueError):
        qp.box_qp(one, [torch.ones(2)] * 25, [-torch.ones(2)] * 25,
                  [torch.ones(2)] * 25, 25)
    with pytest.raises(ValueError):
        qp.qp_newton(one, [torch.ones(2)] * 25, 25)
