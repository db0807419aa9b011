"""ilqr_tpu_torch's four kernel ops against ilqr_tpu's Pallas kernels.

On the CPU each op runs its plain PyTorch version; the JAX kernels run in
Pallas interpret mode at the sizes the JAX package's own tests use (one
1024-lane block, T = 7, 3 α's) with a time block that does not divide T, so
the JAX side's edge-row masking is exercised. Inputs are drawn with numpy
and handed to both sides: the port takes the lane-last (…, B) layout, which
is the JAX packed (…, 1, 8, 128) layout flattened.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.models import acrobot as jac
from ilqr_tpu.ops import pallas_iter, pallas_rollout, pallas_sweep
from ilqr_tpu_torch.models import acrobot as tac
from ilqr_tpu_torch.ops import kernel_iter, kernel_rollout, kernel_sweep

B, T, N, M = 1024, 7, 4, 1
TB = 3            # JAX time block: 7 = 3 + 3 + 1 masked edge rows
DT = 0.02
ALPHAS = np.asarray([1.0, 0.5, 0.1], np.float32)
# Port (torch CPU) vs JAX (XLA CPU) in f32: the two libraries' sinf/cosf
# differ by up to an ulp, and T steps of the model and the Riccati
# recursion carry that forward. Measured max |a − b| / (1 + |b|): ~2e-7 for
# the rollouts, up to 2e-5 for the sweep's gains (the recursion amplifies
# the trig's ulp); 1e-4 leaves room for other seeds while any error in the
# algebra (a wrong term, order or mask) moves values by far more.
TOL = 1e-4

JMODEL = jac.MODEL
TMODEL = tac.MODEL


def _jparams():
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jac.default_params())


def _jpack():
    return pallas_rollout.pack_params(
        jax.tree_util.tree_map(jnp.asarray, _jparams()), DT)


def _tpack(device="cpu"):
    return kernel_rollout.pack_params(tac.params_from_numpy(_jparams()), DT,
                                      device)


def _jp(a):
    """Lane-last numpy array → JAX packed (…, 1, 8, 128) f32 array."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a.reshape(a.shape[:-1] + (1, 8, 128)))


def _tp(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _unj(y):
    """JAX packed output → lane-last numpy array."""
    y = np.asarray(y)
    return y.reshape(y.shape[:-3] + (B,))


def _assert_close(got, want, what, tol=TOL, scale=None):
    """max |got − want| / (1 + |scale|) ≤ tol, NaNs in the same places;
    ``scale`` defaults to ``want`` (a difference of two costs, dcost, is
    measured against the costs it was taken from)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = want if scale is None else np.broadcast_to(scale, want.shape)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok]) / (1.0 + np.abs(scale[ok]))
    assert err.max(initial=0.0) <= tol, (what, float(err.max()))


def _rollout_cost(x0, uff, xsr, K, clamp=True):
    """Port plain rollout (used to build consistent test inputs)."""
    return kernel_rollout.rollout_plain(
        TMODEL, "euler", clamp, _tpack(), _tp(x0), _tp(uff), _tp(xsr), _tp(K))


def _cprev_between(cand, rng):
    """Per-lane previous costs that put the first accepted α anywhere from
    none to all, at least half a candidate gap away from every candidate
    cost, so no acceptance test sits on a rounding knife edge."""
    A = cand.shape[0]
    s = np.sort(cand, axis=0)
    choice = rng.integers(0, A + 1, size=B)
    cprev = np.where(choice == 0, s[0] - 1.0, s[-1] + 1.0)
    for o in range(1, A):
        gap = s[o] - s[o - 1]
        mid = 0.5 * (s[o - 1] + s[o])
        use = (choice == o) & (gap > 1e-3 * (1.0 + np.abs(s[o])))
        cprev = np.where(use, mid, cprev)
    return cprev.astype(np.float32)


def _trajectory(rng):
    """A consistent (x0, us, xs, x_T) from a clamped open-loop rollout."""
    x0 = (0.3 * rng.normal(size=(N, B))).astype(np.float32)
    us = (2.0 * rng.normal(size=(T, M, B))).astype(np.float32)
    xs, us_c, xT, cost = _rollout_cost(
        x0, us, np.zeros((T, N, B), np.float32),
        np.zeros((T, M, N, B), np.float32))
    return x0, us_c.numpy(), xs.numpy(), xT.numpy(), cost.numpy()


def _lam(rng):
    """λ per lane: mostly 1, some small, 1/8 negative so QuuF ≤ 0 and the
    divergence latch fires."""
    lam = np.ones(B, np.float32)
    lam[rng.uniform(size=B) < 0.25] = 1e-3
    lam[rng.uniform(size=B) < 0.125] = -100.0
    return lam


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clamp", [True, False])
def test_rollout_matches_jax(clamp):
    rng = np.random.default_rng(10)
    x0 = (0.3 * rng.normal(size=(N, B))).astype(np.float32)
    uff = (3.0 * rng.normal(size=(T, M, B))).astype(np.float32)  # some clamp
    xsr = (0.3 * rng.normal(size=(T, N, B))).astype(np.float32)
    K = (0.5 * rng.normal(size=(T, M, N, B))).astype(np.float32)
    want = pallas_rollout.rollout_packed(
        JMODEL, "euler", clamp, _jpack(), _jp(x0), _jp(uff), _jp(xsr),
        _jp(K), interpret=True)
    got = kernel_rollout.rollout_packed(
        TMODEL, "euler", clamp, _tpack(), _tp(x0), _tp(uff), _tp(xsr), _tp(K))
    for g, w, what in zip(got, want, ("xs", "us", "x_final", "cost")):
        _assert_close(g, _unj(w), what)
    if clamp:
        assert float(got[1].abs().max()) <= 5.0
    assert kernel_rollout.rollout_packed.launches == 0


def test_sweep_matches_jax():
    rng = np.random.default_rng(11)
    _x0, us, xs, xT, _c = _trajectory(rng)
    lam = _lam(rng)
    want = pallas_sweep.sweep_packed(
        JMODEL, "euler", _jpack(), _jp(xs), _jp(xT), _jp(us), _jp(lam),
        mode="jvp", interpret=True, use_limits=True, time_block=TB)
    got = kernel_sweep.sweep_packed(
        TMODEL, "euler", _tpack(), _tp(xs), _tp(xT), _tp(us), _tp(lam))
    for g, w, what in zip(got, want, ("k", "K", "dv", "diverged", "gnorm")):
        _assert_close(g, _unj(w), what)
    div = got[3].numpy()
    np.testing.assert_array_equal(div, _unj(want[3]))   # exact 0/1 latch
    assert div[lam < 0].min() == 1.0 and div[lam > 0].max() == 0.0
    # some controls sit on the ±5 box, so the QP's clamped branch runs
    k, u = got[0].numpy(), us
    assert np.any(np.isclose(np.abs(u + k), 5.0) & (lam > 0))


def test_linesearch_matches_jax():
    rng = np.random.default_rng(12)
    x0, us, xs, xT, _c = _trajectory(rng)
    k = (0.5 * rng.normal(size=(T, M, B))).astype(np.float32)
    K = (0.1 * rng.normal(size=(T, M, N, B))).astype(np.float32)
    kold = rng.normal(size=(T, M, B)).astype(np.float32)
    Kold = rng.normal(size=(T, M, N, B)).astype(np.float32)
    dv = np.stack([-np.abs(rng.normal(size=B)) * 5.0,
                   rng.normal(size=B) * 0.1]).astype(np.float32)
    cand = np.stack([_rollout_cost(x0, us + a * k, xs, K)[3].numpy()
                     for a in ALPHAS])
    cprev = _cprev_between(cand, rng)
    gate = (rng.uniform(size=B) > 0.5).astype(np.float32)
    keep = (rng.uniform(size=B) > 0.5).astype(np.float32)
    want = pallas_rollout.linesearch_packed(
        JMODEL, "euler", True, _jpack(), _jp(x0), _jp(us), _jp(xs), _jp(xT),
        _jp(K), _jp(k), _jp(Kold), _jp(kold), jnp.asarray(ALPHAS), _jp(dv),
        _jp(cprev), _jp(gate), _jp(keep), 0.0, interpret=True, time_block=TB)
    got = kernel_rollout.linesearch_packed(
        TMODEL, "euler", True, _tpack(), _tp(x0), _tp(us), _tp(xs), _tp(xT),
        _tp(K), _tp(k), _tp(Kold), _tp(kold), _tp(ALPHAS), _tp(dv),
        _tp(cprev), _tp(gate), _tp(keep), 0.0)
    names = ("xs", "us", "x_final", "k_keep", "K_keep", "ls_cost",
             "alpha_sel", "accepted", "dcost", "expected")
    for g, w, what in zip(got, want, names):
        _assert_close(g, _unj(w), what,
                      scale=cprev if what == "dcost" else None)
    acc = got[7].numpy()
    np.testing.assert_array_equal(acc, _unj(want[7]))
    np.testing.assert_array_equal(got[6].numpy(), _unj(want[6]))
    # the selection really is mixed: none, the first and later α's
    sel = got[6].numpy()
    assert 0 < acc.sum() < B and len(np.unique(sel[acc > 0])) == len(ALPHAS)


def test_iteration_matches_jax():
    rng = np.random.default_rng(13)
    x0, us, xs, xT, cost0 = _trajectory(rng)
    kold = rng.normal(size=(T, M, B)).astype(np.float32)
    Kold = rng.normal(size=(T, M, N, B)).astype(np.float32)
    lam = _lam(rng)
    live = (rng.uniform(size=B) > 0.5).astype(np.float32)
    # previous costs placed between this iteration's candidate costs
    k, K, *_ = kernel_sweep.sweep_plain(TMODEL, "euler", _tpack(), _tp(xs),
                                        _tp(xT), _tp(us), _tp(lam))
    cand = np.stack([_rollout_cost(x0, us + a * k.numpy(), xs, K.numpy())[3]
                     .numpy() for a in ALPHAS])
    cprev = _cprev_between(cand, rng)
    want = pallas_iter.iteration_packed(
        JMODEL, "euler", True, _jpack(), _jp(x0), _jp(xs), _jp(xT), _jp(us),
        _jp(kold), _jp(Kold), _jp(lam), _jp(cprev), _jp(live),
        jnp.asarray(ALPHAS), mode="jvp", use_limits=True, z_min=0.0,
        tol_grad=1e-6, lambda_grad_term=1e-5, interpret=True, time_block=TB)
    got = kernel_iter.iteration_packed(
        TMODEL, "euler", True, _tpack(), _tp(x0), _tp(xs), _tp(xT), _tp(us),
        _tp(kold), _tp(Kold), _tp(lam), _tp(cprev), _tp(live),
        _tp(ALPHAS), mode="jvp", use_limits=True, z_min=0.0, tol_grad=1e-6,
        lambda_grad_term=1e-5)
    names = ("xs", "us", "x_final", "k_keep", "K_keep", "ls_cost",
             "alpha_sel", "accepted", "dcost", "expected", "diverged",
             "gnorm")
    assert len(got) == len(want) == 12
    for g, w, what in zip(got, want, names):
        _assert_close(g, _unj(w), what,
                      scale=cprev if what == "dcost" else None)
    for i in (6, 7, 10):   # α, accepted and diverged are exact
        np.testing.assert_array_equal(got[i].numpy(), _unj(want[i]))
    div, acc = got[10].numpy(), got[7].numpy()
    assert div[lam < 0].min() == 1.0 and div[lam > 0].max() == 0.0
    take = (acc > 0.5) & (div < 0.5) & (live > 0.5)
    assert take.any() and (~take).any()
    # lanes that do not take the step re-emit their trajectory exactly
    np.testing.assert_array_equal(got[0].numpy()[..., ~take], xs[..., ~take])
    np.testing.assert_array_equal(got[1].numpy()[..., ~take], us[..., ~take])
    keep = (div < 0.5) & (live > 0.5)
    np.testing.assert_array_equal(got[3].numpy()[..., ~keep],
                                  kold[..., ~keep])


# ---------------------------------------------------------------------------
# power_mass: the sweep with a live, state-dependent cxu, a cxx with live
# off-diagonal entries and a full cuu (the general Q-terms of _sweep_step)

def test_power_mass_sweep_matches_jax():
    """The plain sweep against the JAX kernel in interpret mode on
    power_mass, where Qux starts at the live cxu, Qxx at cxx's live
    velocity block and Quu at the full cuu. One 1024-lane block (the JAX
    packed layout's), T = 7 in time blocks of 3, controls drawn so that
    both boxes bind on some lanes, λ mixed as above. The two sides run the
    same f32 operations in the same order (no trig), but XLA:CPU's fused
    code rounds a few of them differently: measured max |a − b| / (1 + |b|)
    5.7e-7 (k); held to the file's TOL."""
    from ilqr_tpu.models import power_mass as jpm
    from ilqr_tpu_torch.models import power_mass as tpm

    rng = np.random.default_rng(14)
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                jpm.default_params())
    jpack = pallas_rollout.pack_params(
        jax.tree_util.tree_map(jnp.asarray, jp), 0.05)
    tpack = kernel_rollout.pack_params(tpm.params_from_numpy(jp), 0.05)
    n, m = 4, 2
    x0 = (rng.normal(size=(n, B)) * [[1.0], [1.0], [1.5], [1.5]]
          ).astype(np.float32)
    us_in = (1.5 * rng.normal(size=(T, m, B))).astype(np.float32)
    xs, us, xT, _c = kernel_rollout.rollout_plain(
        tpm.MODEL, "euler", True, tpack, _tp(x0), _tp(us_in),
        torch.zeros(T, n, B), torch.zeros(T, m, n, B))
    xs, us, xT = xs.numpy(), us.numpy(), xT.numpy()
    lam = _lam(rng)
    want = pallas_sweep.sweep_packed(
        jpm.MODEL, "euler", jpack, _jp(xs), _jp(xT), _jp(us), _jp(lam),
        mode="jvp", interpret=True, use_limits=True, time_block=TB)
    got = kernel_sweep.sweep_packed(
        tpm.MODEL, "euler", tpack, _tp(xs), _tp(xT), _tp(us), _tp(lam))
    for g, w, what in zip(got, want, ("k", "K", "dv", "diverged", "gnorm")):
        _assert_close(g, _unj(w), what)
    div = got[3].numpy()
    np.testing.assert_array_equal(div, _unj(want[3]))
    assert div[lam < 0].min() == 1.0 and div[lam > 0].max() == 0.0
    # the cross terms are live on these inputs: cxu's velocity rows are far
    # from zero, and both bounds of the asymmetric box bind somewhere
    _cx, _cu, _cxx, cxu, _cuu = tpm.cost_derivs_soa(
        tpm.params_from_numpy(jp), _tp(xs[0]), _tp(us[0]))
    assert float(torch.stack([cxu[2][0], cxu[3][1]]).abs().median()) > 1e-2
    uk = us + got[0].numpy()
    ok = lam > 0
    assert np.any(np.isclose(uk, -1.5)[..., ok]) and np.any(
        np.isclose(uk, 2.5)[..., ok])
