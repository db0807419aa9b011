"""ilqr_tpu_torch's backward stage against ilqr_tpu's.

- ``kernel_backward.backward_sweep_batched`` (on the CPU: the plain version
  of the backward kernel) against ``pallas_backward.backward_sweep_batched``
  in Pallas interpret mode, and against ``_backward_m1_scan``, the JAX
  package's second oracle;
- ``ops.backward.backward_pass`` on both routes, and ``gradient_norm``.

The derivatives come from the port's plain derivative op along a random
trajectory (B = 6 problems, T = 6) with large controls, so that some steps
clamp at the ±5 box; λ = −100 on one lane makes QuuF ≤ 0 there, so its
divergence latch fires.

Tolerances. Against the kernel: the same operations in the same order, so
the two sides differ only where XLA and PyTorch round a product-sum
differently (measured ≤ 2.4e-6 on K): max |a − b| / (1 + |b|) ≤ 1e-5.
Against the scan, which symmetrizes Vxx and sums in matrix-product order:
≤ 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.ops import backward as jax_backward
from ilqr_tpu.ops import pallas_backward
from ilqr_tpu_torch import SolverConfig
from ilqr_tpu_torch.models import acrobot as tac
from ilqr_tpu_torch.ops import backward, kernel_backward, kernel_derivs
from ilqr_tpu_torch.ops import kernel_rollout, launch_counts
from ilqr_tpu_torch.ops import reset_launch_counts
from ilqr_tpu_torch.types import Derivs

B, T, N = 6, 6, 4
KERNEL_TOL, SCAN_TOL = 1e-5, 1e-4
DIVERGENT = 3


def _problem():
    rng = np.random.default_rng(30)
    xs = (0.5 * rng.normal(size=(B, T + 1, N))).astype(np.float32)
    us = (4.0 * rng.normal(size=(B, T, 1))).astype(np.float32)
    pp = kernel_rollout.pack_params(tac.default_params(), 0.02)
    d = kernel_derivs.derivs_batched(tac.MODEL, "euler", pp,
                                     torch.from_numpy(xs),
                                     torch.from_numpy(us))
    d = [np.ascontiguousarray(a.numpy()) for a in d]
    lo, hi = (-5.0 - us).astype(np.float32), (5.0 - us).astype(np.float32)
    lam = np.ones(B, np.float32)
    lam[1] = 1e-3
    lam[DIVERGENT] = -100.0
    return d, us, lo, hi, lam


def _close(got, want, what, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max() <= tol, (what, float(err.max()))


def _port(d, lo, hi, lam):
    return kernel_backward.backward_sweep_batched(
        *(torch.from_numpy(a) for a in (*d, lo, hi, lam)))


def test_backward_plain_matches_pallas_and_scan():
    d, us, lo, hi, lam = _problem()
    reset_launch_counts()
    got = _port(d, lo, hi, lam)
    assert launch_counts()["backward_sweep_packed"] == 0
    jargs = [jnp.asarray(a) for a in (*d, lo, hi, lam)]
    want = pallas_backward.backward_sweep_batched(*jargs, interpret=True)
    scan = jax.vmap(pallas_backward._backward_m1_scan)(*jargs)
    for i, what in enumerate(("k", "K", "dV")):
        _close(got[i], want[i], what, KERNEL_TOL)
        _close(got[i], scan[i], what + " (scan)", SCAN_TOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(scan[3]))
    div = got[3].numpy()
    assert div[DIVERGENT] and div.sum() == 1
    # the closed-form QP's clamped branch ran: some u + k on the box, with
    # its K row zeroed
    k, K = got[0].numpy(), got[1].numpy()
    on_box = np.isclose(np.abs(us + k), 5.0) & ~div[:, None, None]
    assert on_box.any()
    assert np.all(K[on_box[..., 0]] == 0.0)


@pytest.mark.parametrize("route", ["auto", "xla"])
def test_backward_pass_routes(route):
    """backward_pass: the kernel route (the plain version on CPU tensors)
    and the "xla" scan route, against the JAX scan."""
    d, us, lo, hi, lam = _problem()
    derivs = Derivs(*(torch.from_numpy(a) for a in d))
    got = backward.backward_pass(
        derivs, torch.from_numpy(us), torch.from_numpy(lam),
        torch.tensor([-5.0]), torch.tensor([5.0]),
        SolverConfig(backward_kernel=route))
    want = jax.vmap(pallas_backward._backward_m1_scan)(
        *(jnp.asarray(a) for a in (*d, lo, hi, lam)))
    for i, what in enumerate(("k", "K", "dV")):
        _close(got[i], want[i], what, SCAN_TOL)
    np.testing.assert_array_equal(got.diverged.numpy(), np.asarray(want[3]))


def test_backward_pass_unported_configs_raise():
    """Full DDP and the assoc modes still raise; the m = 1 QP modes other
    than the closed form (the iterative box QP, the enumeration) and the
    unconstrained Cholesky step are carried now and match the JAX scan
    (the same problem, the previous k[T-1] zero) to SCAN_TOL."""
    d, us, _lo, _hi, lam = _problem()
    derivs = Derivs(*(torch.from_numpy(a) for a in d))
    args = (derivs, torch.from_numpy(us), torch.from_numpy(lam),
            torch.tensor([-5.0]), torch.tensor([5.0]))
    for bad in (dict(backward_mode="assoc"),
                dict(backward_mode="assoc_frozen"), dict(full_ddp=True)):
        with pytest.raises(NotImplementedError):
            backward.backward_pass(*args, SolverConfig(**bad))
    from ilqr_tpu import SolverConfig as JaxConfig
    from ilqr_tpu.types import Derivs as JaxDerivs

    for carried in (dict(boxqp_mode="iterative"), dict(boxqp_mode="enum"),
                    dict(use_control_limits=False)):
        got = backward.backward_pass(*args, SolverConfig(**carried))
        jcfg = JaxConfig(backward_kernel="xla", **carried)
        want = jax.vmap(lambda dd, u, lm: jax_backward.backward_pass(
            JaxDerivs(*dd), u, lm, jnp.asarray([-5.0], jnp.float32),
            jnp.asarray([5.0], jnp.float32), jcfg,
            prev_k_last=jnp.zeros((1,), jnp.float32)))(
                tuple(jnp.asarray(a) for a in d), us, lam)
        div = np.asarray(want.diverged)
        np.testing.assert_array_equal(got.diverged.numpy(), div)
        ok = ~div
        for i, what in enumerate(("k", "K", "dV")):
            _close(got[i].numpy()[ok], np.asarray(want[i])[ok], what,
                   SCAN_TOL)


def test_gradient_norm_matches_jax():
    rng = np.random.default_rng(31)
    k = rng.normal(size=(B, T, 1)).astype(np.float32)
    us = (3.0 * rng.normal(size=(B, T, 1))).astype(np.float32)
    want = jax.vmap(jax_backward.gradient_norm)(jnp.asarray(k),
                                                jnp.asarray(us))
    got = backward.gradient_norm(torch.from_numpy(k), torch.from_numpy(us))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # one problem without a batch axis
    assert backward.gradient_norm(torch.from_numpy(k[0]),
                                  torch.from_numpy(us[0])).shape == ()
