"""The unicycle's derivative stage against the JAX package's kernel:
``kernel_derivs.derivs_batched`` (on the CPU the plain version of the
derivative kernel) for the unicycle (examples/custom_model.py) against
``pallas_derivs.derivs_batched`` in Pallas interpret mode, Euler and RK4,
in jvp mode to rtol 1e-5 / atol 1e-6 (the same dual-number rules; the
trig libraries differ by an ulp), in fd mode at eps = 0.05 to the
stencil gauge of tests/test_torch_fd_rk4.py (relative |a − b| / (1 +
|b|): p99 ≤ 5e-3, max ≤ 5e-2). The helpers here serve
tests/test_torch_custom_backward.py too.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.ops import pallas_derivs
from ilqr_tpu_torch.examples import custom_model as tcm
from ilqr_tpu_torch.ops import (
    kernel_derivs,
    kernel_rollout,
    launch_counts,
    reset_launch_counts,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import custom_model as jcm  # noqa: E402

B, T, DT = 5, 6, 0.05
JVP_RTOL, JVP_ATOL = 1e-5, 1e-6
FD_EPS, FD_P99, FD_MAX = 0.05, 5e-3, 5e-2
NAMES = ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu")


def unicycle_case():
    """(JAX model, JAX params, port model, port packed params)."""
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                jcm.default_params())
    tp = tcm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jcm.UNICYCLE, jp, tcm.UNICYCLE, kernel_rollout.pack_params(tp, DT)


def _inputs(model, seed):
    rng = np.random.default_rng(seed)
    xs = (0.7 * rng.normal(size=(B, T + 1, model.n))).astype(np.float32)
    us = (1.5 * rng.normal(size=(B, T, model.m))).astype(np.float32)
    return xs, us


def derivs_both(case, integrator, mode, seed):
    """The port's plain derivatives and the JAX kernel's (interpret mode)
    of ``case`` on inputs from ``seed``: (port, JAX, xs, us)."""
    jm, jp, tm, pp = case
    xs, us = _inputs(tm, seed)
    want = pallas_derivs.derivs_batched(
        jm, integrator, jp, DT, jnp.asarray(xs), jnp.asarray(us), mode=mode,
        eps=FD_EPS, interpret=True)
    reset_launch_counts()
    got = kernel_derivs.derivs_batched(
        tm, integrator, pp, torch.from_numpy(xs), torch.from_numpy(us),
        mode=mode, eps=FD_EPS)
    assert launch_counts()["derivs_packed"] == 0
    return got, want, xs, us


def hold(got, want, mode):
    """Each derivative array held to the module's tolerances."""
    for what, g, w in zip(NAMES, got, want):
        g = g.numpy().astype(np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, what
        if mode == "jvp":
            np.testing.assert_allclose(g, w, rtol=JVP_RTOL, atol=JVP_ATOL,
                                       err_msg=what)
        else:
            rel = np.abs(g - w) / (1.0 + np.abs(w))
            assert np.percentile(rel, 99) <= FD_P99, (what, rel.max())
            assert rel.max() <= FD_MAX, (what, rel.max())


@pytest.mark.parametrize("integrator, mode", [
    ("euler", "jvp"), ("rk4", "jvp"), ("euler", "fd"), ("rk4", "fd")])
def test_unicycle_derivs_match_pallas(integrator, mode):
    got, want, xs, us = derivs_both(unicycle_case(), integrator, mode, 11)
    hold(got, want, mode)
    if integrator == "rk4":   # the RK4 step's Jacobian, not the Euler one's
        euler = kernel_derivs.derivs_batched(
            tcm.UNICYCLE, "euler", unicycle_case()[3],
            torch.from_numpy(xs), torch.from_numpy(us), mode=mode,
            eps=FD_EPS)
        assert np.abs(euler[0].numpy() - got[0].numpy()).max() > 1e-4
