"""unicycle_heading's backward kernel at n = 3 and the unicycle's
composable batch on the kernel routes, against the JAX package's kernels
(Pallas interpret mode):

- the m = 1 companion ``unicycle_heading`` (a division by a constant in
  its dynamics; its JAX twin is written here): its plain jvp derivatives
  against ``pallas_derivs.derivs_batched`` (tolerances as in
  tests/test_torch_custom_derivs.py), then the plain
  ``backward_sweep_batched`` at n = 3 against
  ``pallas_backward.backward_sweep_batched`` to rtol 1e-5;
- the composable ``solve_batch`` with the kernel routes forced
  (tests/test_custom_model.py:41-53's configuration: analytic, clamped, 3
  iterations, B = 3, T = 10) against the JAX run: costs to rtol 1e-4,
  iterations equal.
"""

import os
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu.batch import solve_batch as jax_solve_batch
from ilqr_tpu.models.base import Model as JaxModel
from ilqr_tpu.ops import pallas_backward
from ilqr_tpu_torch import SolverConfig, solve_batch
from ilqr_tpu_torch.examples import custom_model as tcm
from ilqr_tpu_torch.ops import (
    kernel_backward,
    kernel_rollout,
    launch_counts,
    reset_launch_counts,
)
from test_torch_custom_derivs import derivs_both, hold

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import custom_model as jcm  # noqa: E402

B, DT = 5, 0.05
BACKWARD_RTOL = 1e-5
BATCH_RTOL = 1e-4


# --- the JAX twin of unicycle_heading (ilqr_tpu_torch/examples) -----------

class JaxHeadingParams(NamedTuple):
    goal: jnp.ndarray
    v: jnp.ndarray
    w_pos: jnp.ndarray
    w_theta: jnp.ndarray
    w_control: jnp.ndarray
    w_final: jnp.ndarray
    u_min: jnp.ndarray
    u_max: jnp.ndarray


def jax_heading_params():
    p = tcm.heading_default_params()
    return JaxHeadingParams(*(jnp.asarray(np.asarray(leaf), jnp.float32)
                              for leaf in p))


def _jax_heading_dynamics(p, x, u):
    return jnp.stack([p.v * jnp.cos(x[2]), p.v * jnp.sin(x[2]),
                      u[0] / tcm.STEER_RATIO])


def _jax_state_err(p, x):
    e = p.goal - x
    return (p.w_pos * (e[0] * e[0] + e[1] * e[1])
            + p.w_theta * e[2] * e[2])


def _jax_heading_cost(p, x, u):
    return _jax_state_err(p, x) + p.w_control[0] * u[0] * u[0]


def _jax_heading_final(p, x):
    return p.w_final * _jax_state_err(p, x)


JAX_HEADING = JaxModel(
    name="unicycle_heading", n=3, m=1, dynamics=_jax_heading_dynamics,
    cost=_jax_heading_cost, final_cost=_jax_heading_final,
    default_params=jax_heading_params,
    dynamics_soa=_jax_heading_dynamics, cost_soa=_jax_heading_cost,
    final_cost_soa=_jax_heading_final)


def test_heading_derivs_and_backward_n3_match_pallas():
    """unicycle_heading (n = 3, m = 1): the plain jvp derivatives against
    the JAX kernel's, then the plain backward recursion on them against the
    JAX backward kernel at n = 3, with controls large enough that the ±3
    box binds and λ = −100 on one lane (its divergence latch)."""
    jp = jax_heading_params()
    tp = tcm.heading_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp))
    case = (JAX_HEADING, jp, tcm.UNICYCLE_HEADING,
            kernel_rollout.pack_params(tp, DT))
    got, want, xs, us = derivs_both(case, "euler", "jvp", 12)
    hold(got, want, "jvp")
    d = [np.ascontiguousarray(a.numpy()) for a in got]
    p = tcm.heading_default_params()
    lo = (float(p.u_min[0]) - 2.0 * us).astype(np.float32)
    hi = (float(p.u_max[0]) - 2.0 * us).astype(np.float32)
    lam = np.ones(B, np.float32)
    lam[1] = 1e-3
    lam[3] = -100.0
    reset_launch_counts()
    out = kernel_backward.backward_sweep_batched(
        *(torch.from_numpy(a) for a in (*d, lo, hi, lam)))
    assert launch_counts()["backward_sweep_packed"] == 0
    ref = pallas_backward.backward_sweep_batched(
        *(jnp.asarray(a) for a in (*d, lo, hi, lam)), interpret=True)
    for i, what in enumerate(("k", "K", "dV")):
        g = out[i].numpy().astype(np.float64)
        r = np.asarray(ref[i], np.float64)
        assert g.shape == r.shape, what
        np.testing.assert_allclose(g, r, rtol=BACKWARD_RTOL, atol=1e-6,
                                   err_msg=what)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert out[3].numpy()[3] and not out[3].numpy()[0]
    live = [0, 1, 2, 4]   # the box binds somewhere on the other lanes
    k = out[0].numpy()[live]
    assert np.any(np.isclose(k, lo[live]) | np.isclose(k, hi[live]))


def test_composable_batch_on_the_kernel_routes_matches_jax():
    """tests/test_custom_model.py:41-53's batch: the kernel routes forced
    on both sides (the port's plain kernel ops on the CPU, the JAX Pallas
    kernels in interpret mode)."""
    kw = dict(deriv_mode="analytic", clamp_forward=True, max_iter=3,
              rollout_kernel="pallas", deriv_kernel="pallas")
    rng = np.random.default_rng(0)
    x0 = (rng.normal(size=(3, 3)) * 0.2).astype(np.float32)
    u0 = np.zeros((10, 2), np.float32)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                jcm.default_params())
    want = jax_solve_batch(jcm.UNICYCLE, jp, JaxConfig(**kw), DT,
                           jnp.asarray(x0), jnp.asarray(u0))
    reset_launch_counts()
    got = solve_batch(tcm.UNICYCLE, tcm.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp)), SolverConfig(**kw), DT, x0,
        u0, device="cpu")
    assert launch_counts() == {k: 0 for k in launch_counts()}
    assert got.cost.shape == (3,)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=BATCH_RTOL)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
