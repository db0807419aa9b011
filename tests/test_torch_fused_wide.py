"""Whole fused solves at 5 ≤ m ≤ 24 on the CPU (the port's plain versions,
projected Newton in the sweep) against the JAX package.

omni_thruster (m = 6), free_flyer (m = 8) and thruster_ring (m = 12),
each with control limits and without, and thruster_ring16 and
thruster_ring24 (m = 16, 24) with limits, at T = 8, B = 2, max_iter = 4,
dt = 0.05, held against the JAX package's XLA path ``ilqr_tpu.batch.solve_batch``
with ``boxqp_mode="pn_fixed"`` (ops/boxqp.py:257-334: the same m + 6
iteration ladder in matrix form) and the XLA derivative, backward and
rollout routes: costs to rtol 1e-3, controls within 2e-2 (the bounds of
tests/test_fused_solver.py:418-423), controls inside the box, and with
limits more than 30% of them exactly on the lower bound (the one-sided
thrusters pin it; tests/test_fused_solver.py:423,991). The JAX fused
solver is not run here: in interpret mode at m ≥ 5 it takes minutes
(tests/test_fused_solver.py:1007-1010).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu import get_model as jax_get_model
from ilqr_tpu.batch import solve_batch as jax_solve_batch
from ilqr_tpu.models import omni_thruster as jot
from ilqr_tpu_torch import SolverConfig, fused, get_model, solve_batch_fused
from ilqr_tpu_torch.models import free_flyer as tff
from ilqr_tpu_torch.models import omni_thruster as tot
from ilqr_tpu_torch.models import thruster_ring as ttr

FAST_ALPHAS = (1.0, 0.3, 0.03)
T, DT = 8, 0.05
PORT = {"omni_thruster": tot, "free_flyer": tff, "thruster_ring": ttr,
        "thruster_ring16": ttr, "thruster_ring24": ttr}


def _problem(name):
    """(JAX params, port params, x0 (2, 6), u0 (T, m)) as the workloads of
    experiments/secondary_bench.py draw them, cut to 2 lanes and T = 8."""
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                jax_get_model(name).default_params())
    tp = PORT[name].params_from_numpy(jp)
    m = jax_get_model(name).m
    if name == "omni_thruster":
        x0 = 0.2 * np.random.default_rng(5).normal(size=(2, 6))
        u0 = np.tile(np.asarray(jot.hover_control(jp))[None], (T, 1))
    elif name == "free_flyer":
        x0 = 0.3 * np.random.default_rng(9).normal(size=(2, 6))
        u0 = np.zeros((T, m))
    else:
        x0 = 0.2 * np.random.default_rng(0).normal(size=(2, 6))
        u0 = np.zeros((T, m))
    return (jax.tree_util.tree_map(jnp.asarray, jp), tp,
            x0.astype(np.float32), u0.astype(np.float32))


@pytest.mark.parametrize("name,use_limits,iter_kernel", [
    ("omni_thruster", True, "auto"),
    ("omni_thruster", False, "auto"),
    ("omni_thruster", True, "merged"),
    ("free_flyer", True, "auto"),
    ("free_flyer", False, "auto"),
    ("thruster_ring", True, "auto"),
    ("thruster_ring", False, "auto"),
    ("thruster_ring16", True, "auto"),
    ("thruster_ring24", True, "auto"),
])
def test_wide_solve_matches_jax_xla(name, use_limits, iter_kernel):
    jp, tp, x0, u0 = _problem(name)
    kw = dict(deriv_mode="analytic", clamp_forward=use_limits,
              use_control_limits=use_limits, max_iter=4, alphas=FAST_ALPHAS)
    ref = jax_solve_batch(
        jax_get_model(name), jp,
        JaxConfig(boxqp_mode="pn_fixed", backward_kernel="xla",
                  rollout_kernel="xla", deriv_kernel="xla", **kw),
        DT, jnp.asarray(x0), jnp.asarray(u0))
    model = get_model(name)
    cfg = SolverConfig(iter_kernel=iter_kernel, **kw)
    # auto takes the split iteration for these models (m·n ≥ 32)
    assert fused._use_iter_kernel(model, cfg) == (iter_kernel == "merged")
    got = solve_batch_fused(model, tp, cfg, DT, x0, u0, device="cpu")
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-3)
    us = got.us.numpy()
    assert np.abs(us - np.asarray(ref.us)).max() < 2e-2
    assert got.us.shape == (2, T, model.m)
    assert got.K.shape == (2, T, model.m, model.n)
    assert np.all(np.isfinite(got.cost.numpy()))
    if use_limits:
        u_max = float(tp.u_max[0])
        assert us.min() >= -1e-6 and us.max() <= u_max + 1e-5
        assert (us <= 1e-5).mean() > 0.3, (us <= 1e-5).mean()
