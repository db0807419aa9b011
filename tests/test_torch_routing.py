"""The fused solver's route choice (whole-iteration kernel or the split
sweep + line search) against the JAX package's ``_use_iter_kernel`` at
each model's workload shape: acrobot at bench.py's T = 499, the double
integrator and the 3-D point mass at T = 99, the quadrotor and the m ≥ 5
models at T = 80 (experiments/secondary_bench.py). At these shapes the JAX
package's VMEM budget for the gain buffer holds, so its fit check (which
the port does not carry: on the card the gains live in device memory)
decides nothing. Also ``fused_applicable`` against the JAX package's, and
the m > 24 guard."""

import dataclasses

import numpy as np
import pytest

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu import get_model as jax_get_model
from ilqr_tpu.fused import _use_iter_kernel as jax_route
from ilqr_tpu.fused import fused_applicable as jax_applicable
from ilqr_tpu_torch import SolverConfig, fused, get_model, solve_batch_fused

WIDE = ("omni_thruster", "free_flyer", "thruster_ring", "thruster_ring16",
        "thruster_ring20", "thruster_ring24")


@pytest.mark.parametrize("name,T", [
    ("acrobot", 499), ("double_integrator", 99), ("point_mass_3d", 99),
    ("quadrotor", 80), *((name, 80) for name in WIDE)])
@pytest.mark.parametrize("iter_kernel", ["auto", "merged", "split"])
def test_auto_route_matches_jax(name, T, iter_kernel):
    jm = jax_get_model(name)
    want = jax_route(jm, JaxConfig(iter_kernel=iter_kernel), T, jm.n)
    got = fused._use_iter_kernel(get_model(name),
                                 SolverConfig(iter_kernel=iter_kernel))
    assert got == want


@pytest.mark.parametrize("name", WIDE)
@pytest.mark.parametrize("extra", [
    {}, dict(use_control_limits=False), dict(boxqp_mode="pn_fixed"),
    dict(boxqp_mode="iterative"), dict(sweep_kernel="split"),
    dict(full_ddp=True)])
def test_fused_applicable_matches_jax(name, extra):
    want = jax_applicable(jax_get_model(name), JaxConfig(**extra))
    assert fused.fused_applicable(get_model(name),
                                  SolverConfig(**extra)) == want
    if not extra:
        assert want


def test_wide_model_past_the_cap_raises():
    """m = 25 fails fast with ValueError, as the JAX package's fused solver
    does (tests/test_fused_solver.py:1033-1046)."""
    m25 = dataclasses.replace(get_model("free_flyer"), m=25)
    assert not fused.fused_applicable(m25, SolverConfig())
    with pytest.raises(ValueError, match="m <= 24"):
        solve_batch_fused(m25, get_model("free_flyer").default_params(),
                          SolverConfig(), 0.05, np.zeros((2, 6), np.float32),
                          np.zeros((2, 4, 25), np.float32), device="cpu")
