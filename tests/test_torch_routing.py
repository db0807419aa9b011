"""The fused solver's route choice (whole-iteration kernel or the split
sweep + line search) against the JAX package's ``_use_iter_kernel`` at
each model's workload shape: acrobot at bench.py's T = 499, the double
integrator and the 3-D point mass at T = 99 and the quadrotor at T = 80
(experiments/secondary_bench.py). At these shapes the JAX package's VMEM
budget for the gain buffer holds, so its fit check (which the port does
not carry: on the card the gains live in device memory) decides nothing."""

import pytest

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu import get_model as jax_get_model
from ilqr_tpu.fused import _use_iter_kernel as jax_route
from ilqr_tpu_torch import SolverConfig, fused, get_model


@pytest.mark.parametrize("name,T", [
    ("acrobot", 499), ("double_integrator", 99), ("point_mass_3d", 99),
    ("quadrotor", 80)])
@pytest.mark.parametrize("iter_kernel", ["auto", "merged", "split"])
def test_auto_route_matches_jax(name, T, iter_kernel):
    jm = jax_get_model(name)
    want = jax_route(jm, JaxConfig(iter_kernel=iter_kernel), T, jm.n)
    got = fused._use_iter_kernel(get_model(name),
                                 SolverConfig(iter_kernel=iter_kernel))
    assert got == want
