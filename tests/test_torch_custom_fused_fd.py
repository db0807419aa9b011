"""The unicycle through ilqr_tpu_torch.solve_batch_fused (plain versions,
CPU) against the JAX fused solver (Pallas interpret mode) with the
reference's central stencils (deriv_mode="fd") and the Euler step, at
eps = 0.05: at the default 1e-3 an ulp of a cost near 1e2 becomes ~4 in a
stencil Hessian (ulp/(4·eps²)), which XLA:CPU's fused multiply-adds and the
port's two roundings split (ROADMAP §C); at 0.05 it is ~8e-4.
Problem, tolerances and routes as in tests/test_torch_custom_fused_euler.py,
whose helpers this file uses, but for the controls and gains: that Hessian
noise moves them by its own size (measured on the merged route: costs
2.4e-7 relative, |Δus| 1.07e-4, |Δk| 1.5e-4, |ΔK| 9.3e-4), so they are held
to FD_ATOL = 2e-3."""

import pytest

from test_torch_custom_fused_euler import (
    ROUTES,
    check_costs,
    check_trajectories,
    solve_both,
)

CASE = (("deriv_mode", "fd"), ("integrator", "euler"), ("fd_eps", 0.05))
FD_ATOL = 2e-3


@pytest.fixture(scope="module", params=ROUTES)
def both(request):
    return solve_both(request.param, CASE)


def test_costs_iterations_reasons(both):
    check_costs(*both)


def test_controls_and_gains(both):
    check_trajectories(*both, atol=FD_ATOL)
