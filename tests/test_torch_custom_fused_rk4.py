"""The unicycle through ilqr_tpu_torch.solve_batch_fused (plain versions,
CPU) against the JAX fused solver (Pallas interpret mode) with analytic
derivatives and the RK4 step: the dual numbers through every RK4 stage of
a custom model. Problem, tolerances and routes as in
tests/test_torch_custom_fused_euler.py, whose helpers this file uses."""

import pytest

from test_torch_custom_fused_euler import (
    ROUTES,
    check_costs,
    check_trajectories,
    solve_both,
)

CASE = (("deriv_mode", "analytic"), ("integrator", "rk4"))


@pytest.fixture(scope="module", params=ROUTES)
def both(request):
    return solve_both(request.param, CASE)


def test_costs_iterations_reasons(both):
    check_costs(*both)


def test_controls_and_gains(both):
    check_trajectories(*both)
