"""Whole composable solves of the remaining m ≥ 2 models and QP modes
against the JAX package (the problems and bounds of
tests/test_torch_composable_solve.py, which this file shares so that the
two run side by side): thruster_ring (m = 12) and the rings 16, 20, 24
with the iterative box QP ("iterative", "auto") and RK4, the double
integrator with the enumeration QP, with per-problem params and with the
reference's stencils and RK4 (the stencils' f32 noise moves a trig
model's controls by ~5e-2 within four iterations, beyond the controls'
bound, so they run on the model without trig; ROADMAP.md §C); and the
m = 1 models through the scan's QPs rather than the closed form
(pendulum with pn_fixed, cartpole with the iterative QP and RK4)."""

import pytest

from test_torch_composable_solve import compare


@pytest.mark.parametrize("name,extra", [
    ("thruster_ring", dict(boxqp_mode="iterative")),
    ("thruster_ring16", {}),
    ("thruster_ring20", dict(integrator="rk4")),
    ("thruster_ring24", {}),
    ("double_integrator", dict(boxqp_mode="enum")),
    ("double_integrator", dict(deriv_mode="fd", integrator="rk4")),
    ("pendulum", dict(boxqp_mode="pn_fixed")),
    ("cartpole", dict(boxqp_mode="iterative", integrator="rk4")),
])
def test_solve_batch_matches_jax(name, extra):
    compare(name, **extra)


def test_per_problem_params_match_jax():
    compare("double_integrator", params_batched=True, seed=4)
