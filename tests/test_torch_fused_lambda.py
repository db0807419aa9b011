"""The fused solver's backward attempts are gated on λ ≤ λmax (ROADMAP.md
§C3), on the CPU's plain versions.

A warm start carries λ in; a fleet whose replans keep ending LAMBDA_MAX
grows it by dλ at each. At λ ≈ 1e37 the f32 sweep gives NaN gains with no
divergence flag, which the JAX fused solver's unconditional first attempt
keeps. Here a lane that enters above λmax makes no attempt and ends
LAMBDA_MAX after one iteration with its warm trajectory, as in the
composable solver; the other lanes of the same batch are the same as
when solved alone (exactly: lanes are independent).
"""

import numpy as np
import pytest
import torch

from ilqr_tpu_torch import (
    SolverConfig,
    TerminationReason,
    get_model,
    solve_batch_fused,
    solve_batch_fused_warm,
)

B, T, DT = 4, 10, 0.05


@pytest.mark.parametrize("route", [dict(), dict(iter_kernel="split")])
def test_lanes_above_lambda_max_make_no_attempt(route):
    model = get_model("double_integrator")
    params = model.default_params()
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=5, **route)
    rng = np.random.default_rng(0)
    x0 = (0.4 * rng.normal(size=(B, 4))).astype(np.float32)
    u0 = np.zeros((T, 2), np.float32)
    cold = solve_batch_fused(model, params, cfg, DT, x0, u0, device="cpu")
    # lanes 1 and 3 carry λ from far above λmax in, 1.4e37 as the fleet
    # reached it
    lam = cold.lam.clone()
    lam[1], lam[3] = 1.4e37, 2.0 * cfg.lambda_max
    prev = cold._replace(lam=lam)
    warm = solve_batch_fused_warm(model, params, cfg, DT, x0, prev,
                                  device="cpu")
    for a in warm:
        assert torch.isfinite(a.float()).all()
    reason = int(TerminationReason.LAMBDA_MAX)
    for b in (1, 3):
        assert int(warm.reason[b]) == reason
        assert int(warm.iterations[b]) == 1
        # no step: the warm rollout of prev (the same x0: prev's own
        # trajectory) stays, and with it its cost
        assert torch.equal(warm.xs[b], cold.xs[b])
        assert torch.equal(warm.us[b], cold.us[b])
        assert float(warm.cost[b]) == float(cold.cost[b])
    for b in (0, 2):
        alone = solve_batch_fused_warm(
            model, params, cfg, DT, x0[b:b + 1],
            prev._replace(**{f: getattr(prev, f)[b:b + 1]
                             for f in prev._fields}), device="cpu")
        for got, want in zip(warm, alone):
            assert torch.equal(got[b:b + 1], want)


def test_fleet_mpc_stays_finite_when_lambda_overflows():
    """examples/mpc_fleet.py's fleet (double integrator, horizon 60,
    max_iter 25), its controllers 8, 20 and 28 of 64 (lanes are
    independent): their replans keep ending LAMBDA_MAX, λ passes 1e37 at
    step 7, and an attempt there made the plan NaN at step 8."""
    from ilqr_tpu_torch import mpc

    model = get_model("double_integrator")
    params = model.default_params()
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=25)
    x0s = (np.random.default_rng(0).normal(size=(64, 4)) * 0.4).astype(
        np.float32)[[8, 20, 28]]
    fleet = mpc.fleet_init(model, params, cfg, 0.05, x0s,
                           np.zeros((60, 2), np.float32), device="cpu")
    for _ in range(9):
        fleet = mpc.fleet_step(model, params, cfg, 0.05, fleet)
    assert float(fleet.plan.lam.min()) > cfg.lambda_max
    for a in (fleet.x, fleet.plan.xs, fleet.plan.us, fleet.plan.K,
              fleet.plan.cost):
        assert torch.isfinite(a).all()


@pytest.mark.parametrize("lam1", [2.0, 1.4e26])
@pytest.mark.parametrize("route", [dict(), dict(iter_kernel="split")])
def test_retry_of_another_lane_leaves_lanes_above_lambda_max(route, lam1):
    """Lane 0 retries its backward attempt (it carries a negative λ in, so
    its first sweep diverges and λ escalates to λmin) while lane 1 carries
    λ = lam1·λmax in (1.4e37 at the larger, as the fleet reached it). The
    retry re-runs only the lanes that may attempt: lane 1 keeps its zero
    gains (a sweep at 2·λmax gives gains of ~1e-12), ends LAMBDA_MAX and
    stays finite, and lane 0 is the same as when solved alone."""
    from ilqr_tpu_torch import fused

    model = get_model("double_integrator")
    params = model.default_params()
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=5, **route)
    rng = np.random.default_rng(0)
    x0 = (0.4 * rng.normal(size=(3, 4))).astype(np.float32)
    u0 = np.zeros((T, 2), np.float32)
    cold = solve_batch_fused(model, params, cfg, DT, x0, u0, device="cpu")
    lam = cold.lam.clone()
    lam[0], lam[1] = -1e6, lam1 * cfg.lambda_max
    prev = cold._replace(lam=lam)
    retried = fused._iteration.retried
    warm = solve_batch_fused_warm(model, params, cfg, DT, x0, prev,
                                  device="cpu")
    assert fused._iteration.retried > retried
    for a in warm:
        assert torch.isfinite(a.float()).all()
    assert int(warm.reason[1]) == int(TerminationReason.LAMBDA_MAX)
    assert int(warm.iterations[1]) == 1
    assert not warm.k[1].any() and not warm.K[1].any()
    assert torch.equal(warm.xs[1], cold.xs[1])
    alone = solve_batch_fused_warm(
        model, params, cfg, DT, x0[:1],
        prev._replace(**{f: getattr(prev, f)[:1] for f in prev._fields}),
        device="cpu")
    for got, want in zip(warm, alone):
        assert torch.equal(got[:1], want)
