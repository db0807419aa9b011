"""The composable solver lays the backward kernel's inputs out once per
iteration, not once per λ attempt (ops/backward.py ``backward_inputs``,
ops/kernel_backward.py ``pack_backward_inputs``), on the CPU where the
backward op runs its plain version:

- a solve whose first iteration retries every lane (λ starts below zero,
  so QuuF ≤ 0 latches ``diverged`` and λ escalates to λmin) counts more
  backward attempts than iterations and exactly one layout per iteration;
- its result is bit for bit the result of laying the inputs out on every
  attempt;
- the derivatives reach the kernel as the lane-last arrays they were
  computed in: only the limit offsets are new tensors.
"""

import numpy as np
import torch

from ilqr_tpu_torch import SolverConfig, get_model, solver
from ilqr_tpu_torch.batch import solve_batch
from ilqr_tpu_torch.ops import backward, derivatives, kernel_backward
from ilqr_tpu_torch.ops.kernel_rollout import pack_params

B, T = 3, 8


def _solve(cfg, x0, u0):
    model = get_model("pendulum")
    return solve_batch(model, model.default_params(), cfg, 0.05, x0, u0,
                       device="cpu")


def _problem():
    rng = np.random.default_rng(0)
    x0 = np.stack([np.pi + 0.1 * rng.normal(size=B), np.zeros(B)], -1)
    return x0.astype(np.float32), np.zeros((B, T, 1), np.float32)


def test_relayout_once_per_iteration_whatever_the_attempts(monkeypatch):
    cfg = SolverConfig(max_iter=3, lambda_init=-1e3)
    attempts = []
    lanes = backward.backward_sweep_lanes

    def counted(packed, lam):
        attempts.append(1)
        return lanes(packed, lam)

    monkeypatch.setattr(backward, "backward_sweep_lanes", counted)
    relayouts = kernel_backward.pack_backward_inputs.relayouts
    calls = solver.ilqr_iteration.calls
    sol = _solve(cfg, *_problem())
    iterations = solver.ilqr_iteration.calls - calls
    assert iterations >= 2 and len(attempts) > iterations
    assert kernel_backward.pack_backward_inputs.relayouts - relayouts == (
        iterations)
    assert np.isfinite(sol.cost.numpy()).all()


def test_hoisted_layout_is_bitwise_the_per_attempt_one(monkeypatch):
    cfg = SolverConfig(max_iter=4, lambda_init=-1e3)
    problem = _problem()
    once = _solve(cfg, *problem)
    # every attempt lays its inputs out itself, as before the hoist
    monkeypatch.setattr(solver, "backward_inputs", lambda *a, **k: None)
    relayouts = kernel_backward.pack_backward_inputs.relayouts
    calls = solver.ilqr_iteration.calls
    every = _solve(cfg, *problem)
    assert kernel_backward.pack_backward_inputs.relayouts - relayouts > (
        solver.ilqr_iteration.calls - calls)
    for a, b in zip(once, every):
        assert torch.equal(a, b)


def test_derivatives_reach_the_kernel_without_a_copy():
    model = get_model("pendulum")
    cfg = SolverConfig()
    pp = pack_params(model.default_params(), 0.05, torch.device("cpu"))
    rng = np.random.default_rng(1)
    xs = torch.as_tensor(rng.normal(size=(B, T + 1, 2)), dtype=torch.float32)
    us = torch.as_tensor(rng.normal(size=(B, T, 1)), dtype=torch.float32)
    d = derivatives.compute_derivs(model, pp, cfg, xs, us)
    lim = torch.ones(1)
    packed = backward.backward_inputs(d, us, -lim, lim, cfg)
    fx, fu, cx, cu, cxx, cxu, cuu, lo, hi, cxT, cxxT = packed
    for arr, src in ((fx, d.fx), (fu, d.fu), (cx, d.cx), (cu, d.cu),
                     (cxx, d.cxx), (cxu, d.cxu), (cuu, d.cuu), (cxT, d.cx),
                     (cxxT, d.cxx)):
        assert arr.untyped_storage().data_ptr() == (
            src.untyped_storage().data_ptr())
    assert torch.equal(lo, (-1.0 - us[..., 0]).t())
    assert torch.equal(hi, (1.0 - us[..., 0]).t())
