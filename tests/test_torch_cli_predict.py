"""The CLI's fd batch solve (``chip_smoke.cli_workload``) through the port's
plain path on the CPU, on the first lanes of its x0 draw. Lanes are
independent, so these are the same problems as the first lanes of a card's
run at full width: this is the figure that run is held against, and, with
``nudge``, how far a move of every x0 component by that much carries the
same lanes (the acrobot at T = 499 is chaotic); with ``around``, how far
it carries one lane: that lane's x0 moved by k·nudge, k = -lanes/2 …
lanes/2 - 1.

    python tests/test_torch_cli_predict.py acrobot euler 64 [nudge] \
        [out.json] [around]

acrobot at 64 lanes takes ~12 min on one CPU core (rk4 ~19 min). The JSON
holds the mean cost, the initial rollout's, iterations, reasons and each
lane's cost.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from ilqr_tpu_torch import solve_batch_fused  # noqa: E402
from ilqr_tpu_torch.ops import kernel_rollout  # noqa: E402


def predict_on_cpu(name="acrobot", integrator="euler", lanes=64, nudge=0.0,
                   T=None, max_iter=None, around=None):
    """Solves lanes ``0 … lanes-1`` of ``name``'s CLI batch (B = 8192 draw)
    on the CPU, x0 moved by ``nudge`` (with ``around``: ``lanes`` copies of
    that lane, copy j moved by (j - lanes // 2)·nudge); ``T`` and
    ``max_iter`` cut the problem (None: the CLI's)."""
    model, params, cfg, T_cli, dt, u0, x0 = chip_smoke.cli_workload(
        name, chip_smoke.B_MAIN)
    T = T_cli if T is None else T
    cfg = cfg.replace(integrator=integrator, max_iter=(
        cfg.max_iter if max_iter is None else max_iter))
    if around is None:
        x0 = x0[:lanes] + np.float32(nudge)
    else:
        steps = np.arange(lanes, dtype=np.float32) - lanes // 2
        x0 = x0[around][None] + (np.float32(nudge) * steps)[:, None]
    u0 = u0[:T]
    pp = kernel_rollout.pack_params(params, dt)
    init = kernel_rollout.rollout_plain(
        model, integrator, cfg.clamp_forward, pp,
        torch.as_tensor(x0).t().contiguous(),
        torch.as_tensor(u0)[:, :, None].expand(T, model.m, lanes)
        .contiguous(), torch.zeros(T, model.n, lanes),
        torch.zeros(T, model.m, model.n, lanes))[3].numpy()
    sol = solve_batch_fused(model, params, cfg, dt, x0, u0, device="cpu")
    cost, iters = sol.cost.numpy(), sol.iterations.numpy()
    return dict(name=name, integrator=integrator, lanes=lanes, nudge=nudge,
                around=around, T=T, max_iter=cfg.max_iter,
                mean_cost=float(cost.mean()),
                init_mean_cost=float(init.mean()),
                mean_iters=float(iters.mean()), max_iters=int(iters.max()),
                lanes_above_initial=int((cost > init).sum()),
                reason_hist={int(k): int(v) for k, v in zip(*np.unique(
                    sol.reason.numpy(), return_counts=True))},
                costs=[float(c) for c in cost])


def test_predict_on_cpu_is_the_plain_solve_of_the_first_lanes():
    """A cut pendulum problem: every lane finite and at or below its initial
    cost, and lane i's cost that of lane i of a wider batch (lanes are
    independent; exact equality)."""
    two = predict_on_cpu("pendulum", lanes=2, T=20, max_iter=3)
    three = predict_on_cpu("pendulum", lanes=3, T=20, max_iter=3)
    assert np.isfinite(two["costs"]).all()
    assert two["lanes_above_initial"] == 0
    assert two["costs"] == three["costs"][:2]
    moved = predict_on_cpu("pendulum", lanes=2, T=20, max_iter=3, nudge=1e-3)
    assert moved["costs"] != two["costs"]
    spread = predict_on_cpu("pendulum", lanes=3, T=20, max_iter=3,
                            nudge=1e-3, around=1)
    assert spread["costs"][1] == two["costs"][1]   # its step 0


if __name__ == "__main__":
    name, integ, lanes = sys.argv[1], sys.argv[2], int(sys.argv[3])
    nudge = float(sys.argv[4]) if len(sys.argv) > 4 else 0.0
    around = int(sys.argv[6]) if len(sys.argv) > 6 else None
    torch.set_num_threads(1)
    out = predict_on_cpu(name, integ, lanes, nudge, around=around)
    text = json.dumps(out)
    print(text)
    if len(sys.argv) > 5:
        with open(sys.argv[5], "w") as fh:
            fh.write(text + "\n")
