"""Batched MPC fleet demo: thousands of receding-horizon controllers
stepping in lock-step on one card (counterpart of
``examples/mpc_fleet.py``, the BASELINE.json "batched MPC" config).

The fleet runs through ``ilqr_tpu_torch.mpc.fleet_init`` / ``fleet_step``
— the JAX package's own fleet MPC (``ilqr_tpu/mpc.py`` fleet_init,
fleet_step): each cycle applies every controller's first control with its
feedback, simulates one step, shifts the plans and re-plans the whole
fleet with one warm-started fused batch solve. The JAX script instead
vmaps the single controller's ``mpc_init`` / ``mpc_step`` (the composable
solver per controller).

  python -m ilqr_tpu_torch.examples.mpc_fleet --fleet 256 --steps 50 [--cpu]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleet", type=int, default=256)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--horizon", type=int, default=60)
    ap.add_argument("--model", default="double_integrator")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ilqr_tpu_torch import SolverConfig, get_model, mpc
    from ilqr_tpu_torch.solver import resolve_device
    from ilqr_tpu_torch.utils.timing import fence

    dev = resolve_device("cpu" if args.cpu else None)
    model = get_model(args.model)
    params = model.default_params()
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=25)
    dt = 0.05

    rng = np.random.default_rng(0)
    x0s = (rng.normal(size=(args.fleet, model.n)) * 0.4).astype(np.float32)
    u0 = np.zeros((args.horizon, model.m), np.float32)

    t0 = time.perf_counter()
    fleet = mpc.fleet_init(model, params, cfg, dt, x0s, u0, device=dev)
    fence(fleet.x)
    print(f"fleet of {args.fleet} planned cold in "
          f"{time.perf_counter() - t0:.2f}s "
          f"(mean cost {float(fleet.plan.cost.mean()):.4g})")

    goal = params.goal.to(dev, torch.float32)
    t0 = time.perf_counter()
    for step in range(args.steps):
        fleet = mpc.fleet_step(model, params, cfg, dt, fleet)
        if (step + 1) % 10 == 0:
            err = torch.linalg.norm(fleet.x - goal[None], dim=-1)
            print(f"step {step + 1:3d}: mean |x-goal| = "
                  f"{float(err.mean()):.4f}, mean replan iters = "
                  f"{float(fleet.plan.iterations.float().mean()):.1f}")
    fence(fleet.x)
    elapsed = time.perf_counter() - t0
    rate = args.fleet * args.steps / elapsed
    print(f"{args.steps} replanning cycles x {args.fleet} controllers in "
          f"{elapsed:.2f}s = {rate:.0f} replans/s")
    return fleet


if __name__ == "__main__":
    main()
