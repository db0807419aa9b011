"""Batched quadrotor waypoint solves — the m = 4 workload end to end
(counterpart of ``examples/quadrotor_waypoints.py``).

Solves B independent quadrotor trajectory-optimization problems (n = 12
states, 4 per-rotor thrusts in an asymmetric [0, f_max] box) in one
batched call. On the card the fused solver runs the whole iLQR loop in its
CUDA kernels with the exact 81-candidate box QP; pass --vmap for the
composable ``solve_batch`` path (also the CPU default, as the JAX script
takes its vmap path off the TPU).

  python -m ilqr_tpu_torch.examples.quadrotor_waypoints --batch 256 [--cpu] [--vmap]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--horizon", type=int, default=80)
    ap.add_argument("--max-iter", type=int, default=40)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    ap.add_argument("--vmap", action="store_true",
                    help="composable solve_batch path instead of fused")
    args = ap.parse_args(argv)

    import numpy as np

    from ilqr_tpu_torch import (
        SolverConfig,
        get_model,
        solve_batch,
        solve_batch_fused,
    )
    from ilqr_tpu_torch.models import quadrotor as qd
    from ilqr_tpu_torch.solver import resolve_device
    from ilqr_tpu_torch.utils.timing import fence

    dev = resolve_device("cpu" if args.cpu else None)
    model = get_model("quadrotor")
    params = qd.default_params()
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=args.max_iter)

    B, T = args.batch, args.horizon
    rng = np.random.default_rng(0)
    x0 = (0.1 * rng.normal(size=(B, 12))).astype(np.float32)
    u0 = qd.hover_control(params)[None].float().expand(T, 4)

    use_vmap = args.vmap or dev.type != "cuda"
    run = solve_batch if use_vmap else solve_batch_fused
    solver = lambda x: run(model, params, cfg, 0.02, x, u0, device=dev)

    t0 = time.perf_counter()
    sol = solver(x0)
    fence(sol.cost)
    print(f"first call (incl. compile): {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    sol = solver((0.1 * rng.normal(size=(B, 12))).astype(np.float32))
    costs = sol.cost.cpu().numpy()
    dt_s = time.perf_counter() - t0
    us = sol.us.cpu().numpy()
    print(f"{B} solves in {dt_s:.3f}s -> {B / dt_s:.0f} solves/s "
          f"({'vmap' if use_vmap else 'fused'} path)")
    print(f"mean cost {costs.mean():.2f}, mean iters "
          f"{float(sol.iterations.float().mean()):.1f}, thrust range "
          f"[{us.min():.3f}, {us.max():.3f}] (box [0, 3])")
    xf = sol.xs[:, -1, :3].cpu().numpy()
    goal = params.goal[:3].numpy()
    print(f"median final position error "
          f"{np.median(np.linalg.norm(xf - goal, axis=1)):.3f} m")
    return sol


if __name__ == "__main__":
    main()
