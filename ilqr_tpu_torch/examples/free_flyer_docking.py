"""Per-problem batched params: a fleet of free-flyers docking at DIFFERENT
ports in one solve (counterpart of ``examples/free_flyer_docking.py``).

Every problem in the batch has its own goal (docking port) and its own
thrust ceiling (degraded thrusters): ``params_batched=True`` packs one row
of params per lane, which each kernel reads for its own lane — something
the reference's virtual-dispatch models (one goal baked into the object,
include/model.h:17-18) structurally cannot do. Uses the m = 8
``free_flyer``.

  python -m ilqr_tpu_torch.examples.free_flyer_docking --batch 256 [--cpu] [--vmap]
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
    from ilqr_tpu_torch.models import free_flyer as ff
    from ilqr_tpu_torch.solver import resolve_device
    from ilqr_tpu_torch.utils.timing import fence

    dev = resolve_device("cpu" if args.cpu else None)
    model = get_model("free_flyer")
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=args.max_iter)

    B, T = args.batch, args.horizon
    rng = np.random.default_rng(0)

    # Per-problem params: docking ports on a ring, per-craft thrust limits.
    base = ff.default_params()
    theta = 2.0 * np.pi * rng.uniform(size=B)
    goals = np.zeros((B, 6), np.float32)
    goals[:, 0] = 2.0 * np.cos(theta)
    goals[:, 1] = 2.0 * np.sin(theta)
    goals[:, 2] = rng.uniform(-0.5, 0.5, size=B)
    fmax = rng.uniform(2.5, 4.0, size=B).astype(np.float32)  # degraded units
    params = type(base)(*[np.repeat(np.asarray(leaf, np.float32)[None], B,
                                    axis=0) for leaf in base])
    params = params._replace(goal=goals,
                             u_max=np.repeat(fmax[:, None], 8, axis=1))

    x0 = (0.2 * rng.normal(size=(B, 6))).astype(np.float32)
    u0 = np.zeros((T, 8), np.float32)  # microgravity coasting start

    use_vmap = args.vmap or dev.type != "cuda"
    run = solve_batch if use_vmap else solve_batch_fused
    solver = lambda x: run(model, params, cfg, 0.05, x, u0, device=dev,
                           params_batched=True)

    t0 = time.perf_counter()
    sol = solver(x0)
    fence(sol.cost)
    print(f"first call (incl. compile): {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    sol = solver((0.2 * rng.normal(size=(B, 6))).astype(np.float32))
    costs = sol.cost.cpu().numpy()
    dt_s = time.perf_counter() - t0
    us = sol.us.cpu().numpy()
    print(f"{B} solves in {dt_s:.3f}s -> {B / dt_s:.0f} solves/s "
          f"({'vmap' if use_vmap else 'fused'} path)")
    xf = sol.xs[:, -1, :3].cpu().numpy()
    err = np.linalg.norm(xf - goals[:, :3], axis=1)
    print(f"mean cost {costs.mean():.2f}, mean iters "
          f"{float(sol.iterations.float().mean()):.1f}, "
          f"median docking error {np.median(err):.3f} m")
    # every craft respects ITS OWN thrust ceiling
    peak = us.max(axis=(1, 2))
    assert (peak <= fmax + 1e-4).all(), "per-problem u_max violated"
    print(f"per-craft peak thrust within own ceiling: "
          f"{(peak <= fmax + 1e-4).mean():.0%} "
          f"(ceilings {fmax.min():.2f}-{fmax.max():.2f})")
    return sol


if __name__ == "__main__":
    main()
