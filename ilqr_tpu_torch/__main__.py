"""CLI entry point: ``python -m ilqr_tpu_torch {acrobot|integrator|...}``
(counterpart of ``ilqr_tpu/__main__.py``).

Mirrors the reference CLI (ref: src/run_ilqr.cpp:6-65) — the same two
canonical workloads, the same iteration table (SHOWPROGRESS), the same
output CSV — plus the flags the reference hard-codes: horizon, dt,
derivative mode, corrected-mode toggles, batch size and the device. It
takes every option of ``python -m ilqr_tpu`` with the same defaults and
choices.

It runs on the card unless ``--cpu`` asks for the plain PyTorch versions,
and raises without a card otherwise. A batch (``--batch B``) goes to the
fused solver (``solve_batch_fused``) on the card when it takes the
configuration, as the JAX CLI sends it there on a TPU, and to the
composable ``solve_batch`` otherwise; a single problem to ``solve_verbose``
(the reference's table) or, with ``--quiet``, ``solve``. ``--x64``,
``--full-ddp`` (ROADMAP.md §A4) and the associative-scan backward passes
(§A6) are not ported and raise ``NotImplementedError`` before anything
runs.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ilqr_tpu_torch",
        description="iLQR/DDP trajectory optimization on an NVIDIA GPU "
                    "(PyTorch and CUDA)",
    )
    p.add_argument(
        "problem",
        choices=["acrobot", "integrator", "double_integrator", "pendulum",
                 "cartpole", "bicycle", "free_flyer", "omni_thruster",
                 "point_mass_3d", "power_mass", "quadrotor",
                 "thruster_ring", "thruster_ring16", "thruster_ring20",
                 "thruster_ring24"],
        help="canonical workload to solve (ref: run_ilqr.cpp:8-12)",
    )
    p.add_argument("--dt", type=float, default=None,
                   help="timestep (default: the problem's canonical value;"
                        " the reference uses 0.02 for both its workloads)")
    p.add_argument("--horizon", "-T", type=int, default=None,
                   help="horizon; defaults to the reference's per-problem value")
    p.add_argument("--max-iter", type=int, default=100)
    p.add_argument("--deriv-mode", choices=["analytic", "fd"], default="fd",
                   help="fd = reference-parity central differences")
    p.add_argument("--clamp-forward", action="store_true",
                   help="corrected mode: clamp controls in the rollout "
                        "(the reference does not, ilqr_core.cpp:322-329)")
    p.add_argument("--no-control-limits", action="store_true")
    p.add_argument("--full-ddp", action="store_true",
                   help="include exact second-order dynamics terms "
                        "(Vx·fxx etc.) in the backward pass — Tassa's "
                        "full_DDP; not ported yet (ROADMAP.md §A4)")
    p.add_argument("--integrator-scheme", choices=["euler", "rk4"],
                   default="euler")
    p.add_argument("--boxqp-mode",
                   choices=["auto", "iterative", "enum", "pn_fixed"],
                   default="auto",
                   help="inner QP: closed-form/enum exact solves (auto/"
                        "enum), the reference-semantics projected Newton "
                        "(iterative, ref src/boxqp.cpp), or the fixed-"
                        "shape projected Newton for any m (pn_fixed)")
    p.add_argument("--sweep-kernel", choices=["merged", "split"],
                   default="merged",
                   help="fused solver: merged linearize+backward kernel or "
                        "split derivative+backward kernels")
    p.add_argument("--backward-mode",
                   choices=["scan", "assoc", "assoc_frozen"],
                   default="scan",
                   help="assoc = parallel-in-time associative-scan backward "
                        "(unconstrained problems only); assoc_frozen = its "
                        "control-limited extension; neither is ported yet "
                        "(ROADMAP.md §A6)")
    p.add_argument("--iter-kernel", choices=["auto", "merged", "split"],
                   default="auto",
                   help="fused solver: run the whole iteration (backward + "
                        "line search) as ONE kernel launch (merged), or as "
                        "two kernels (split); auto takes the split route "
                        "for m·n >= 32")
    p.add_argument("--batch", type=int, default=0,
                   help="solve a batch of B perturbed problems instead of one")
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch versions on the CPU (the "
                        "default is the card)")
    p.add_argument("--x64", action="store_true",
                   help="float64 (parity with the double-precision "
                        "reference); not ported yet (ROADMAP.md §A4)")
    p.add_argument("--output", default="ilqr_result.csv",
                   help="trajectory CSV path (ref hardcodes ilqr_result.csv)")
    p.add_argument("--quiet", action="store_true",
                   help="skip the per-iteration table (single solve)")
    p.add_argument("--profile", action="store_true",
                   help="print the per-phase timing breakdown (the "
                        "reference's TIMESTUFF report, ilqr_core.cpp:290-298)")
    p.add_argument("--plot", metavar="PNG",
                   help="save a state/control plot of the result")
    return p


# Canonical problem setups (ref: src/run_ilqr.cpp:18-54).
_PROBLEMS = {
    "integrator": dict(model="double_integrator", T=99,
                       goal=(1.0, 0.5, 0.0, 0.0),
                       x0=(-1.0, 0.0, 0.0, -0.2)),
    "double_integrator": dict(model="double_integrator", T=99,
                              goal=(1.0, 0.5, 0.0, 0.0),
                              x0=(-1.0, 0.0, 0.0, -0.2)),
    "acrobot": dict(model="acrobot", T=499, goal=None, x0=(0.0, 0.0, 0.0, 0.0)),
    "pendulum": dict(model="pendulum", T=199, goal=None, x0=(0.0, 0.0)),
    "cartpole": dict(model="cartpole", T=299, goal=None,
                     x0=(0.0, 0.0, 0.0, 0.0)),
    "point_mass_3d": dict(model="point_mass_3d", T=99, goal=None,
                          x0=(0.0,) * 6),
    # kinematic bicycle lane change: dt=0.05 (driving timescale)
    "bicycle": dict(model="bicycle", T=100, goal=None, x0=(0.0,) * 4,
                    dt=0.05),
    # power-limited point mass: live cost cross terms (cxu != 0)
    "power_mass": dict(model="power_mass", T=120, goal=None, x0=(0.0,) * 4,
                       dt=0.05),
    # quadrotor launches from rest with hover thrust as the initial
    # control sequence (zero thrust would free-fall the initial rollout)
    "quadrotor": dict(model="quadrotor", T=120, goal=None, x0=(0.0,) * 12,
                      u0="hover"),
    # 6-thruster craft: one-sided thrust boxes; starts at gravity-cancel
    # hover thrust (zero thrust free-falls the initial rollout)
    "omni_thruster": dict(model="omni_thruster", T=120, goal=None,
                          x0=(0.0,) * 6, dt=0.05, u0="hover"),
    # 8-thruster microgravity free-flyer: zero thrust is the natural
    # initial control (no gravity)
    "free_flyer": dict(model="free_flyer", T=120, goal=None,
                       x0=(0.0,) * 6, dt=0.05),
    # 12-thruster planar ring (the fused solver's projected-Newton QP)
    "thruster_ring": dict(model="thruster_ring", T=100, goal=None,
                          x0=(0.0,) * 6, dt=0.05),
    # 16-, 20- and 24-thruster rings (24 is the fused solver's widest m)
    "thruster_ring16": dict(model="thruster_ring16", T=100, goal=None,
                            x0=(0.0,) * 6, dt=0.05),
    "thruster_ring20": dict(model="thruster_ring20", T=100, goal=None,
                            x0=(0.0,) * 6, dt=0.05),
    "thruster_ring24": dict(model="thruster_ring24", T=100, goal=None,
                            x0=(0.0,) * 6, dt=0.05),
}


def check_ported(args) -> None:
    """Raises for the options the port does not carry yet, before any
    device is touched: ``--x64`` and ``--full-ddp`` (ROADMAP.md §A4) and
    the associative-scan backward passes (§A6). The JAX CLI's own parser
    error for ``--backward-mode assoc`` with control limits stays."""
    if args.x64:
        raise NotImplementedError(
            "--x64 (float64) is not ported yet (ROADMAP.md §A4): the port "
            "runs float32")
    if args.full_ddp:
        raise NotImplementedError(
            "--full-ddp is not ported yet (ROADMAP.md §A4)")
    if args.backward_mode == "assoc" and not args.no_control_limits:
        build_parser().error(
            "--backward-mode assoc requires --no-control-limits "
            "(the associative-scan backward is unconstrained-only)")
    if args.backward_mode != "scan":
        raise NotImplementedError(
            f"--backward-mode {args.backward_mode} (the parallel-in-time "
            "associative scan) is not ported yet (ROADMAP.md §A6)")


def problem(name: str, horizon=None):
    """(model, params, T, dt default, x0 (n,), u0 (T, m)) of a canonical
    problem, f32 tensors on the CPU."""
    from ilqr_tpu_torch import get_model

    spec = _PROBLEMS[name]
    model = get_model(spec["model"])
    params = (model.default_params(goal=spec["goal"]) if spec["goal"]
              else model.default_params())
    T = horizon or spec["T"]
    x0 = torch.tensor(spec["x0"], dtype=torch.float32)
    if spec.get("u0") == "hover":
        if spec["model"] == "quadrotor":
            from ilqr_tpu_torch.models import quadrotor as hover_mod
        else:
            from ilqr_tpu_torch.models import omni_thruster as hover_mod
        u0 = hover_mod.hover_control(params)[None].to(torch.float32).expand(
            T, model.m).contiguous()
    else:
        u0 = torch.zeros((T, model.m), dtype=torch.float32)
    return model, params, T, spec.get("dt", 0.02), x0, u0


def batch_x0(x0: torch.Tensor, batch: int) -> torch.Tensor:
    """The batch of perturbed problems: x0 + 0.05·normal (B, n) from
    ``default_rng(0)``, in f32 as the JAX CLI draws it."""
    rng = np.random.default_rng(0)
    noise = torch.from_numpy(
        rng.normal(size=(batch, x0.shape[0])).astype(np.float32))
    return x0[None] + 0.05 * noise


def config(args):
    """The SolverConfig of the parsed ``args``."""
    from ilqr_tpu_torch import SolverConfig

    return SolverConfig(
        max_iter=args.max_iter,
        deriv_mode=args.deriv_mode,
        clamp_forward=args.clamp_forward,
        use_control_limits=not args.no_control_limits,
        integrator=args.integrator_scheme,
        boxqp_mode=args.boxqp_mode,
        sweep_kernel=args.sweep_kernel,
        backward_mode=args.backward_mode,
        iter_kernel=args.iter_kernel,
    )


def run(args):
    """Solves what the parsed ``args`` ask for, prints the reference's
    lines and writes the CSV; returns the Solution (with a leading batch
    axis for ``--batch``)."""
    from ilqr_tpu_torch import solve, solve_verbose
    from ilqr_tpu_torch.batch import convergence_stats, solve_batch
    from ilqr_tpu_torch.fused import fused_applicable, solve_batch_fused
    from ilqr_tpu_torch.solver import resolve_device
    from ilqr_tpu_torch.utils.io import write_trajectory_csv
    from ilqr_tpu_torch.utils.timing import fence

    check_ported(args)
    dev = resolve_device("cpu" if args.cpu else None)
    model, params, T, dt_default, x0, u0 = problem(args.problem,
                                                   args.horizon)
    if args.dt is None:
        args.dt = dt_default

    cfg = config(args)

    print(f"[ilqr_tpu_torch] {args.problem}: n={model.n} m={model.m} T={T} "
          f"dt={args.dt} deriv={cfg.deriv_mode} device={dev.type}")

    def wrote(writer, what):
        print(f"Wrote {what} to {args.output}")
        print(f"[ilqr_tpu_torch] {args.output}: {writer} CSV writer",
              file=sys.stderr)

    if args.batch:
        x0b = batch_x0(x0, args.batch)
        t0 = time.perf_counter()
        # the fused solver on the card, as the JAX CLI takes it on a TPU
        if (dev.type == "cuda" and fused_applicable(model, cfg)
                and cfg.backward_mode == "scan"):
            sol = solve_batch_fused(model, params, cfg, args.dt, x0b, u0,
                                    device=dev)
        else:
            sol = solve_batch(model, params, cfg, args.dt, x0b, u0,
                              device=dev)
        fence(sol.cost)
        elapsed = time.perf_counter() - t0
        stats = {k: float(v) for k, v in convergence_stats(sol).items()}
        print(f"batch of {args.batch} solves in {elapsed:.3f}s "
              f"({args.batch / elapsed:.1f} solves/s, incl. compile)")
        for k, v in stats.items():
            print(f"  {k:<18s} {v:.6g}")
        best = int(torch.argmin(sol.cost))
        wrote(write_trajectory_csv(args.output, sol.xs[best], sol.us[best]),
              "best trajectory")
        return sol

    t0 = time.perf_counter()
    if args.quiet:
        sol = solve(model, params, cfg, args.dt, x0, u0, device=dev)
        fence(sol.cost)
    else:
        sol = solve_verbose(model, params, cfg, args.dt, x0, u0, device=dev)
    elapsed = time.perf_counter() - t0

    # Matches the reference's closing lines (run_ilqr.cpp:58-64).
    print(f"Final cost: {float(sol.cost):.6g}  "
          f"iterations: {int(sol.iterations)}")
    print(f"Solve took {elapsed:.3f} seconds (incl. compile).")
    wrote(write_trajectory_csv(args.output, sol.xs, sol.us), "trajectory")

    if args.profile:
        from ilqr_tpu_torch.utils.timing import profile_phases

        _timer, report = profile_phases(model, params, cfg, args.dt, x0, u0,
                                        n_iters=5, device=dev)
        print(report)
    if args.plot:
        from ilqr_tpu_torch.utils.plotting import plot_trajectory

        plot_trajectory(sol.xs, sol.us, dt=args.dt, title=args.problem,
                        save_path=args.plot)
        print(f"Wrote plot to {args.plot}")
    return sol


def main(argv=None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
