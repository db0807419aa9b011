#!/usr/bin/env python3
"""The merged sweep (sweep_packed) in two trees, in turns on one card.

    python3 tools/sweep_ab.py PARENT_ROOT [--out FILE] [--passes N]
        [--only PREFIXES]

PARENT_ROOT is a checkout of the commit to compare with (for example
``git archive <commit> | tar -x -C archive_check/parent``); the tree this
script lies in is the change. Its rows and paths are those of the
split-route models, whose ``iter_kernel="auto"`` takes the split iteration
(m·n ≥ 32: the quadrotor, omni_thruster, free_flyer and
thruster_ring{,16,20,24}; the sweep a warp per lane), and of the seven
models with m·n < 32 (acrobot, cartpole, pendulum, double_integrator,
bicycle, power_mass, point_mass_3d; the sweep on the team of their whole
iteration), whose split iteration users take with iter_kernel="split".
For each tree every csrc/*.cu source is built with the package's own nvcc
flags into a library of its own under the tree's build/ilqr_tpu_torch/
(shared with tools/iteration_ab.py and tools/derivs_ab.py), and ptxas's
registers, stack and spills of every sweep kernel are read from the build.
Then four passes (or --passes), parent, change, change, parent, each in a
process of its own on that tree's package, take:

  - the sweep_packed rows of chip_smoke.py phase 3 for those models, at its
    shapes and on its inputs (B = 1024, acrobot B = 8192; the analytic
    sweep at the slice's T = 80 or the CLI problem's T, acrobot's T = 499,
    the stencil and dual-number ones at the CLI problem's T and RK4, rings
    16-24 on their first 4 steps; omni_thruster also without limits):
    CUDA events, median of 5, and a digest of every output, which must be
    the same in both trees;
  - each row's blocks per SM: the change's from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor (its launchers'
    ilqr_<model>_sweep*_blocks_per_sm), the parent's from its registers
    (blocks of 64 threads);
  - the split-route paths (solves/s, ms per iteration, sweep_packed
    launches per host iteration, mean cost, and one profiled solve's device
    busy share and device ms by kernel): the CLI's fd batch solves of
    thruster_ring, free_flyer and omni_thruster (with and without limits)
    at max_iter M5_FD_ITERS and the quadrotor's fd + RK4 at FD_WIDE_ITERS,
    as chip_smoke.py phase 11 runs them, and the analytic Euler paths of
    phases 8-9 (thruster_ring, free_flyer, omni_thruster, the quadrotor; T =
    80, max_iter 40); for the m·n < 32 models with iter_kernel="split", the
    CLI's fd batch solves of cartpole, power_mass and pendulum (B = 1024,
    uncut) and the acrobot flagship (phase 4's problem and draws, B = 8192,
    T = 499, max_iter 100: a warm-up, two timed solves and a profiled one);
    for the custom models of chip_smoke.py phase 15 (their own libraries,
    built from their generated headers in each tree; the sweep on the team
    of their whole iteration), the unicycle's sweep_packed rows (B = 1024,
    T = 80: the dual numbers with Euler and RK4, the stencils with Euler)
    and phase 15(b)'s fleet of B = 1024 unicycles on the split iteration
    (analytic Euler: the dual-number sweep); --only unicycle takes them
    alone.

The change's first pass also runs tests/test_torch_cuda_sweep_team.py,
tests/test_torch_cuda_sweep_small_team.py and
tests/test_torch_cuda_custom_team.py (the team kernels against their plain
versions on the card, bit for bit). The readings go to FILE as JSON
(default build/sweep_ab.json) and a summary is printed. The passes, builds
and checks are tools/_ab.py's. Needs one CUDA device.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import _ab

CHANGE = _ab.CHANGE
MODELS = ("thruster_ring", "thruster_ring16", "thruster_ring20",
          "thruster_ring24", "free_flyer", "omni_thruster", "quadrotor")
# the models with m·n < 32: the sweep on their whole iteration's team
SMALL = ("acrobot", "cartpole", "pendulum", "double_integrator", "bicycle",
         "power_mass", "point_mass_3d")
# row: (phase 3 case builder, its key)
ROWS = {f"{name}/{form}": (builder, key)
        for name in MODELS + SMALL
        for form, builder, key in (
            ("analytic", "model", f"sweep_packed/{name}"),
            ("fd", "fd", f"sweep_packed/{name}/fd (euler)"),
            ("jvp_rk4", "jvp", f"sweep_packed/{name}/jvp (rk4)"))}
ROWS["acrobot/analytic"] = ("acrobot", "sweep_packed")
CUSTOM_ROWS = {"unicycle/jvp": "sweep_packed/unicycle (jvp, euler)",
               "unicycle/jvp_rk4": "sweep_packed/unicycle (jvp, rk4)",
               "unicycle/fd": "sweep_packed/unicycle (fd, euler)"}
for _row, _label in CUSTOM_ROWS.items():
    ROWS[_row] = ("custom", _label)
ROWS["acrobot/fd_rk4"] = ("fd", "sweep_packed/acrobot/fd (rk4)")
ROWS["quadrotor/fd_rk4"] = ("fd", "sweep_packed/quadrotor/fd (rk4)")
ROWS["omni_thruster/analytic/unconstrained"] = (
    "model", "sweep_packed/omni_thruster/unconstrained")
ROWS["omni_thruster/fd/unconstrained"] = (
    "fd", "sweep_packed/omni_thruster/fd/unconstrained (euler)")
ROWS["omni_thruster/jvp_rk4/unconstrained"] = (
    "jvp", "sweep_packed/omni_thruster/jvp/unconstrained (rk4)")
# path: (model, "fd" (the CLI's batch solve) or "analytic" (phases 8-9),
# SolverConfig changes)
PATHS = {"thruster_ring/fd": ("thruster_ring", "fd", {}),
         "free_flyer/fd": ("free_flyer", "fd", {}),
         "omni_thruster/fd": ("omni_thruster", "fd", {}),
         "omni_thruster/fd/unconstrained": (
             "omni_thruster", "fd", dict(use_control_limits=False)),
         "quadrotor/fd_rk4": ("quadrotor", "fd", dict(integrator="rk4")),
         "thruster_ring/analytic": ("thruster_ring", "analytic", {}),
         "free_flyer/analytic": ("free_flyer", "analytic", {}),
         "omni_thruster/analytic": ("omni_thruster", "analytic", {}),
         "quadrotor/analytic": ("quadrotor", "analytic", {}),
         "acrobot/flagship/split": ("acrobot", "flagship", {})}
for _name in ("cartpole", "power_mass", "pendulum"):
    PATHS[f"{_name}/fd/split"] = (_name, "fd", dict(iter_kernel="split"))
PATHS["unicycle/fleet/analytic_euler_split"] = ("unicycle", "fleet",
                                                "analytic_euler_split")
SWEEP_KERNELS = ("sweep_kernel", "sweep_team_kernel", "sweep_small_team_kernel")


def _sweep_key(source: str, name: str):
    """The ptxas key of a sweep kernel (one-thread, warp or team): model,
    form and limits."""
    if (any(k in name for k in SWEEP_KERNELS)
            and source.startswith("kernels")):
        model = ("acrobot" if source == "kernels.cu" else
                 source.removeprefix("kernels_").removesuffix(".cu")
                 .removesuffix("_fd").removesuffix("_jvp"))
        return f"{model}/{_ab.form_of(name)}/limits={'Lb1E' in name}"
    return None


def flagship_split(smoke, label: str) -> dict:
    """The flagship with iter_kernel="split" on phase 4's problem and draws:
    a warm-up solve, two timed ones (each ending in a full device-to-host
    copy, the first's launch counts and host iterations kept) and one
    profiled."""
    import numpy as np

    model, params, cfg = smoke.flagship()
    cfg = cfg.replace(iter_kernel="split")
    rng = np.random.default_rng(0)
    draw = lambda: (0.05 * rng.normal(size=(smoke.B_MAIN, smoke.N))).astype(
        np.float32)
    u0 = np.zeros((smoke.B_MAIN, smoke.T, smoke.M), np.float32)
    solve = lambda x0: smoke.solve_batch_fused(model, params, cfg, smoke.DT,
                                               x0, u0)
    smoke._timed_solve(solve, draw())   # the warm-up
    runs = [smoke._timed_solve(solve, draw()) for _ in range(2)]
    host, _wall, counts, its = runs[0]
    wall = float(np.median([r[1] for r in runs]))
    return dict(solves_per_s=smoke.B_MAIN / wall,
                ms_per_iteration=wall * 1e3 / max(1, its),
                host_iterations=its, max_iter=cfg.max_iter, launches=counts,
                mean_cost=float(host["cost"].mean()),
                wall_s=[r[1] for r in runs],
                profile=smoke.profile_solve(
                    label, lambda x0, u0_: smoke.solve_batch_fused(
                        model, params, cfg, smoke.DT, x0, u0_), wall))


def worker(root: Path, tag: str, check: bool) -> dict:
    """One pass on ``root``'s package (see the module's docstring)."""
    import numpy as np
    import torch

    _build, lib, smoke = _ab.load_tree(root, "all")
    dev = torch.device("cuda")
    res = dict(tree=tag, root=str(root), smi=smoke.nvidia_smi(), paths={})
    res["compile_seconds"] = json.loads(
        (lib.parent / "compile_seconds.json").read_text())
    ptx = _ab.ptxas(lib.parent / "ptxas.log", _sweep_key)

    custom = {name: _ab.custom_ptxas(_build, smoke, name,
                                     _ab.custom_key("sweep"))
              for name in smoke.CUSTOM_MODELS}
    custom_reading = _ab.custom_reading(_build, smoke, "sweep", custom)

    def reading(row, case):
        name, form = row.split("/")[:2]
        if name in custom:
            return custom_reading(row, case)
        kind = {"analytic": "analytic", "fd": "fd", "fd_rk4": "fd",
                "jvp_rk4": "jvp"}[form]
        limits = not row.endswith("/unconstrained")
        p = ptx.get(f"{name}/{kind}/limits={limits}", {})
        suffix = {"analytic": "", "fd": "_fd", "jvp": "_jvp"}[kind]
        blocks, threads, smem = _ab.occupancy(
            _build.library(), f"ilqr_{name}_sweep{suffix}_blocks_per_sm",
            limits, p.get("registers", 255))
        return dict(p, blocks_per_sm=blocks, block_threads=threads,
                    smem_per_block=smem)

    res["rows"] = _ab.time_rows(
        smoke, dev, {row: ((builder, row.split("/")[0]), key)
                     for row, (builder, key) in ROWS.items()}, reading)

    if check:   # the team kernels' edge cases against the plain version
        import pytest

        t0 = time.perf_counter()
        rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", "-q"]
                         + [str(CHANGE / "tests" / f) for f in (
                             "test_torch_cuda_sweep_team.py",
                             "test_torch_cuda_sweep_small_team.py",
                             "test_torch_cuda_custom_team.py")])
        if rc != 0:
            raise AssertionError(f"the team sweep tests: pytest exit {rc}")
        res["edge_cases"] = dict(bitwise=True,
                                 seconds=time.perf_counter() - t0)

    for path, (name, kind, extra) in PATHS.items():
        label = f"[{tag}] {path}"
        if kind == "fleet":
            out = _ab.custom_fleet(smoke, dev, name, extra, label)
        elif kind == "flagship":
            out = flagship_split(smoke, label)
        elif kind == "fd":
            depth = (dict(max_iter=smoke.FD_WIDE_ITERS)
                     if name == "quadrotor" else {} if name in SMALL
                     else dict(max_iter=smoke.M5_FD_ITERS))
            out, _c = smoke.run_fd_path(dev, name, label, B=smoke.B_M,
                                        profile=True, **depth, **extra)
        else:
            out, _first = smoke.run_model_path(dev, name, label, **extra)
            model, params, cfg, T, dt, u0, draw = smoke.workload(name)
            x0 = draw(np.random.default_rng(0))
            out["profile"] = smoke.profile_solve(
                label, lambda x0_, u0_: smoke.solve_batch_fused(
                    model, params, cfg, dt, x0_, u0_),
                float(np.median(out["wall_s"])), x0, u0)
        res["paths"][path] = _ab.path_reading(out, "sweep_packed")
        print(f"{label}: {res['paths'][path]}", flush=True)
    return res


def summary(passes):
    print(f"[ab] build s parent "
          f"{max(passes[0]['compile_seconds'].values()):.1f} (longest "
          f"source), change {max(passes[1]['compile_seconds'].values()):.1f}")
    _ab.summary_rows(passes, ROWS)
    _ab.summary_paths(passes, PATHS, "sweep_packed")


def main() -> int:
    ap = _ab.parser(__doc__, "sweep_ab.json")
    args = ap.parse_args()
    extra = _ab.select(args, ROWS, PATHS)
    return _ab.run(args, ap, Path(__file__).resolve(), worker, ROWS, PATHS,
                   summary, extra)


if __name__ == "__main__":
    sys.exit(main())
