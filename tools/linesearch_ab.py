#!/usr/bin/env python3
"""The line-search kernel in two trees, in turns on one card.

    python3 tools/linesearch_ab.py PARENT_ROOT [--out FILE]

PARENT_ROOT is a checkout of the commit to compare with (for example
``git archive <commit> | tar -x -C archive_check/parent``); the tree this
script lies in is the change. For each tree every csrc/*.cu source is built
with the package's own nvcc flags into a library of its own under the
tree's build/ilqr_tpu_torch/ (the one tools/iteration_ab.py builds, reused
where it is there), and ptxas's registers, stack and spills of every
line-search kernel are read from the build. Then four passes, parent,
change, change, parent, each in a process of its own on that tree's
package, take:

  - the linesearch_packed rows of chip_smoke.py phase 3 for all 14 models,
    at its shapes and on its inputs: the slices' Euler rows (acrobot
    B = 8192, T = 499; the others B = 1024 at their paths' T) and the RK4
    readings at the CLI problems' T (A = 11); CUDA events, median of 5, and
    a digest of every output, which must be the same in both trees;
  - each row's blocks per SM: from the launchers'
    ilqr_<model>_linesearch_blocks_per_sm where a tree has them
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), else from its
    registers (one-thread blocks of 64);
  - the split-route paths, whose iteration is the sweep and the line
    search (solves/s, ms per iteration, linesearch_packed launches per host
    iteration, mean cost, and a profiled solve's device busy share and
    device ms by kernel): the quadrotor's analytic path (phase 8) and its
    fd + RK4 CLI batch solve at max_iter FD_WIDE_ITERS; thruster_ring's,
    free_flyer's and omni_thruster's analytic paths (phase 9) and fd CLI
    batch solves at max_iter M5_FD_ITERS; acrobot's fd + RK4 batch solve on
    the split sweep (sweep_kernel="split", B = 8192, max_iter 20);
  - the custom models of chip_smoke.py phase 15 (their own libraries, built
    from their generated headers in each tree): the unicycle's
    linesearch_packed rows (B = 1024, T = 80, A = 11; Euler and RK4) and
    unicycle_heading's (Euler), and phase 15(b)'s fleet of B = 1024
    unicycles on the split iteration (analytic Euler: the dual-number sweep
    and the line search); --only unicycle takes them alone.

The change's first pass also runs tests/test_torch_cuda_linesearch_team.py
and tests/test_torch_cuda_custom_team.py (the team kernels against their
plain versions on the card for every model, bit for bit). The readings go to FILE as JSON (default
build/linesearch_ab.json) and a summary is printed. The passes, builds and
checks are tools/_ab.py's. Needs one CUDA device.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import _ab

CHANGE = _ab.CHANGE
MODELS = ("acrobot", "pendulum", "cartpole", "double_integrator",
          "point_mass_3d", "bicycle", "power_mass", "quadrotor",
          "omni_thruster", "free_flyer", "thruster_ring", "thruster_ring16",
          "thruster_ring20", "thruster_ring24")
# row: (phase 3 case builder, its label)
ROWS = {"acrobot/euler": (("acrobot",), "linesearch_packed")}
for _name in MODELS[1:]:
    ROWS[f"{_name}/euler"] = (("model", _name), f"linesearch_packed/{_name}")
for _name in MODELS:
    ROWS[f"{_name}/rk4"] = (("fd", _name), f"linesearch_packed/{_name} (rk4)")
# path: (model, "analytic" (run_model_path) or "cli" (run_fd_path),
# SolverConfig changes, B)
PATHS = {"quadrotor/analytic": ("quadrotor", "analytic", {}, None),
         "quadrotor/fd_rk4": ("quadrotor", "cli", dict(integrator="rk4"),
                              None)}
for _name in ("thruster_ring", "free_flyer", "omni_thruster"):
    PATHS[f"{_name}/analytic"] = (_name, "analytic", {}, None)
    PATHS[f"{_name}/fd"] = (_name, "cli", {}, None)
CUSTOM_ROWS = {"unicycle/euler": "linesearch_packed/unicycle (euler)",
               "unicycle/rk4": "linesearch_packed/unicycle (rk4)",
               "unicycle_heading/euler":
                   "linesearch_packed/unicycle_heading (euler)"}
for _row, _label in CUSTOM_ROWS.items():
    ROWS[_row] = (("custom", _row.split("/")[0]), _label)
PATHS["unicycle/fleet/analytic_euler_split"] = (
    "unicycle", "fleet", "analytic_euler_split", None)
PATHS["acrobot/fd_rk4_split"] = (
    "acrobot", "cli", dict(integrator="rk4", sweep_kernel="split",
                           max_iter=20), "B_MAIN")


def _linesearch_key(source: str, name: str):
    """The ptxas key of a line-search kernel (one-thread or team): its
    model."""
    if "linesearch" in name and source.startswith("kernels"):
        return ("acrobot" if source == "kernels.cu" else
                source.removeprefix("kernels_").removesuffix(".cu"))
    return None


def worker(root: Path, tag: str, check: bool) -> dict:
    """One pass on ``root``'s package (see the module's docstring)."""
    import numpy as np
    import torch

    _build, lib, smoke = _ab.load_tree(root, "all")
    from ilqr_tpu_torch.ops import kernel_rollout

    dev = torch.device("cuda")
    res = dict(tree=tag, root=str(root), smi=smoke.nvidia_smi(), paths={})
    res["compile_seconds"] = json.loads(
        (lib.parent / "compile_seconds.json").read_text())
    ptx = _ab.ptxas(lib.parent / "ptxas.log", _linesearch_key)

    custom = {name: _ab.custom_ptxas(_build, smoke, name,
                                     _ab.custom_key("linesearch"))
              for name in smoke.CUSTOM_MODELS}
    custom_reading = _ab.custom_reading(_build, smoke, "linesearch", custom)

    def reading(row, case):
        name = row.split("/")[0]
        if name in custom:
            return custom_reading(row, case)
        p = ptx.get(name, {})
        blocks, threads, smem = _ab.occupancy(
            _build.library(), f"ilqr_{name}_linesearch_blocks_per_sm", None,
            p.get("registers", 255))
        return dict(p, blocks_per_sm=blocks, block_threads=threads,
                    smem_per_block=smem)

    res["rows"] = _ab.time_rows(smoke, dev, ROWS, reading)

    if check:   # the team kernel against the plain version
        import pytest

        t0 = time.perf_counter()
        rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", "-q"]
                         + [str(CHANGE / "tests" / f) for f in (
                             "test_torch_cuda_linesearch_team.py",
                             "test_torch_cuda_custom_team.py")])
        if rc != 0:
            raise AssertionError(f"tests/test_torch_cuda_linesearch_team.py: "
                                 f"pytest exit {rc}")
        res["edge_cases"] = dict(bitwise=True,
                                 seconds=time.perf_counter() - t0)

    for path, (name, kind, extra, lanes) in PATHS.items():
        label = f"[{tag}] {path}"
        kernel_rollout.linesearch_packed.launches = 0
        if kind == "fleet":
            out = _ab.custom_fleet(smoke, dev, name, extra, label)
        elif kind == "cli":
            depth = ({} if "max_iter" in extra else dict(
                max_iter=smoke.FD_WIDE_ITERS if name == "quadrotor"
                else smoke.M5_FD_ITERS))
            out, _c = smoke.run_fd_path(
                dev, name, label, B=getattr(smoke, lanes or "B_M"),
                profile=True, **depth, **extra)
        else:
            out, _first = smoke.run_model_path(dev, name, label, **extra)
            model, params, cfg, T, dt, u0, draw = smoke.workload(name)
            out["profile"] = smoke.profile_solve(
                label, lambda x0_, u0_: smoke.solve_batch_fused(
                    model, params, cfg, dt, x0_, u0_),
                float(np.median(out["wall_s"])),
                draw(np.random.default_rng(0)), u0)
        res["paths"][path] = _ab.path_reading(out, "linesearch_packed")
        print(f"{label}: {res['paths'][path]}", flush=True)
    return res


def summary(passes):
    print(f"[ab] build s parent "
          f"{max(passes[0]['compile_seconds'].values()):.1f} (longest "
          f"source), change {max(passes[1]['compile_seconds'].values()):.1f}")
    _ab.summary_rows(passes, ROWS)
    _ab.summary_paths(passes, PATHS, "linesearch_packed")


def main() -> int:
    ap = _ab.parser(__doc__, "linesearch_ab.json")
    args = ap.parse_args()
    extra = _ab.select(args, ROWS, PATHS)
    return _ab.run(args, ap, Path(__file__).resolve(), worker, ROWS, PATHS,
                   summary, extra)


if __name__ == "__main__":
    sys.exit(main())
