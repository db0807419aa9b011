#!/usr/bin/env python3
"""The whole-iteration kernels in two trees, in turns on one card.

    python3 tools/iteration_ab.py PARENT_ROOT [--out FILE]

PARENT_ROOT is a checkout of the commit to compare with (for example
``git archive <commit> | tar -x -C archive_check/parent``); the tree this
script lies in is the change. For each tree every csrc/*.cu source is built
with the package's own nvcc flags into a library of its own under the
tree's build/ilqr_tpu_torch/ (tools/linesearch_ab.py reuses it), and
ptxas's registers, stack and spills of every iteration kernel are read from
the build. Then four passes, parent, change, change, parent, each in a
process of its own on that tree's package, take:

  - the iteration_packed rows of chip_smoke.py phase 3 at its shapes and on
    its inputs: acrobot's four (B = 8192, T = 499, A = 11: analytic with
    Euler, the stencils with Euler and with RK4, the dual numbers with RK4);
    cartpole's and pendulum's (B = 1024, the CLI problems' T: analytic,
    stencils with Euler, dual numbers with RK4, each with limits and
    without; pendulum's per-lane params); the seven split-route models'
    merged iteration (B = 1024, T = 80, the stencil and dual-number rows at
    the CLI problem's T, rings 16-24 on their first 4 steps; omni_thruster
    also without limits); CUDA events, median of 5, and a digest of every
    output, which must be the same in both trees;
  - each row's blocks per SM: from the launchers'
    ilqr_<model>_iteration*_blocks_per_sm where a tree has them
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), else from its
    registers (one-thread blocks of 64);
  - the paths (solves/s, ms per iteration, iteration_packed launches per
    host iteration, mean cost, and a profiled solve's device busy share and
    device ms by kernel): the flagship as chip_smoke.py phase 4 runs it;
    the CLI's cartpole and pendulum batch solves at B = 1024 (phases 10-12:
    analytic, the stencils and analytic + RK4, with limits and without the
    first two); the merged-route gauges of phases 8-9 (the quadrotor,
    thruster_ring, omni_thruster with limits and without, free_flyer: T =
    80, max_iter 40, iter_kernel="merged");
  - the custom models of chip_smoke.py phase 15 (their own libraries,
    built from their generated headers in each tree): the unicycle's
    iteration_packed rows (B = 1024, T = 80, A = 11: the dual numbers with
    Euler and RK4, the stencils with Euler) and unicycle_heading's (dual
    numbers, Euler), and phase 15(b)'s fleet of B = 1024 unicycles through
    the whole iteration (analytic Euler and RK4, which run the dual
    numbers, and fd Euler) and unicycle_heading's merged route; --only
    unicycle takes them alone.

The change's first pass also runs tests/test_torch_cuda_team.py,
tests/test_torch_cuda_iteration_m23.py, tests/test_torch_cuda_iteration_warp.py
and tests/test_torch_cuda_custom_team.py (the team and warp kernels against
their plain versions on the card, bit for bit). The passes' readings go to FILE
as JSON (default build/iteration_ab.json) and a summary is printed; the
passes, builds and checks are tools/_ab.py's. Needs one CUDA device.

    python3 tools/iteration_ab.py --smoke-costs PARENT_LOG CHANGE_LOG

sets every mean cost in the summary line of one chip_smoke.py log beside
the same path's in another (each tree's run, on the same card) and prints
those that differ; it exits non-zero if any does.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import _ab

CHANGE = _ab.CHANGE
TEAM = ("cartpole", "pendulum")
# the 32-thread team (m = 2-3); FREE23: those with unconstrained rows
TEAM32 = ("double_integrator", "bicycle", "power_mass", "point_mass_3d")
FREE23 = ("double_integrator", "bicycle", "power_mass")
WARP = ("quadrotor", "omni_thruster", "free_flyer", "thruster_ring",
        "thruster_ring16", "thruster_ring20", "thruster_ring24")
# row: (phase 3 case builder, its label)
ROWS = {"acrobot/analytic": (("acrobot",), "iteration_packed"),
        "acrobot/fd": (("fd", "acrobot"),
                       "iteration_packed/acrobot/fd (euler)"),
        "acrobot/fd_rk4": (("fd", "acrobot"),
                           "iteration_packed/acrobot/fd (rk4)"),
        "acrobot/jvp_rk4": (("jvp", "acrobot"),
                            "iteration_packed/acrobot/jvp (rk4)")}
for _name in TEAM + WARP:
    ROWS[f"{_name}/analytic"] = (("model", _name),
                                 f"iteration_packed/{_name}")
    ROWS[f"{_name}/fd"] = (("fd", _name),
                           f"iteration_packed/{_name}/fd (euler)")
    ROWS[f"{_name}/jvp_rk4"] = (("jvp", _name),
                                f"iteration_packed/{_name}/jvp (rk4)")
for _name in TEAM + ("omni_thruster",):
    ROWS[f"{_name}/analytic/unconstrained"] = (
        ("model", _name), f"iteration_packed/{_name}/unconstrained")
for _name in TEAM:
    ROWS[f"{_name}/fd/unconstrained"] = (
        ("fd", _name), f"iteration_packed/{_name}/fd/unconstrained (euler)")
    ROWS[f"{_name}/jvp_rk4/unconstrained"] = (
        ("jvp", _name), f"iteration_packed/{_name}/jvp/unconstrained (rk4)")
ROWS["pendulum/analytic/per_lane"] = (
    ("lanes", "pendulum"), "iteration_packed/pendulum (per-lane params)")
for _name in TEAM32:
    ROWS[f"{_name}/analytic"] = (("model", _name),
                                 f"iteration_packed/{_name}")
    ROWS[f"{_name}/fd"] = (("fd", _name),
                           f"iteration_packed/{_name}/fd (euler)")
    ROWS[f"{_name}/jvp_rk4"] = (("jvp", _name),
                                f"iteration_packed/{_name}/jvp (rk4)")
for _name in FREE23:
    ROWS[f"{_name}/fd/unconstrained"] = (
        ("fd", _name), f"iteration_packed/{_name}/fd/unconstrained (euler)")
    ROWS[f"{_name}/jvp_rk4/unconstrained"] = (
        ("jvp", _name), f"iteration_packed/{_name}/jvp/unconstrained (rk4)")
    ROWS[f"{_name}/analytic/unconstrained"] = (
        ("model", _name), f"iteration_packed/{_name}/unconstrained")
# the custom models (phase 15): row → (case builder, label), by form
CUSTOM_ROWS = {
    "unicycle/jvp": "iteration_packed/unicycle (jvp, euler)",
    "unicycle/jvp_rk4": "iteration_packed/unicycle (jvp, rk4)",
    "unicycle/fd": "iteration_packed/unicycle (fd, euler)",
    "unicycle_heading/jvp": "iteration_packed/unicycle_heading (jvp, euler)"}
for _row, _label in CUSTOM_ROWS.items():
    ROWS[_row] = (("custom", _row.split("/")[0]), _label)
FREE = dict(use_control_limits=False, clamp_forward=False)
JVP = dict(deriv_mode="analytic", integrator="rk4")
# path: (model, "flagship", "analytic" (run_model_path) or "cli"
# (run_fd_path), SolverConfig changes)
PATHS = {"acrobot/flagship": ("acrobot", "flagship", {})}
for _name in TEAM:
    PATHS.update({
        f"{_name}/analytic": (_name, "analytic", {}),
        f"{_name}/analytic/unconstrained": (_name, "analytic", FREE),
        f"{_name}/fd": (_name, "cli", {}),
        f"{_name}/fd/unconstrained": (_name, "cli",
                                      dict(use_control_limits=False)),
        f"{_name}/jvp_rk4": (_name, "cli", JVP)})
for _name in TEAM32:
    PATHS.update({f"{_name}/analytic": (_name, "analytic", {}),
                  f"{_name}/fd": (_name, "cli", {})})
for _name, _extra in (("quadrotor", {}), ("thruster_ring", {}),
                      ("omni_thruster", {}),
                      ("omni_thruster/unconstrained", FREE),
                      ("free_flyer", {})):
    PATHS[f"{_name}/merged"] = (_name.split("/")[0], "analytic",
                                dict(_extra, iter_kernel="merged"))


for _variant in ("analytic_euler", "analytic_rk4", "fd_euler"):
    PATHS[f"unicycle/fleet/{_variant}"] = ("unicycle", "fleet", _variant)
PATHS["unicycle_heading/fleet/merged"] = ("unicycle_heading", "fleet",
                                          "merged")


def _iteration_key(source: str, name: str):
    """The ptxas key of an iteration kernel: model, form and limits."""
    if "iteration" in name and source.startswith("kernels"):
        model = ("acrobot" if source == "kernels.cu" else
                 source.removeprefix("kernels_").removesuffix(".cu")
                 .removesuffix("_fd").removesuffix("_jvp")
                 .removesuffix("_iteration"))
        return f"{model}/{_ab.form_of(name)}/limits={'Lb1E' in name}"
    return None


def worker(root: Path, tag: str, check: bool) -> dict:
    """One pass on ``root``'s package (see the module's docstring)."""
    import numpy as np
    import torch

    _build, lib, smoke = _ab.load_tree(root, "all")
    from ilqr_tpu_torch.ops import kernel_iter

    dev = torch.device("cuda")
    res = dict(tree=tag, root=str(root), smi=smoke.nvidia_smi(), paths={})
    ptx = _ab.ptxas(lib.parent / "ptxas.log", _iteration_key)
    res["compile_seconds"] = json.loads(
        (lib.parent / "compile_seconds.json").read_text())

    custom = {name: _ab.custom_ptxas(_build, smoke, name,
                                     _ab.custom_key("iteration"))
              for name in smoke.CUSTOM_MODELS}
    custom_reading = _ab.custom_reading(_build, smoke, "iteration", custom)

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
            _build.library(), f"ilqr_{name}_iteration{suffix}_blocks_per_sm",
            limits, p.get("registers", 255))
        return dict(p, blocks_per_sm=blocks, block_threads=threads,
                    smem_per_block=smem)

    res["rows"] = _ab.time_rows(smoke, dev, ROWS, reading)

    if check:   # the team and warp kernels against the plain version
        import pytest

        t0 = time.perf_counter()
        rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", "-q"]
                         + [str(CHANGE / "tests" / f) for f in (
                             "test_torch_cuda_team.py",
                             "test_torch_cuda_iteration_m23.py",
                             "test_torch_cuda_iteration_warp.py",
                             "test_torch_cuda_custom_team.py")])
        if rc != 0:
            raise AssertionError(f"the team and warp iteration tests: "
                                 f"pytest exit {rc}")
        res["edge_cases"] = dict(bitwise=True,
                                 seconds=time.perf_counter() - t0)

    for path, (name, kind, extra) in PATHS.items():
        label = f"[{tag}] {path}"
        kernel_iter.iteration_packed.launches = 0
        if kind == "fleet":
            out = _ab.custom_fleet(smoke, dev, name, extra, label)
        elif kind == "flagship":
            model, params, cfg = smoke.flagship()
            out = smoke.run_main_path(dev, model, params, cfg)
            out["profile"] = smoke.profile_solve(
                "fused", lambda x0, u0: smoke.solve_batch_fused(
                    model, params, cfg, smoke.DT, x0, u0),
                float(np.median(out["wall_s"])))
        elif kind == "cli":
            out, _c = smoke.run_fd_path(dev, name, label, B=smoke.B_M,
                                        profile=True, **extra)
        else:
            out, _first = smoke.run_model_path(dev, name, label, **extra)
            model, params, cfg, T, dt, u0, draw = smoke.workload(name)
            cfg = cfg.replace(**extra)
            out["profile"] = smoke.profile_solve(
                label, lambda x0_, u0_: smoke.solve_batch_fused(
                    model, params, cfg, dt, x0_, u0_),
                float(np.median(out["wall_s"])),
                draw(np.random.default_rng(0)), u0)
        res["paths"][path] = _ab.path_reading(out, "iteration_packed")
        print(f"{label}: {res['paths'][path]}", flush=True)
    return res


def smoke_costs(log: Path) -> dict:
    """Every mean cost in a chip_smoke.py log's summary line (the JSON
    object of its paths' results), by the keys that lead to it."""
    data = next(json.loads(line) for line in log.read_text().splitlines()
                if line.startswith('{"main_path"'))
    out = {}

    def walk(o, path):
        if isinstance(o, dict):
            for k, v in o.items():
                if "mean_cost" in k and isinstance(v, (int, float)):
                    out[f"{path}/{k}"] = v
                else:
                    walk(v, f"{path}/{k}")
        elif isinstance(o, list):
            for i, v in enumerate(o):
                walk(v, f"{path}[{i}]")

    walk(data, "")
    return out


def compare_smoke_costs(parent_log: Path, change_log: Path) -> int:
    parent, change = smoke_costs(parent_log), smoke_costs(change_log)
    keys = sorted(set(parent) | set(change))
    differ = [k for k in keys if parent.get(k) != change.get(k)]
    for k in differ:
        print(f"[costs] {k}: parent {parent.get(k)} change {change.get(k)}")
    print(f"[costs] {len(keys) - len(differ)} of {len(keys)} mean costs "
          f"equal to the parent's")
    return 1 if differ else 0


def summary(passes):
    print(f"[ab] build s parent "
          f"{max(passes[0]['compile_seconds'].values()):.1f} (longest "
          f"source), change {max(passes[1]['compile_seconds'].values()):.1f}")
    _ab.summary_rows(passes, ROWS)
    _ab.summary_paths(passes, PATHS, "iteration_packed")


def main() -> int:
    ap = _ab.parser(__doc__, "iteration_ab.json")
    ap.add_argument("--smoke-costs", nargs=2, metavar=("PARENT_LOG",
                                                      "CHANGE_LOG"))
    args = ap.parse_args()
    if args.smoke_costs:
        return compare_smoke_costs(*map(Path, args.smoke_costs))
    extra = _ab.select(args, ROWS, PATHS)
    return _ab.run(args, ap, Path(__file__).resolve(), worker, ROWS, PATHS,
                   summary, extra)


if __name__ == "__main__":
    sys.exit(main())
