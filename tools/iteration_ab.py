#!/usr/bin/env python3
"""Acrobot's whole-iteration kernel in two trees, in turns on one card.

    python3 tools/iteration_ab.py PARENT_ROOT [--out FILE]

PARENT_ROOT is a checkout of the commit to compare with (for example
``git archive <commit> | tar -x -C archive_check/parent``); the tree this
script lies in is the change. For each tree the sources of acrobot's fused
kernels (kernels.cu, kernels_acrobot_{fd,jvp}.cu, derivs_acrobot.cu,
backward.cu) are built with the package's own nvcc flags into a library of
their own under the tree's build/ilqr_tpu_torch/, and ptxas's registers,
stack and spills of every acrobot iteration kernel are read from the build.
Then four passes, parent, change, change, parent, each in a process of its
own on that tree's package, take:

  - the four iteration_packed rows of chip_smoke.py phase 3 at its shapes
    and on its inputs (B = 8192, T = 499, A = 11): analytic with Euler (the
    flagship), the stencils with Euler and with RK4, the dual numbers with
    RK4; CUDA events, median of 5, and a digest of every output, which
    must be the same in both trees;
  - each row's blocks per SM: the change's from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor (its launchers'
    ilqr_acrobot_iteration*_blocks_per_sm), the parent's from its
    registers (blocks of 64 threads; at B = 8192 its grid of 128 blocks
    puts at most one on each of the 132 SMs);
  - the flagship path as chip_smoke.py phase 4 runs it (solves/s, ms per
    iteration, one profiled solve's device busy share) and the acrobot CLI
    batch solves of phases 11b and 12a (the stencils with Euler, max_iter
    100, and with RK4, and analytic + RK4, max_iter 20): solves/s, ms per
    iteration, iteration_packed launches per host iteration, mean cost.

The change's first pass also runs tests/test_torch_cuda_team.py's cases (the
team kernel against iteration_plain on the card, bit for bit). The passes'
readings go to FILE as JSON (default build/iteration_ab.json) and a summary
is printed. Needs one CUDA device.

    python3 tools/iteration_ab.py --smoke-costs PARENT_LOG CHANGE_LOG

sets every mean cost in the summary line of one chip_smoke.py log beside
the same path's in another (each tree's run, on the same card) and prints
those that differ; it exits non-zero if any does.
"""

from __future__ import annotations

import ctypes
import json
import sys
import time
from pathlib import Path

import _ab

CHANGE = _ab.CHANGE
SOURCES = ("kernels.cu", "kernels_acrobot_fd.cu", "kernels_acrobot_jvp.cu",
           "derivs_acrobot.cu", "backward.cu")
# row: (phase 3 case builder, its key, the launcher's suffix)
ROWS = {"analytic": ("acrobot", "iteration_packed", ""),
        "fd": ("fd", "iteration_packed/acrobot/fd (euler)", "_fd"),
        "fd_rk4": ("fd", "iteration_packed/acrobot/fd (rk4)", "_fd"),
        "jvp_rk4": ("jvp", "iteration_packed/acrobot/jvp (rk4)", "_jvp")}
# path: SolverConfig changes of the CLI's acrobot batch solve (None: the
# flagship); max_iter as chip_smoke.py phases 11b and 12a run them
PATHS = {"flagship": None,
         "fd": dict(),
         "fd_rk4": dict(integrator="rk4", max_iter=20),
         "jvp_rk4": dict(deriv_mode="analytic", integrator="rk4",
                         max_iter=20)}


def _iteration_key(source: str, name: str):
    """The ptxas key of an acrobot iteration kernel: form and limits."""
    if "iteration" in name and source.startswith("kernels"):
        return f"{_ab.form_of(name)}/limits={'Lb1E' in name}"
    return None


def worker(root: Path, tag: str, check: bool) -> dict:
    """One pass on ``root``'s package (see the module's docstring)."""
    import numpy as np
    import torch

    _build, lib, smoke = _ab.load_tree(root, "acrobot", SOURCES)
    from ilqr_tpu_torch.ops import kernel_iter

    dev = torch.device("cuda")
    res = dict(tree=tag, root=str(root), smi=smoke.nvidia_smi(), rows={},
               paths={})
    ptx = _ab.ptxas(lib.parent / "ptxas.log", _iteration_key)
    res["compile_seconds"] = json.loads(
        (lib.parent / "compile_seconds.json").read_text())
    team = hasattr(_build.library(), "ilqr_acrobot_iteration_blocks_per_sm")
    cases = {}
    for row, (builder, key, suffix) in ROWS.items():
        if builder not in cases:
            cases[builder] = smoke.build_cases(
                dev, ("acrobot",) if builder == "acrobot"
                else (builder, "acrobot"))
        case = cases[builder][key]
        ms = smoke.time_ms(lambda: case.op(*case.args), reps=5)
        outs = case.op(*case.args)
        torch.cuda.synchronize()
        form = {"": "analytic", "_fd": "fd", "_jvp": "jvp"}[suffix]
        p = ptx.get(f"{form}/limits=True", {})
        if team:
            fn = getattr(_build.library(),
                         f"ilqr_acrobot_iteration{suffix}_blocks_per_sm")
            fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
            blocks, block = fn(1), 128
        else:
            blocks, block = _ab.regs_blocks(p["registers"]), 64
        res["rows"][row] = dict(ms=ms, digest=_ab.digest(outs), **p,
                                blocks_per_sm=blocks, block_threads=block,
                                where=case.where)
        print(f"[{tag}] {row}: {ms:.3f} ms, {p}, {blocks} blocks of {block} "
              f"per SM, digest {res['rows'][row]['digest']}", flush=True)
    del cases
    torch.cuda.empty_cache()

    if check:   # the team kernel's edge cases against the plain version
        sys.path.insert(0, str(CHANGE / "tests"))
        import test_torch_cuda_team as tt

        t0 = time.perf_counter()
        for form in sorted(tt.FORMS):
            for case in sorted(tt.CASES):
                tt.test_team_iteration_matches_plain(dev, form, case)
        res["edge_cases"] = dict(n=len(tt.FORMS) * len(tt.CASES),
                                 bitwise=True,
                                 seconds=time.perf_counter() - t0)
        print(f"[{tag}] {res['edge_cases']['n']} edge cases bitwise against "
              f"iteration_plain", flush=True)

    model, params, cfg = smoke.flagship()
    for path, extra in PATHS.items():
        kernel_iter.iteration_packed.launches = 0
        if extra is None:
            out = smoke.run_main_path(dev, model, params, cfg)
            out["profile"] = smoke.profile_solve(
                "fused", lambda x0, u0: smoke.solve_batch_fused(
                    model, params, cfg, smoke.DT, x0, u0),
                float(np.median(out["wall_s"])))
            launches = out["launches"]["iteration_packed"]
        else:
            out, _c = smoke.run_fd_path(dev, "acrobot", f"{tag} {path}",
                                        B=smoke.B_MAIN, profile=True, **extra)
            launches = out["launches"]["iteration_packed"]
        its = out["host_iterations"]
        prof = out.get("profile") or {}
        res["paths"][path] = dict(
            solves_per_s=out["solves_per_s"],
            ms_per_iteration=out["ms_per_iteration"], host_iterations=its,
            launches_per_iteration=launches / max(1, its),
            mean_cost=out["mean_cost"],
            busy_share=prof.get("device_busy_share"),
            iteration_ms_in_profile=sum(
                v for k, v in (prof.get("device_ms_by_kernel") or {}).items()
                if k.startswith("iteration_")))
        print(f"[{tag}] path {path}: {res['paths'][path]}", flush=True)
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
    for row in ROWS:
        r = [p["rows"][row] for p in passes]
        print(f"[ab] row {row}: ms " + " / ".join(f"{x['ms']:.3f}" for x in r)
              + f"; parent {r[0].get('registers')} regs {r[0].get('stack')} "
              f"B stack {r[0].get('spill_stores')}/{r[0].get('spill_loads')} "
              f"B spills, {r[0]['blocks_per_sm']} blocks/SM; change "
              f"{r[1].get('registers')} regs {r[1].get('stack')} B stack "
              f"{r[1].get('spill_stores')}/{r[1].get('spill_loads')} B "
              f"spills, {r[1]['blocks_per_sm']} blocks/SM; outputs equal")
    for path in PATHS:
        r = [p["paths"][path] for p in passes]
        print(f"[ab] path {path}: solves/s " + " / ".join(
            f"{x['solves_per_s']:.1f}" for x in r) + "; ms/iteration "
            + " / ".join(f"{x['ms_per_iteration']:.3f}" for x in r)
            + "; launches/iteration " + " / ".join(
                f"{x['launches_per_iteration']:.2f}" for x in r)
            + "; busy " + " / ".join(
                "n/a" if x["busy_share"] is None else f"{x['busy_share']:.3f}"
                for x in r) + f"; mean cost {r[0]['mean_cost']}")


def main() -> int:
    ap = _ab.parser(__doc__, "iteration_ab.json")
    ap.add_argument("--smoke-costs", nargs=2, metavar=("PARENT_LOG",
                                                      "CHANGE_LOG"))
    args = ap.parse_args()
    if args.smoke_costs:
        return compare_smoke_costs(*map(Path, args.smoke_costs))
    return _ab.run(args, ap, Path(__file__).resolve(), worker, ROWS, PATHS,
                   summary)


if __name__ == "__main__":
    sys.exit(main())
