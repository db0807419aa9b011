#!/usr/bin/env python3
"""The m = 1 backward kernel in two trees, in turns on one card.

    python3 tools/backward_ab.py PARENT_ROOT [--out FILE] [--passes N]
        [--only PREFIXES]

PARENT_ROOT is a checkout of the commit to compare with (for example
``git archive <commit> | tar -x -C archive_check/parent``); the tree this
script lies in is the change. For each tree every csrc/*.cu source is built
with the package's own nvcc flags into a library of its own under the
tree's build/ilqr_tpu_torch/ (shared with tools/iteration_ab.py), and
ptxas's registers, stack and spills of the backward kernel are read from
the build. Then the passes, parent, change, change, parent (and so on, as
--passes says), each in a process of its own on that tree's package, take:

  - the backward_sweep_packed rows of chip_smoke.py phase 3 at its shapes
    and on its inputs: acrobot's (B = 8192, T = 499, the composable
    flagship's derivatives), cartpole's and pendulum's (B = 1024, the CLI
    problems' T, their split sweep's derivatives), the custom
    unicycle_heading's (n = 3, its own library); CUDA events, median of
    5, and a digest of every output, which must be the same in both trees;
    each row's blocks per SM from ilqr_backward_n<n>_blocks_per_sm at the
    row's B where a tree has it, else from its registers (one-thread
    blocks of 64);
  - the paths: the composable flagship (chip_smoke.py phase 6: solve_batch
    at B = 8192, T = 499, max_iter 100 on phase 4's draws, after the fused
    flagship solve that it is held against) — solves/s, ms per iteration,
    backward launches per host iteration, mean cost, and a profiled solve's
    device busy share, device ms by kernel and the backward kernel's device
    ms a launch; the fused split sweep on the same x0 (one solve); the
    split sweeps of cartpole and pendulum on the CLI problems at B = 1024
    (sweep_kernel="split", analytic Euler).

The change's first pass also runs tests/test_torch_cuda_backward_team.py
(the kernel against backward_plain on the card, bit for bit). The passes'
readings go to FILE as JSON (default build/backward_ab.json) and a summary
is printed; the passes, builds and checks are tools/_ab.py's. Needs one
CUDA device.
"""

from __future__ import annotations

import json
import re
import sys
import time
from pathlib import Path

import _ab

CHANGE = _ab.CHANGE
# row: (phase 3 case builder, its label)
ROWS = {"acrobot": (("acrobot",), "backward_sweep_packed"),
        "cartpole": (("split", "cartpole"),
                     "backward_sweep_packed/cartpole"),
        "pendulum": (("split", "pendulum"),
                     "backward_sweep_packed/pendulum"),
        "unicycle_heading": (("custom", "unicycle_heading"),
                             "backward_sweep_packed/unicycle_heading")}
N_OF = {"acrobot": 4, "cartpole": 4, "pendulum": 2, "unicycle_heading": 3}
SPLIT = dict(deriv_mode="analytic", integrator="euler", sweep_kernel="split")
# path: (model, kind)
PATHS = {"acrobot/composable": ("acrobot", "composable"),
         "acrobot/split_sweep": ("acrobot", "split_sweep"),
         "cartpole/split_sweep": ("cartpole", "cli"),
         "pendulum/split_sweep": ("pendulum", "cli")}
KERNEL = "backward_sweep_packed"


def _backward_key(source: str, name: str):
    """The ptxas key of a backward kernel instantiation: ``n=<n>``, and
    for the team kernel (a template on <N, VEC, WARPS>) ``n=<n> vec=<VEC>
    warps=<WARPS>``."""
    if source != "backward.cu" or "backward" not in name:
        return None
    targs = re.findall(r"Li(\d+)E", name)
    return " ".join(f"{k}={v}" for k, v in zip(("n", "vec", "warps"), targs))


def _occupancy(lib, n: int, B: int):
    """(blocks an SM holds, threads a block, dynamic shared memory bytes a
    block, the ptxas key) of the backward kernel launched on B lanes, from
    the tree's ilqr_backward_n<n>_blocks_per_sm(B, …) where it has one;
    None where it has none (the one-thread kernel)."""
    import ctypes

    fn = getattr(lib, f"ilqr_backward_n{n}_blocks_per_sm", None)
    if fn is None:
        return None
    ptr = ctypes.POINTER(ctypes.c_int)
    fn.argtypes, fn.restype = [ctypes.c_int] + [ptr] * 3, ctypes.c_int
    threads, smem, copy = (ctypes.c_int(0) for _ in range(3))
    blocks = fn(B, ctypes.byref(threads), ctypes.byref(smem),
                ctypes.byref(copy))
    return (blocks, threads.value, smem.value,
            f"n={n} vec={copy.value // 4} warps={threads.value // 32}")


def worker(root: Path, tag: str, check: bool) -> dict:
    """One pass on ``root``'s package (see the module's docstring)."""
    import torch

    _build, lib, smoke = _ab.load_tree(root, "all")
    from ilqr_tpu_torch.ops import kernel_backward

    dev = torch.device("cuda")
    res = dict(tree=tag, root=str(root), smi=smoke.nvidia_smi(), paths={})
    ptx = _ab.ptxas(lib.parent / "ptxas.log", _backward_key)
    res["compile_seconds"] = json.loads(
        (lib.parent / "compile_seconds.json").read_text())

    def reading(row, case):
        n, table, lib_n = N_OF[row], ptx, _build.library()
        if row == "unicycle_heading":   # the custom model's own library
            model = smoke.custom_models()[row]
            table = _ab.ptxas_text(_build.model_build_log(model),
                                   _backward_key)
            lib_n = _build.lib_for(model)
        occ = _occupancy(lib_n, n, case.args[1].shape[-1])
        if occ is None:   # one-thread blocks of 64
            p = table.get(f"n={n}", {})
            occ = (_ab.regs_blocks(p.get("registers", 255)), 64, 0, None)
        else:
            p = table.get(occ[3], {})
        return dict(p, blocks_per_sm=occ[0], block_threads=occ[1],
                    smem_per_block=occ[2])

    res["rows"] = _ab.time_rows(smoke, dev, ROWS, reading)

    if check:   # the team kernel against the plain version, bit for bit
        import pytest

        t0 = time.perf_counter()
        rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", "-q",
                          str(CHANGE / "tests"
                              / "test_torch_cuda_backward_team.py")])
        if rc != 0:
            raise AssertionError(f"the backward team tests: pytest exit {rc}")
        res["edge_cases"] = dict(bitwise=True,
                                 seconds=time.perf_counter() - t0)

    comp = None
    for path, (name, kind) in PATHS.items():
        label = f"[{tag}] {path}"
        kernel_backward.backward_sweep_packed.launches = 0
        if kind == "composable":
            model, params, cfg = smoke.flagship()
            fused_out = smoke.run_main_path(dev, model, params, cfg)
            comp = smoke.run_composable_path(dev, model, params, cfg,
                                             fused_out)
            r = _ab.path_reading(comp, KERNEL)
            r["backward_ms_per_launch"] = comp.get("backward_ms_per_launch")
        elif kind == "split_sweep":   # run_composable_path's own split solve
            ss = comp["split_sweep"]
            its = max(1.0, ss["wall_s"] * 1e3 / ss["ms_per_iteration"])
            r = dict(solves_per_s=ss["solves_per_s"],
                     ms_per_iteration=ss["ms_per_iteration"],
                     host_iterations=round(its), max_iter=None,
                     launches_per_iteration=(
                         ss["backward_launches_per_iteration"]),
                     mean_cost=ss["mean_cost"], busy_share=None,
                     device_ms_by_kernel=None)
        else:
            out, _c = smoke.run_fd_path(dev, name, label, B=smoke.B_M,
                                        profile=True, **SPLIT)
            r = _ab.path_reading(out, KERNEL)
        res["paths"][path] = r
        print(f"{label}: {r}", flush=True)
    return res


def summary(passes):
    print(f"[ab] build s parent "
          f"{max(passes[0]['compile_seconds'].values()):.1f} (longest "
          f"source), change {max(passes[1]['compile_seconds'].values()):.1f}")
    _ab.summary_rows(passes, ROWS)
    _ab.summary_paths(passes, PATHS, KERNEL)
    if "acrobot/composable" in PATHS:
        print("[ab] path acrobot/composable: backward ms a launch (profiled) "
              + " / ".join(
                  "n/a" if p["paths"]["acrobot/composable"].get(
                      "backward_ms_per_launch") is None else
                  f"{p['paths']['acrobot/composable']['backward_ms_per_launch']:.3f}"
                  for p in passes))


def main() -> int:
    ap = _ab.parser(__doc__, "backward_ab.json")
    args = ap.parse_args()
    extra = _ab.select(args, ROWS, PATHS)
    if "acrobot/split_sweep" in PATHS and "acrobot/composable" not in PATHS:
        raise SystemExit("acrobot/split_sweep is read from the "
                         "acrobot/composable path's run")
    return _ab.run(args, ap, Path(__file__).resolve(), worker, ROWS, PATHS,
                   summary, extra)


if __name__ == "__main__":
    sys.exit(main())
