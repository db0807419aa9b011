#!/usr/bin/env python3
"""The derivative kernel (derivs_packed) in two trees, in turns on one card.

    python3 tools/derivs_ab.py PARENT_ROOT [--out FILE] [--passes N]
        [--only PREFIXES]

PARENT_ROOT is a checkout of the commit to compare with (for example
``git archive <commit> | tar -x -C archive_check/parent``); the tree this
script lies in is the change. For each tree every csrc/*.cu source is built
with the package's own nvcc flags into a library of its own under the
tree's build/ilqr_tpu_torch/ (shared with tools/iteration_ab.py and
tools/sweep_ab.py), and ptxas's registers, stack and spills of the
derivative kernel are read from the build. Then the passes, parent,
change, change, parent (and so on, as --passes says), each in a process of
its own on that tree's package, take:

  - the derivs_packed rows and readings of chip_smoke.py phase 3 at its
    shapes and on its inputs: acrobot's four modes (B = 8192, T = 499: the
    dual numbers and the stencils, each with the Euler and the RK4 step),
    cartpole's and pendulum's (B = 1024, the CLI problems' T, the same four
    modes), point_mass_3d's and thruster_ring24's (B = 64, T = 20, phase
    14's composable batches: both modes with Euler), the custom unicycle's
    (both modes) and unicycle_heading's (B = 1024, T = 80, phase 15's;
    their own libraries); CUDA events, median
    of 5, and a digest of every output, which must be the same in both
    trees; each row's blocks per SM from ilqr_<model>_derivs_blocks_per_sm
    where a tree has it, else from its registers (blocks of 256);
  - the paths: the composable flagship (chip_smoke.py phase 6: solve_batch
    at B = 8192, T = 499, max_iter 100 on phase 4's draws, after the fused
    flagship solve that it is held against) — solves/s, ms per iteration,
    derivs_packed launches per host iteration, mean cost, and a profiled
    solve's device busy share, device ms by kernel and the derivative
    kernel's device ms a launch; acrobot's fused split sweep
    (sweep_kernel="split") on the same x0, one solve.

The change's first pass also runs tests/test_torch_cuda_derivs.py (the
kernel against derivs_plain on the card, bit for bit). The passes'
readings go to FILE as JSON (default build/derivs_ab.json) and a summary
is printed; the passes, builds and checks are tools/_ab.py's. Needs one
CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import sys
import time
from pathlib import Path

import _ab

CHANGE = _ab.CHANGE
# row: (phase 3 case builder, its label)
ROWS = {"acrobot/jvp": (("acrobot",), "derivs_packed (jvp)"),
        "acrobot/fd": (("acrobot",), "derivs_packed (fd)"),
        "acrobot/jvp_rk4": (("split", "acrobot"),
                            "derivs_packed/acrobot (jvp, rk4)"),
        "acrobot/fd_rk4": (("split", "acrobot"),
                           "derivs_packed/acrobot (fd, rk4)")}
for _name in ("cartpole", "pendulum"):
    for _mode in ("jvp", "fd"):
        for _integ, _form in (("euler", _mode), ("rk4", f"{_mode}_rk4")):
            ROWS[f"{_name}/{_form}"] = (
                ("split", _name), f"derivs_packed/{_name} ({_mode}, {_integ})")
for _name in ("point_mass_3d", "thruster_ring24"):
    for _mode in ("jvp", "fd"):
        ROWS[f"{_name}/{_mode}"] = (
            ("derivs", _name), f"derivs_packed/{_name} ({_mode}, euler)")
# the custom models (their own libraries), at phase 15's B = 1024, T = 80
ROWS["unicycle/jvp"] = (("custom", "unicycle"), "derivs_packed/unicycle (jvp)")
ROWS["unicycle/fd"] = (("custom", "unicycle"), "derivs_packed/unicycle (fd)")
ROWS["unicycle_heading/jvp"] = (("custom", "unicycle_heading"),
                                "derivs_packed/unicycle_heading (jvp)")
# path: kind (the split sweep is read from the composable path's run)
PATHS = {"acrobot/composable": "composable",
         "acrobot/split_sweep": "split_sweep"}
KERNEL = "derivs_packed"
DERIVS_KERNELS = ("derivs_entry_kernel", "derivs_kernel")


def _derivs_key(source: str, name: str):
    """The ptxas key of a derivative kernel instantiation: model and
    mode."""
    if not (source.startswith("derivs_")
            and any(k in name for k in DERIVS_KERNELS)):
        return None
    model = source.removeprefix("derivs_").removesuffix(".cu")
    return f"{model}/{'fd' if 'FiniteDiff' in name else 'jvp'}"


def _derivs_key_custom(source: str, name: str):
    """:func:`_derivs_key` for a custom model's library, whose derivative
    source is derivs.cu."""
    return _derivs_key("derivs_custom.cu" if source == "derivs.cu" else
                       source, name)


def _occupancy(lib, name: str, fd: bool, registers: int):
    """(blocks an SM holds, threads a block, dynamic shared memory bytes a
    block) of the derivative kernel of ``name`` in its mode, from the
    tree's ilqr_<name>_derivs_blocks_per_sm where it has one, else from
    the kernel's registers (blocks of 256)."""
    fn = getattr(lib, f"ilqr_{name}_derivs_blocks_per_sm", None)
    if fn is None:
        return _ab.regs_blocks(registers, 256), 256, 0
    ptr = ctypes.POINTER(ctypes.c_int)
    fn.argtypes, fn.restype = [ctypes.c_int, ptr, ptr], ctypes.c_int
    threads, smem = ctypes.c_int(0), ctypes.c_int(0)
    blocks = fn(int(fd), ctypes.byref(threads), ctypes.byref(smem))
    return blocks, threads.value, smem.value


def worker(root: Path, tag: str, check: bool) -> dict:
    """One pass on ``root``'s package (see the module's docstring)."""
    import torch

    _build, lib, smoke = _ab.load_tree(root, "all")
    from ilqr_tpu_torch.ops import kernel_derivs

    dev = torch.device("cuda")
    res = dict(tree=tag, root=str(root), smi=smoke.nvidia_smi(), paths={})
    ptx = _ab.ptxas(lib.parent / "ptxas.log", _derivs_key)
    res["compile_seconds"] = json.loads(
        (lib.parent / "compile_seconds.json").read_text())

    customs = smoke.custom_models()

    def reading(row, case):
        name, form = row.split("/")
        fd = form.startswith("fd")
        table, lib_n = ptx, _build.library()
        if name in customs:   # the custom model's own library
            table = {f"{name}/{k.split('/')[1]}": v for k, v in
                     _ab.ptxas_text(_build.model_build_log(customs[name]),
                                    _derivs_key_custom).items()}
            lib_n = _build.lib_for(customs[name])
        p = table.get(f"{name}/{'fd' if fd else 'jvp'}", {})
        blocks, threads, smem = _occupancy(lib_n, name, fd,
                                           p.get("registers", 255))
        return dict(p, blocks_per_sm=blocks, block_threads=threads,
                    smem_per_block=smem)

    res["rows"] = _ab.time_rows(smoke, dev, ROWS, reading)

    if check:   # the kernel against the plain version, bit for bit
        import pytest

        t0 = time.perf_counter()
        rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", "-q",
                          str(CHANGE / "tests"
                              / "test_torch_cuda_derivs.py")])
        if rc != 0:
            raise AssertionError(f"the derivative kernel tests: pytest exit "
                                 f"{rc}")
        res["edge_cases"] = dict(bitwise=True,
                                 seconds=time.perf_counter() - t0)

    comp = None
    for path, kind in PATHS.items():
        kernel_derivs.derivs_packed.launches = 0
        if kind == "composable":
            model, params, cfg = smoke.flagship()
            fused_out = smoke.run_main_path(dev, model, params, cfg)
            comp = smoke.run_composable_path(dev, model, params, cfg,
                                             fused_out)
            r = _ab.path_reading(comp, KERNEL)
            launches = smoke.launch_counts()[KERNEL]   # the profiled solve's
            prof = comp.get("profile") or {}
            ms = sum((prof.get("device_ms_by_kernel") or {}).get(k, 0.0)
                     for k in DERIVS_KERNELS)
            r["derivs_ms_per_launch"] = (ms / launches if prof and launches
                                         else None)
        else:   # run_composable_path's own split-sweep solve
            ss = comp["split_sweep"]
            its = max(1.0, ss["wall_s"] * 1e3 / ss["ms_per_iteration"])
            r = dict(solves_per_s=ss["solves_per_s"],
                     ms_per_iteration=ss["ms_per_iteration"],
                     host_iterations=round(its), max_iter=None,
                     launches_per_iteration=ss["launches"][KERNEL] / its,
                     mean_cost=ss["mean_cost"], busy_share=None,
                     device_ms_by_kernel=None)
        res["paths"][path] = r
        print(f"[{tag}] {path}: {r}", flush=True)
    return res


def summary(passes):
    print(f"[ab] build s parent "
          f"{max(passes[0]['compile_seconds'].values()):.1f} (longest "
          f"source), change {max(passes[1]['compile_seconds'].values()):.1f}")
    _ab.summary_rows(passes, ROWS)
    _ab.summary_paths(passes, PATHS, KERNEL)
    if "acrobot/composable" in PATHS:
        ms = [p["paths"]["acrobot/composable"].get("derivs_ms_per_launch")
              for p in passes]
        print("[ab] path acrobot/composable: derivative kernel ms a launch "
              "(profiled) " + " / ".join("n/a" if m is None else f"{m:.3f}"
                                         for m in ms))


def main() -> int:
    ap = _ab.parser(__doc__, "derivs_ab.json")
    args = ap.parse_args()
    extra = _ab.select(args, ROWS, PATHS)
    if "acrobot/split_sweep" in PATHS and "acrobot/composable" not in PATHS:
        raise SystemExit("acrobot/split_sweep is read from the "
                         "acrobot/composable path's run")
    return _ab.run(args, ap, Path(__file__).resolve(), worker, ROWS, PATHS,
                   summary, extra)


if __name__ == "__main__":
    sys.exit(main())
