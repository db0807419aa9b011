"""What the A/B tools (tools/{iteration,sweep,linesearch,backward}_ab.py)
share: a tree's package with a library of some of its kernel sources built
and bound, ptxas readings, output digests, and the passes in turns (parent,
change, change, parent, and so on: four unless --passes says more), each in
a process of its own, with their outputs and mean costs held equal across
the trees.

A tool supplies its rows (phase-3 cases of chip_smoke.py, each pass's
readings under ``rows``, each with an output ``digest``), its paths (each
pass's readings under ``paths``, each with a ``mean_cost``), a worker that
takes one pass on a tree and a summary that prints the passes.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

CHANGE = Path(__file__).resolve().parents[1]
PASSES = ("parent", "change", "change", "parent")


def pass_order(n: int) -> tuple:
    """``n`` passes in turns: parent, change, change, parent, parent, …"""
    if n < 2 or n % 2:
        raise ValueError(f"--passes takes an even count ≥ 2, got {n}")
    return tuple(PASSES[i % 4] for i in range(n))


def _sides(passes):
    """The parent's passes and the change's, each in its order."""
    return ([p for p in passes if p["tree"] == "parent"],
            [p for p in passes if p["tree"] == "change"])


def load_tree(root: Path, tag: str, sources=None):
    """The package of ``root`` with a library of its csrc ``sources`` built
    (every csrc/*.cu where None; the package's own nvcc flags, under its
    build/ilqr_tpu_torch/<tag>-<the sources' hash>) and bound in place of
    the whole library; the change's chip_smoke.py as a module. A tree
    whose generated headers declare no team rule (before the custom
    models' team kernels) gets ops.codegen.team_width = 1, its custom
    models' one-thread kernels, for chip_smoke's names. Returns (_build,
    the library's path, chip_smoke)."""
    sys.path.insert(0, str(root))
    import ilqr_tpu_torch
    from ilqr_tpu_torch.ops import _build, codegen

    if not hasattr(codegen, "team_width"):
        codegen.team_width = lambda n, m: 1

    if Path(ilqr_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {ilqr_tpu_torch.__file__}, not "
                           f"{root}'s package")
    out_dir = _build.BUILD_ROOT / f"{tag}-{_build.source_hash()}"
    units = (sorted(_build.CSRC.glob("*.cu")) if sources is None
             else [_build.CSRC / s for s in sources])
    lib = _build._build_library(out_dir, units, _build.LIB_NAME)
    _build.library = functools.lru_cache(maxsize=None)(
        lambda: _build._bind_shared(ctypes.CDLL(str(lib))))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", CHANGE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return _build, lib, smoke


def ptxas(log_path: Path, key_of) -> dict:
    """key → registers, stack, spill stores and loads, and static shared
    memory where there is any, of the kernels of a ptxas -v log file that
    ``key_of(source, mangled name)`` files under a key (None: not read)."""
    return ptxas_text(log_path.read_text(), key_of)


def ptxas_text(log: str, key_of) -> dict:
    """:func:`ptxas` on the log's text."""
    out, key, source = {}, None, None
    for line in log.splitlines():
        if line.startswith("ptxas log of "):
            source = line.split()[-1]
        elif "Compiling entry function" in line:
            key = key_of(source, line.split("'")[1])
            if key is not None:
                out[key] = {}
        elif key and "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[key].update(stack=nums[0], spill_stores=nums[1],
                            spill_loads=nums[2])
        elif key and "Used" in line and "registers" in line:
            out[key]["registers"] = int(line.split("Used")[1].split()[0])
            if "bytes smem" in line:
                out[key]["static_smem"] = int(
                    line.split("bytes smem")[0].split()[-1])
            key = None
    return out


def form_of(name: str) -> str:
    """The derivative form of a kernel by its mangled name."""
    return ("fd" if "FiniteDiff" in name else
            "jvp" if "Jvp" in name else "analytic")


def regs_blocks(regs: int, block: int = 64) -> int:
    """Blocks of ``block`` threads an SM holds by its 64 Ki registers
    (allocated per warp in units of 256) and its 2 048 threads."""
    per_warp = -(-regs * 32 // 256) * 256
    warps = block // 32
    return min(32, 2048 // block, 65536 // (per_warp * warps))


def occupancy(lib, fname: str, limits, registers: int, three=None):
    """(blocks an SM holds, threads a block, dynamic shared memory bytes a
    block) of the kernel that a launcher launches: from the tree's entry
    point ``fname`` (ilqr_<model>_<kernel>[_fd|_jvp]_blocks_per_sm; use_limits
    first unless ``limits`` is None, then the threads and the bytes), from
    the one-argument form that trees before the line-search team gave
    acrobot's team iteration (blocks of 128), else from the kernel's
    ``registers`` (one-thread blocks of 64). ``three``: whether the entry
    point takes the threads and bytes (a custom model's library: True),
    else told by the library."""
    fn = getattr(lib, fname, None)
    if three is None:
        three = (hasattr(lib, "ilqr_acrobot_linesearch_blocks_per_sm")
                 or "_sweep" in fname)
    if fn is not None and three:
        ptr = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = ([] if limits is None else [ctypes.c_int]) + [ptr] * 2
        fn.restype = ctypes.c_int
        threads, smem = ctypes.c_int(0), ctypes.c_int(0)
        blocks = fn(*([] if limits is None else [int(limits)]),
                    ctypes.byref(threads), ctypes.byref(smem))
        return blocks, threads.value, smem.value
    if fn is not None:
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        return fn(int(limits)), 128, 0
    return regs_blocks(registers), 64, 0


def time_rows(smoke, dev, rows, reading):
    """Each row (key → (phase-3 case builder, case label)): the case's
    kernel timed (CUDA events, median of 5), a digest of its outputs and
    ``reading(row, case)``'s fields; the cases built once per builder."""
    import torch

    out, cases = {}, {}
    for row, (builder, label) in sorted(rows.items(),
                                        key=lambda kv: kv[1][0]):
        if builder not in cases:
            cases = {builder: smoke.build_cases(dev, builder)}
        case = cases[builder][label]
        ms = smoke.time_ms(lambda: case.op(*case.args), reps=5)
        outs = case.op(*case.args)
        torch.cuda.synchronize()
        out[row] = dict(ms=ms, digest=digest(outs), where=case.where,
                        **reading(row, case))
        print(f"row {row}: {out[row]}", flush=True)
    del cases
    torch.cuda.empty_cache()
    return {row: out[row] for row in rows}


def custom_ptxas(build, smoke, name: str, key_of) -> dict:
    """:func:`ptxas_text` of the custom model ``name``'s library (phase 15's
    models, chip_smoke.custom_models; built here if it is not yet), its
    keys ``key_of(source, mangled name)``."""
    model = smoke.custom_models()[name]
    build.build_model(model)
    return ptxas_text(build.model_build_log(model), key_of)


def custom_reading(build, smoke, kind: str, ptx: dict):
    """The ``reading`` of :func:`time_rows` for a custom model's ``kind``
    rows ("iteration", "sweep", "linesearch"; rows name/form[/…]): ptxas's
    figures of the row's kernel from ``ptx`` (name → :func:`custom_ptxas`
    keyed by form and limits, or by "linesearch") and the occupancy of its
    launcher in the model's library."""
    forms = {"jvp": "jvp", "jvp_rk4": "jvp", "fd": "fd", "euler": None,
             "rk4": None}

    def reading(row, case):
        name, form = row.split("/")[:2]
        mode = forms[form]
        model = smoke.custom_models()[name]
        if mode is None:   # the line search
            p = ptx[name].get("linesearch", {})
            fname, limits = f"ilqr_{name}_linesearch_blocks_per_sm", None
        else:
            p = ptx[name].get(f"{mode}/limits=True", {})
            fname, limits = f"ilqr_{name}_{kind}_{mode}_blocks_per_sm", True
        blocks, threads, smem = occupancy(build.lib_for(model), fname,
                                          limits, p.get("registers", 255),
                                          three=True)
        return dict(p, blocks_per_sm=blocks, block_threads=threads,
                    smem_per_block=smem)

    return reading


def custom_key(kind: str):
    """The key_of of :func:`custom_ptxas` for ``kind``'s kernels (one-thread
    or team): the line search's "linesearch", else form and limits."""
    def key_of(source, name):
        if kind == "linesearch":
            return "linesearch" if "linesearch" in name else None
        if f"{kind}_" in name and source in ("fd.cu", "jvp.cu"):
            return f"{form_of(name)}/limits={'Lb1E' in name}"
        return None
    return key_of


def custom_fleet(smoke, dev, name: str, variant: str, label: str) -> dict:
    """chip_smoke.py phase 15(b)'s fleet (``name`` "unicycle", B = 1024,
    T = 80, max_iter 40, one of CUSTOM_VARIANTS; or unicycle_heading, one
    of HEADING_VARIANTS): a warm-up, one timed solve with its launches,
    and one profiled solve for the device's busy share."""
    model, params, cfg, T, dt, u0, x0 = smoke.custom_problem(name)
    cfg = cfg.replace(**(smoke.CUSTOM_VARIANTS if name == "unicycle"
                         else smoke.HEADING_VARIANTS)[variant])
    init = smoke._initial_costs(dev, model, smoke.kernel_rollout.pack_params(
        params, dt, dev), T, u0, x0)
    out, _cost = smoke._custom_fleet(dev, name, variant, x0, u0, init)
    out["profile"] = smoke.profile_solve(
        label, lambda x0_, u0_: smoke.solve_batch_fused(
            model, params, cfg, dt, x0_, u0_), out["wall_s"], x0, u0)
    return out


def path_reading(out: dict, kernel: str) -> dict:
    """A path's readings: solves/s, ms per iteration, host iterations,
    ``kernel``'s launches per host iteration, mean cost, and its profiled
    solve's device busy share and device ms by kernel (where it has one)."""
    its = out["host_iterations"]
    prof = out.get("profile") or {}
    return dict(solves_per_s=out["solves_per_s"],
                ms_per_iteration=out["ms_per_iteration"],
                host_iterations=its, max_iter=out.get("max_iter"),
                launches_per_iteration=out["launches"][kernel] / max(1, its),
                mean_cost=out["mean_cost"],
                busy_share=prof.get("device_busy_share"),
                device_ms_by_kernel=prof.get("device_ms_by_kernel"))


def summary_rows(passes, rows):
    """The rows' times in the passes (and the change's speed-up: the
    parent's mean over the change's), with the parent's and the change's
    registers, stack, spills and blocks."""
    parents, changes = _sides(passes)
    for row in rows:
        r = [p["rows"][row] for p in passes]
        par, chg = parents[0]["rows"][row], changes[0]["rows"][row]
        mean = lambda side: sum(p["rows"][row]["ms"] for p in side) / len(
            side)
        speed = mean(parents) / mean(changes)
        print(f"[ab] row {row}: ms " + " / ".join(f"{x['ms']:.3f}" for x in r)
              + f" ({speed:.2f}x); parent {par.get('registers')} regs "
              f"{par.get('stack')} B stack {par.get('spill_stores')}/"
              f"{par.get('spill_loads')} B spills, {par['blocks_per_sm']} "
              f"blocks of {par['block_threads']}/SM; change "
              f"{chg.get('registers')} regs {chg.get('stack')} B stack "
              f"{chg.get('spill_stores')}/{chg.get('spill_loads')} B spills, "
              f"{chg['blocks_per_sm']} blocks of {chg['block_threads']}/SM "
              f"with {chg.get('smem_per_block')} B shared each; "
              f"{par['where']}; outputs equal")


def summary_paths(passes, paths, kernel):
    """The paths' readings in the passes; ``kernel``'s launches per
    iteration and device ms by kernel of the parent's and change's first
    passes."""
    parents, changes = _sides(passes)
    for path in paths:
        r = [p["paths"][path] for p in passes]
        firsts = (parents[0]["paths"][path], changes[0]["paths"][path])
        print(f"[ab] path {path}: solves/s " + " / ".join(
            f"{x['solves_per_s']:.1f}" for x in r) + "; ms/iteration "
            + " / ".join(f"{x['ms_per_iteration']:.3f}" for x in r)
            + f"; host iterations {r[0]['host_iterations']} (max_iter "
            f"{r[0]['max_iter']}); {kernel}/iteration "
            + " / ".join(f"{x['launches_per_iteration']:.2f}" for x in r)
            + "; busy " + " / ".join(
                "n/a" if x["busy_share"] is None else f"{x['busy_share']:.3f}"
                for x in r)
            + "; device ms by kernel " + " / ".join(
                json.dumps({k: round(v, 1) for k, v in
                            (x["device_ms_by_kernel"] or {}).items()})
                for x in firsts)
            + f"; mean cost {r[0]['mean_cost']}")


def digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def parser(doc: str, out_name: str) -> argparse.ArgumentParser:
    """The tools' shared arguments: PARENT_ROOT, --out (default
    build/<out_name>), --passes (an even count, 4 by default), and the
    passes' own --worker ROOT TAG and --check."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("parent", nargs="?")
    ap.add_argument("--out", default=str(CHANGE / "build" / out_name))
    ap.add_argument("--passes", type=int, default=len(PASSES),
                    help="passes in turns, parent first (default 4)")
    ap.add_argument("--only", default=None,
                    help="comma-separated prefixes of the rows and paths "
                         "to take (default: all)")
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "TAG"))
    ap.add_argument("--check", action="store_true")
    return ap


def select(args, rows: dict, paths: dict) -> list:
    """Keeps in ``rows`` and ``paths`` (in place) the keys that start with
    one of --only's prefixes, where it is given; returns the arguments that
    hand the same choice to each pass."""
    if not args.only:
        return []
    prefixes = tuple(args.only.split(","))
    for d in (rows, paths):
        for key in [k for k in d if not k.startswith(prefixes)]:
            del d[key]
    if not rows and not paths:
        raise SystemExit(f"--only {args.only}: no row or path")
    return ["--only", args.only]


def _pass(script: Path, tree: Path, tag: str, check: bool,
          extra=()) -> dict:
    t0 = time.perf_counter()
    cmd = [sys.executable, str(script), "--worker", str(tree), tag] + (
        ["--check"] if check else []) + list(extra)
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(tree))
    sys.stdout.write(proc.stdout[-8000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise SystemExit(f"pass {tag} failed")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT "))
    return dict(json.loads(line[len("RESULT "):]),
                seconds=time.perf_counter() - t0)


def run(args, ap, script: Path, worker, rows, paths, summary,
        extra=()) -> int:
    """A worker's pass (``--worker``), or the passes in turns (--passes):
    ``worker(root, tag, check)`` on each tree in a process of its own, the
    change's first with check; then every row's digest and every path's
    mean cost held equal across the passes, the passes written to --out as
    JSON and ``summary(passes)`` printed. ``extra``: arguments every pass's
    command line repeats."""
    if args.worker:
        root, tag = args.worker
        print("RESULT " + json.dumps(worker(Path(root).resolve(), tag,
                                            args.check)), flush=True)
        return 0
    if args.parent is None:
        ap.error("PARENT_ROOT is required")
    import torch

    if not torch.cuda.is_available():
        print(f"{script.stem}: no CUDA device", file=sys.stderr)
        return 2
    trees = {"parent": Path(args.parent).resolve(), "change": CHANGE}
    order = pass_order(args.passes)
    passes = [_pass(script, trees[tag], tag, i == 1,
                    extra) for i, tag in enumerate(order)]
    for row in rows:
        digests = {p["rows"][row]["digest"] for p in passes}
        if len(digests) != 1:
            raise AssertionError(f"{row}: the trees' outputs differ "
                                 f"({digests})")
    for p in passes:
        for path in paths:
            ref = passes[0]["paths"][path]["mean_cost"]
            if p["paths"][path]["mean_cost"] != ref:
                raise AssertionError(f"{path}: mean cost "
                                     f"{p['paths'][path]['mean_cost']} "
                                     f"against the parent's {ref}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(passes, indent=1))
    secs = ", ".join(f"{p['seconds']:.1f}" for p in passes)
    print(f"[ab] {passes[0]['smi']}; passes {', '.join(order)} ({secs} s)")
    summary(passes)
    return 0
