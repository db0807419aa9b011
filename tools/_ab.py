"""What the A/B tools (tools/iteration_ab.py, tools/sweep_ab.py) share: a
tree's package with a library of some of its kernel sources built and bound,
ptxas readings, output digests, and the four passes (parent, change, change,
parent), each in a process of its own, with their outputs and mean costs
held equal across the trees.

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


def load_tree(root: Path, tag: str, sources):
    """The package of ``root`` with a library of its csrc ``sources`` built
    (the package's own nvcc flags, under its build/ilqr_tpu_torch/<tag>-<the
    sources' hash>) and bound in place of the whole library; the change's
    chip_smoke.py as a module. Returns (_build, the library's path,
    chip_smoke)."""
    sys.path.insert(0, str(root))
    import ilqr_tpu_torch
    from ilqr_tpu_torch.ops import _build

    if Path(ilqr_tpu_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {ilqr_tpu_torch.__file__}, not "
                           f"{root}'s package")
    out_dir = _build.BUILD_ROOT / f"{tag}-{_build.source_hash()}"
    lib = _build._build_library(out_dir, [_build.CSRC / s for s in sources],
                                _build.LIB_NAME)
    _build.library = functools.lru_cache(maxsize=None)(
        lambda: _build._bind_shared(ctypes.CDLL(str(lib))))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", CHANGE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return _build, lib, smoke


def ptxas(log_path: Path, key_of) -> dict:
    """key → registers, stack, spill stores and loads, and static shared
    memory where there is any, of the kernels of a ptxas -v log that
    ``key_of(source, mangled name)`` files under a key (None: not read)."""
    out, key, source = {}, None, None
    for line in log_path.read_text().splitlines():
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


def digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def parser(doc: str, out_name: str) -> argparse.ArgumentParser:
    """The tools' shared arguments: PARENT_ROOT, --out (default
    build/<out_name>), and the passes' own --worker ROOT TAG and --check."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("parent", nargs="?")
    ap.add_argument("--out", default=str(CHANGE / "build" / out_name))
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "TAG"))
    ap.add_argument("--check", action="store_true")
    return ap


def _pass(script: Path, tree: Path, tag: str, check: bool) -> dict:
    t0 = time.perf_counter()
    cmd = [sys.executable, str(script), "--worker", str(tree), tag] + (
        ["--check"] if check else [])
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=str(tree))
    sys.stdout.write(proc.stdout[-8000:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-8000:])
        raise SystemExit(f"pass {tag} failed")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT "))
    return dict(json.loads(line[len("RESULT "):]),
                seconds=time.perf_counter() - t0)


def run(args, ap, script: Path, worker, rows, paths, summary) -> int:
    """A worker's pass (``--worker``), or the four passes: ``worker(root,
    tag, check)`` on each tree in a process of its own, the change's first
    with check; then every row's digest and every path's mean cost held
    equal across the passes, the passes written to --out as JSON and
    ``summary(passes)`` printed."""
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
    passes = [_pass(script, trees[tag], tag, i == 1)
              for i, tag in enumerate(PASSES)]
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
    print(f"[ab] {passes[0]['smi']}; passes {', '.join(PASSES)} ({secs} s)")
    summary(passes)
    return 0
