"""Builds the CUDA kernels of ``csrc/`` with nvcc and binds them with ctypes.

The library is built on first use into ``build/ilqr_tpu_torch/<hash>/`` at
the repository root, keyed by a hash of the sources and the flags, so a
fresh checkout builds everything it runs and a changed source rebuilds. Each
``csrc/*.cu`` is compiled to an object by its own nvcc process, all started
together, and the objects are linked into one shared library; the library
has a plain C interface (no PyTorch headers). Each source's nvcc seconds
are kept beside the library (``compile_seconds()``), with ptxas's report
(``build_log()``).

Every launcher takes its pointers as ``c_void_p`` and PyTorch's current
stream, launches asynchronously and returns ``cudaGetLastError()``;
:func:`launch` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "ilqr_tpu_torch"
LIB_NAME = "libilqr_tpu_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # keep a*b+c as two rounded operations, as the plain versions compute
    # them; no --use_fast_math (IEEE division, full-accuracy sincosf)
    "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the launchers in csrc/*.cu, in argument order. The fused
# solver's four kernels have one launcher per model, ilqr_<model>_<kernel>
# (each model's own csrc/kernels*.cu), all with the signature of <kernel>,
# the packed params and their lane stride (0 shared, P for one row per
# lane) first; the rollout and line-search launchers take the integrator
# (0 Euler, 1 RK4). The stencil sweep and iteration kernels, ilqr_<model>_<kernel>_fd
# (csrc/kernels_<model>_fd.cu), take their analytic twins' arguments and
# then the integrator and the stencil's eps, 2·eps and 4·eps²; the
# dual-number ones, ilqr_<model>_<kernel>_jvp (csrc/kernels_<model>_jvp.cu),
# their analytic twins' arguments and then the integrator. The derivative
# kernel has one launcher per model, ilqr_<model>_derivs (csrc/derivs.cu),
# and the backward kernel one per state dimension, ilqr_backward_n<n>
# (csrc/backward.cu).
_PARAMS = [_P, _I]   # the packed params and their lane stride (0 or P)
_SWEEP = _PARAMS + [_P] * 9 + [_I, _I, _I]
_ITERATION = (_PARAMS + [_P] * 7 + [_I] + [_P] * 16
              + [_F, _F, _F, _I, _I, _I, _I])
_STENCIL = [_I, _F, _F, _F]
_FUSED_SIGNATURES = {
    "rollout": _PARAMS + [_P] * 8 + [_I, _I, _I, _I, _P],
    "sweep": _SWEEP + [_P],
    "linesearch": (_PARAMS + [_P] * 9 + [_I] + [_P] * 14
                   + [_F, _I, _I, _I, _I, _P]),
    "iteration": _ITERATION + [_P],
    "sweep_fd": _SWEEP + _STENCIL + [_P],
    "iteration_fd": _ITERATION + _STENCIL + [_P],
    "sweep_jvp": _SWEEP + [_I, _P],
    "iteration_jvp": _ITERATION + [_I, _P],
    "derivs": _PARAMS + [_P] * 9 + [_I, _I, _F, _F, _F, _I, _I, _P],
}
_BACKWARD = [_P] * 16 + [_I, _I, _P]
_SIGNATURES = {"ilqr_backward_n2": _BACKWARD, "ilqr_backward_n4": _BACKWARD}


def signature(name: str):
    """The ctypes argument types of launcher ``name``."""
    if name in _SIGNATURES:
        return _SIGNATURES[name]
    for suffix in ("_fd", "_jvp", ""):
        if name.endswith(suffix):
            kernel = name.removesuffix(suffix).rsplit("_", 1)[-1] + suffix
            if name.startswith("ilqr_") and kernel in _FUSED_SIGNATURES:
                return _FUSED_SIGNATURES[kernel]
    raise KeyError(f"no launcher {name!r}")


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the ilqr_tpu_torch CUDA kernels "
            "are built from source on first use")
    return found


def build() -> Path:
    """Compiles every ``csrc/*.cu`` into the hashed build directory unless
    the library is already there; returns its path. The sources compile in
    parallel, one nvcc each; the compiler's register/spill report is kept
    beside the library in ``ptxas.log``."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    units = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o",
                 str(Path(tmp) / (src.stem + ".o")), str(src)]
                for src in units]
        # one thread per nvcc, so that each source's own seconds are known
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            results = list(pool.map(_compile, cmds))
        for cmd, (proc, _s) in zip(cmds, results):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
        logs = [f"ptxas log of {src.name}\n{proc.stderr}"
                for src, (proc, _s) in zip(units, results)]
        fd, tmp_lib = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, "-shared", "-o", tmp_lib,
               *sorted(str(o) for o in Path(tmp).glob("*.o"))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp_lib)
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
    (out_dir / "ptxas.log").write_text("".join(logs))
    (out_dir / "compile_seconds.json").write_text(json.dumps(
        {src.name: round(sec, 1) for src, (_p, sec) in zip(units, results)}))
    os.replace(tmp_lib, lib)  # atomic: a concurrent build never sees half
    return lib


def _compile(cmd):
    """Runs one nvcc; returns (the completed process, its seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc, time.perf_counter() - t0


def build_log() -> str:
    """What ptxas reported (registers, spills) for the current build."""
    log = BUILD_ROOT / source_hash() / "ptxas.log"
    return log.read_text() if log.exists() else ""


def compile_seconds() -> dict:
    """Each source's nvcc seconds in the build that made the current
    library ({} if it was built before this record existed)."""
    rec = BUILD_ROOT / source_hash() / "compile_seconds.json"
    return json.loads(rec.read_text()) if rec.exists() else {}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    lib.ilqr_error_string.argtypes = [ctypes.c_int]
    lib.ilqr_error_string.restype = ctypes.c_char_p
    lib.ilqr_max_alphas.argtypes = []
    lib.ilqr_max_alphas.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    """Launcher ``name`` of the library, its argument types bound."""
    fn = getattr(library(), name)
    fn.argtypes = signature(name)
    fn.restype = ctypes.c_int
    return fn


def require(t: torch.Tensor, shape, name: str, device: torch.device):
    """Checks what a kernel takes: f32, contiguous, on ``device``, with the
    given shape; raises ValueError otherwise."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch(name: str, device: torch.device, *args) -> None:
    """Calls launcher ``name`` on ``device``'s current stream with ``args``
    (tensors become their data pointers); raises if the launch failed."""
    fn = _launcher(name)
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*conv, stream)
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err}: "
            f"{library().ilqr_error_string(err).decode()}")
