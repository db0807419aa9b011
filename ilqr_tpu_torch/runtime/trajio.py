"""ctypes bindings for the native trajectory I/O library (counterpart of
``ilqr_tpu/runtime/trajio.py``): the reference-format CSV and the packed
binary batch format ("ILQT", little-endian) of ``native/trajio.cpp``.

The library is built with g++ on first use, not on import, into
``build/ilqr_tpu_torch/runtime/<hash>/libtrajio.so`` at the repository
root, keyed by a hash of the source and the flags (the package directory
stays as it is); :func:`library` raises ``OSError`` where it cannot be
built or loaded. Arrays are numpy arrays or tensors (on any device).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent / "native" / "trajio.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build" / "ilqr_tpu_torch"
              / "runtime")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libtrajio.so"


def build() -> Path:
    """Compiles ``native/trajio.cpp`` unless its library is there; returns
    the library's path. The library appears by an atomic rename, so
    concurrent builds never load half of one."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise OSError("no C++ compiler (g++) to build libtrajio.so")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise OSError(f"building libtrajio.so failed ({proc.returncode}): "
                      f"{proc.stderr[-2000:]}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The native library, built if needed and loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    lib.ilqt_write_csv.argtypes = [ctypes.c_char_p, _D, _D, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int]
    lib.ilqt_write_bin.argtypes = [ctypes.c_char_p, _D, _D, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ilqt_read_bin_header.argtypes = [ctypes.c_char_p, _I, _I, _I, _I]
    lib.ilqt_read_bin.argtypes = [ctypes.c_char_p, _D, _D]
    for fn in (lib.ilqt_write_csv, lib.ilqt_write_bin,
               lib.ilqt_read_bin_header, lib.ilqt_read_bin):
        fn.restype = ctypes.c_int
    return lib


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.float64)


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


def write_csv(path: str, xs, us) -> None:
    """Reference-format CSV (ref: src/ilqr_core.cpp:414-431): xs (T+1, n),
    us (T, m)."""
    xs, us = _f64(xs), _f64(us)
    T, m = us.shape
    rc = library().ilqt_write_csv(os.fsencode(path), _dptr(xs), _dptr(us),
                                  T, xs.shape[1], m)
    if rc != 0:
        raise OSError(f"ilqt_write_csv failed with code {rc}")


def write_batch(path: str, xs, us) -> None:
    """Binary batch format: xs (B, T+1, n), us (B, T, m) (or one
    trajectory without the batch axis)."""
    xs, us = _f64(xs), _f64(us)
    if xs.ndim == 2:
        xs, us = xs[None], us[None]
    B, Tp1, n = xs.shape
    Bu, T, m = us.shape
    if Bu != B or Tp1 != T + 1:
        raise ValueError(f"xs {xs.shape} and us {us.shape} do not pair")
    rc = library().ilqt_write_bin(os.fsencode(path), _dptr(xs), _dptr(us),
                                  B, T, n, m)
    if rc != 0:
        raise OSError(f"ilqt_write_bin failed with code {rc}")


def read_batch(path: str):
    """Reads a binary batch file → (xs (B, T+1, n), us (B, T, m)), f64
    numpy arrays."""
    dims = [ctypes.c_int() for _ in range(4)]
    lib = library()
    rc = lib.ilqt_read_bin_header(os.fsencode(path),
                                  *(ctypes.byref(d) for d in dims))
    if rc != 0:
        raise OSError(f"ilqt_read_bin_header failed with code {rc}")
    B, T, n, m = (d.value for d in dims)
    xs = np.empty((B, T + 1, n), dtype=np.float64)
    us = np.empty((B, T, m), dtype=np.float64)
    rc = lib.ilqt_read_bin(os.fsencode(path), _dptr(xs), _dptr(us))
    if rc != 0:
        raise OSError(f"ilqt_read_bin failed with code {rc}")
    return xs, us
