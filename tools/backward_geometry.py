#!/usr/bin/env python3
"""The backward kernel's launch geometries, in turns on one card.

    python3 tools/backward_geometry.py [--rounds N] [--out FILE]

csrc/backward.cuh's kernel is a template on <N, VEC, WARPS>: 16-byte
(VEC = 4) or 4-byte (VEC = 1) cp.async copies, and one or two warps a
block; its launcher picks one per launch (backward::with_kernel). This
script instantiates all four for n = 2, 3 and 4 in a library of its own
(the package's nvcc flags, under build/ilqr_tpu_torch/geometry-<hash>) and
times them at the backward_sweep_packed rows' shapes: acrobot (n = 4,
B = 8192, T = 499), cartpole (n = 4, B = 1024, T = 299), pendulum (n = 2,
B = 1024, T = 199) and unicycle_heading (n = 3, B = 1024, T = 80), on
inputs drawn from a seed (the kernel's time does not depend on their
values). The geometries run in turns, first to last and back, --rounds
times (CUDA events, median of 21 launches each); every geometry's outputs
must digest the same. Prints each geometry's least, median and largest
time per row and the card's name and power limit; the readings go to FILE
as JSON (default build/backward_geometry.json). Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import sys
from pathlib import Path

CHANGE = Path(__file__).resolve().parents[1]
# row: (n, B, T)
ROWS = {"acrobot": (4, 8192, 499), "cartpole": (4, 1024, 299),
        "pendulum": (2, 1024, 199), "unicycle_heading": (3, 1024, 80)}
# geometry: (VEC, WARPS)
GEOMETRIES = {"16-byte, 2 warps": (4, 2), "16-byte, 1 warp": (4, 1),
              "4-byte, 2 warps": (1, 2), "4-byte, 1 warp": (1, 1)}


def source() -> str:
    """A launcher geometry_n<N>_v<VEC>_w<WARPS> for every n and geometry,
    with ilqr_backward_n<N>'s arguments."""
    out = ['#include "backward.cuh"\n',
           "template <int N, int VEC, int WARPS>\n"
           "int go(const void* const* a, int T, int B, void* stream) {\n"
           "  const int err = backward::prepare<N, VEC, WARPS>();\n"
           "  if (err != 0) return err;\n"
           "  constexpr int L = backward::kLanes<N, WARPS>;\n"
           "  const float* const* f = (const float* const*)a;\n"
           "  backward::backward_team_kernel<N, VEC, WARPS><<<(B + L - 1) / L,"
           " backward::kThreads<WARPS>, backward::kSmemBytes<N, WARPS>,"
           " (cudaStream_t)stream>>>(\n"
           "      backward::Inputs{f[0], f[1], f[2], f[3], f[4], f[5], f[6],"
           " f[7], f[8]}, f[9], f[10], f[11], (float*)a[12], (float*)a[13],"
           " (float*)a[14], (float*)a[15], T, B);\n"
           "  return (int)cudaGetLastError();\n}\n"]
    for n in sorted({n for n, _B, _T in ROWS.values()}):
        for vec, warps in GEOMETRIES.values():
            out.append(f'extern "C" int geometry_n{n}_v{vec}_w{warps}('
                       "const void* const* a, int T, int B, void* s) "
                       f"{{ return go<{n}, {vec}, {warps}>(a, T, B, s); }}\n")
    return "".join(out)


def inputs(torch, dev, n, B, T, seed):
    """The kernel's twelve lane-last inputs and four outputs: a
    near-identity fx, cuu > 0, lo < 0 < hi, λ = 1."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: 0.01 * torch.randn(*s, generator=g)
    eye = torch.eye(n)
    ins = [eye.reshape(1, n, n, 1) + r(T, n, n, B), r(T, n, B) + 0.1,
           r(T, n, B), r(T, B), 0.1 * eye.reshape(1, n, n, 1)
           + r(T, n, n, B), r(T, n, B), r(T, B).abs() + 1.0,
           torch.full((T, B), -0.5), torch.full((T, B), 0.5), torch.ones(B),
           r(n, B), eye.reshape(n, n, 1) + r(n, n, B)]
    outs = [torch.empty(T, B), torch.empty(T, n, B), torch.empty(2, B),
            torch.empty(B)]
    return [t.to(dev).contiguous() for t in ins + outs]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=6,
                    help="rounds of the geometries, first to last and back")
    ap.add_argument("--out", default=str(CHANGE / "build"
                                         / "backward_geometry.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("backward_geometry: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(CHANGE))
    import chip_smoke
    from ilqr_tpu_torch.ops import _build

    text = source()
    d = _build.BUILD_ROOT / ("geometry-" + hashlib.sha256(
        (text + _build.source_hash()).encode()).hexdigest()[:16])
    d.mkdir(parents=True, exist_ok=True)
    (d / "geometry.cu").write_text(text)
    lib = ctypes.CDLL(str(_build._build_library(
        d, [d / "geometry.cu"], "libgeometry.so",
        extra=("-I", str(_build.CSRC)))))
    dev = torch.device("cuda")
    out = dict(smi=chip_smoke.nvidia_smi(), ms={})
    for row, (n, B, T) in ROWS.items():
        ts = inputs(torch, dev, n, B, T, seed=0)
        ptrs = (ctypes.c_void_p * 16)(*[t.data_ptr() for t in ts])
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        names = list(GEOMETRIES)
        times = {g: [] for g in names}
        digest = None
        for g in (names + names[::-1]) * args.rounds:
            vec, warps = GEOMETRIES[g]
            fn = getattr(lib, f"geometry_n{n}_v{vec}_w{warps}")
            fn.restype = ctypes.c_int

            def launch():
                err = fn(ptrs, ctypes.c_int(T), ctypes.c_int(B), stream)
                if err:
                    raise RuntimeError(f"{row} {g}: CUDA error {err}")

            times[g].append(chip_smoke.time_ms(launch, reps=21))
            h = hashlib.sha256(b"".join(
                t.cpu().numpy().tobytes() for t in ts[12:])).hexdigest()
            if digest is not None and h != digest:
                raise AssertionError(f"{row}: {g} changes the outputs")
            digest = h
        out["ms"][row] = times
        print(f"[geometry] {row} (n={n}, B={B}, T={T}) ms least / median / "
              "largest: " + "; ".join(
                  f"{g} {min(v):.4f} / {sorted(v)[len(v) // 2]:.4f} / "
                  f"{max(v):.4f}" for g, v in times.items()), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"[geometry] {out['smi']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
