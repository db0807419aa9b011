#!/usr/bin/env python3
"""Drives ilqr_tpu_torch's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: the four CUDA kernels from ilqr_tpu_torch/csrc with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes (B = 8192, T = 499, A = 11), with times (CUDA events);
  4. the main path: acrobot swing-up through solve_batch_fused at B = 8192,
     T = 499, max_iter = 100 — solves/s, cost, iterations, launch counts;
     then one more solve under torch.profiler for the device time by
     kernel and the device's busy share;
  5. the split route (sweep + line-search kernels) against the merged one,
     and the kernel path against the plain path on the card, at B = 1024,
     max_iter = 12; beside them, not asserted, the plain path on the CPU and
     the kernel path from an x0 moved by 1e-6, which show how far rounding
     alone carries a lane on this chaotic workload;
  6. one JSON line listing every kernel, the card's line, and the last
     line {"ok": true, "device": {...}}.

It needs one CUDA device and the ilqr_tpu_torch package beside it; without
either it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ilqr_tpu_torch import SolverConfig, fused, get_model, solve_batch_fused
from ilqr_tpu_torch.models import acrobot
from ilqr_tpu_torch.ops import (
    _build,
    kernel_iter,
    kernel_rollout,
    kernel_sweep,
    launch_counts,
    reset_launch_counts,
)

B_MAIN, T, DT, MAX_ITER = 8192, 499, 0.02, 100
B_SPLIT, ITER_SPLIT = 1024, 12
N, M = 4, 1
# Kernel vs plain version: both run the same IEEE f32 operations in the
# same order (nvcc --fmad=false, no fast math); the trig libraries
# (libdevice sincosf vs torch.sin/cos) may still differ by an ulp, which 499
# steps carry forward. Max |a − b| / (1 + |b|) over every output.
KERNEL_TOL = 1e-4
# Whole solves compared lane by lane (experiments/equiv_tpu.py's gauge):
# acrobot amplifies rounding chaotically, so per-lane relative cost
# |c1 − c2| / (1 + |c2|) must have p99 ≤ 1e-3 and max ≤ 5e-2 at 12 iterations.
GAUGE_P99, GAUGE_MAX = 1e-3, 5e-2
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# f32 operations per lane and timestep, counted by hand from csrc/ with each
# sincosf counted as one operation (so the bound stays a lower bound):
# closed-loop rollout step ≈ 80, merged linearize + backward step ≈ 520.
OPS_ROLLOUT_STEP, OPS_SWEEP_STEP = 80, 520
MAIN_TPU_MEAN_COST = 9.038   # BENCH_r05.json, TPU v5e f32 kernels

REPLACES = {
    "rollout_packed": "ilqr_tpu/ops/pallas_rollout.py:211",
    "linesearch_packed": "ilqr_tpu/ops/pallas_rollout.py:484",
    "sweep_packed": "ilqr_tpu/ops/pallas_sweep.py:1108",
    "iteration_packed": "ilqr_tpu/ops/pallas_iter.py:281",
}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int) -> float:
    """Median over ``reps`` calls of fn's device time (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_errs(got, want):
    """(max |a − b|, max |a − b| / (1 + |b|)) over a tuple of outputs, with
    NaNs required in the same places."""
    abs_e = rel_e = 0.0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            return float("inf"), float("inf")
        ok = ~torch.isnan(w)
        d = (g[ok] - w[ok]).abs()
        if d.numel():
            abs_e = max(abs_e, d.max().item())
            rel_e = max(rel_e, (d / (1.0 + w[ok].abs())).max().item())
    return abs_e, rel_e


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gauge(c1, c2):
    rel = np.abs(c1 - c2) / (1.0 + np.abs(c2))
    return float(np.percentile(rel, 99)), float(rel.max())


# ---------------------------------------------------------------------------

def compare_kernels(dev, model, pp, cfg):
    """Phase 3: every kernel against its plain version at the main path's
    shapes, on realistic inputs: the flagship x0, its open-loop rollout and
    the first iteration's gains; masks mixed over the lanes."""
    B, A = B_MAIN, len(cfg.alphas)
    rng = np.random.default_rng(0)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    x0 = f(0.05 * rng.normal(size=(B, N))).t().contiguous()
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    alphas = f(cfg.alphas)
    lam = torch.ones(B, device=dev)
    live = f(rng.uniform(size=B) > 0.5)
    gate = f(rng.uniform(size=B) > 0.5)
    keep = f(rng.uniform(size=B) > 0.5)
    xs0, us0, xT0, c0 = kernel_rollout.rollout_plain(
        model, "euler", True, pp, x0, zeros(T, M, B), zeros(T, N, B),
        zeros(T, M, N, B))
    k1, K1, dv1, _d, _g = kernel_sweep.sweep_plain(model, "euler", pp, xs0,
                                                   xT0, us0, lam)
    xsr = xs0 + f(0.01 * rng.normal(size=(T, N, B)))
    Kr = f(0.05 * rng.normal(size=(T, M, N, B)))
    uff = us0 + f(0.5 * rng.normal(size=(T, M, B)))
    kold = f(rng.normal(size=(T, M, B)))
    Kold = f(rng.normal(size=(T, M, N, B)))

    cases = {
        "rollout_packed": (
            kernel_rollout.rollout_packed, kernel_rollout.rollout_plain,
            (model, "euler", True, pp, x0, uff, xsr, Kr)),
        "sweep_packed": (
            kernel_sweep.sweep_packed, kernel_sweep.sweep_plain,
            (model, "euler", pp, xs0, xT0, us0, lam)),
        "linesearch_packed": (
            kernel_rollout.linesearch_packed, kernel_rollout.linesearch_plain,
            (model, "euler", True, pp, x0, us0, xs0, xT0, K1, k1, Kold, kold,
             alphas, dv1, c0, gate, keep, cfg.z_min)),
        "iteration_packed": (
            kernel_iter.iteration_packed, kernel_iter.iteration_plain,
            (model, "euler", True, pp, x0, xs0, xT0, us0, kold, Kold, lam,
             c0, live, alphas, "jvp", True, cfg.z_min, cfg.tol_grad,
             cfg.lambda_grad_term)),
    }
    rows = {}
    for name, (op, plain, args) in cases.items():
        got = op(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        abs_e, rel_e = max_errs(got, want)
        bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
        ms = time_ms(lambda: op(*args), reps=5)
        plain_ms = time_ms(lambda: plain(*args), reps=2)
        # least bytes: every input read once, every output written once;
        # the previous gains are read only on lanes that drop the new ones
        total = nbytes(*[a for a in args if isinstance(a, torch.Tensor)],
                       *got)
        if name == "rollout_packed":
            ops = OPS_ROLLOUT_STEP * T * B
        elif name == "sweep_packed":
            ops = OPS_SWEEP_STEP * T * B
        else:
            # A candidates and the emitted rollout (+ the sweep)
            ops = (A + 1) * (OPS_ROLLOUT_STEP + 2) * T * B
            if name == "iteration_packed":
                ops += OPS_SWEEP_STEP * T * B
                kept = (got[10] < 0.5) & (live > 0.5)
            else:
                kept = keep > 0.5
            total -= nbytes(kold, Kold) * kept.float().mean().item()
        b_ms, b_by = bound_ms(total, ops)
        rows[name] = dict(
            name=name, route="cuda", source="ilqr_tpu_torch/csrc/kernels.cu",
            replaces=REPLACES[name], launches=None, max_abs_err=abs_e,
            max_err=rel_e, tol=KERNEL_TOL, bitwise_equal=bitwise, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            bound_bytes=total, bound_ops=ops, library_ms=None,
            library_note="no single PyTorch call computes this function")
        print(f"[kernel] {name}: max_abs_err {abs_e:.3e} max_err {rel_e:.3e} "
              f"(tol {KERNEL_TOL:g}) bitwise {bitwise} | kernel {ms:.3f} ms "
              f"plain {plain_ms:.1f} ms bound {b_ms:.4f} ms ({b_by}) "
              f"at B={B} T={T} A={A}")
        if not rel_e <= KERNEL_TOL:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{rel_e} > {KERNEL_TOL}")
    # this design's traffic per iteration_packed launch: xs and us read by
    # each of the three phases, the (T, 5, B) gain buffer written once and
    # read twice, the previous gains read, the new state written
    gain_buf = (M * (N + 1)) * T * B * 4
    design = (3 * nbytes(xs0, us0) + 3 * gain_buf + nbytes(kold, Kold)
              + nbytes(xs0, us0, kold, Kold))
    print(f"[kernel] iteration_packed in this design moves ~{design / 1e9:.3f}"
          f" GB per launch (~{design / PEAK_BYTES * 1e3:.3f} ms at the peak "
          f"rate); the least any design must move is ~"
          f"{2 * nbytes(xs0, us0, kold, Kold) / 1e9:.3f} GB")
    return rows


def run_main_path(dev, model, params, cfg):
    """Phase 4: the flagship workload, as bench.py drives it."""
    rng = np.random.default_rng(0)
    draw = lambda: (0.05 * rng.normal(size=(B_MAIN, N))).astype(np.float32)
    u0 = np.zeros((B_MAIN, T, M), np.float32)

    x0 = draw()
    pp = kernel_rollout.pack_params(params, DT, dev)
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    init_cost = kernel_rollout.rollout_packed(
        model, "euler", True, pp, torch.as_tensor(x0, device=dev).t()
        .contiguous(), zeros(T, M, B_MAIN), zeros(T, N, B_MAIN),
        zeros(T, M, N, B_MAIN))[3].mean().item()

    t0 = time.perf_counter()
    sol = solve_batch_fused(model, params, cfg, DT, x0, u0)
    torch.cuda.synchronize()
    print(f"[main] warm-up solve {time.perf_counter() - t0:.2f} s")

    runs = []
    for rep in range(3):
        x0 = draw()
        reset_launch_counts()
        fused._host_any.syncs = 0
        fused._iteration.calls = 0
        t0 = time.perf_counter()
        sol = solve_batch_fused(model, params, cfg, DT, x0, u0)
        host = {k: v.cpu() for k, v in sol._asdict().items()}  # full D2H
        wall = time.perf_counter() - t0
        runs.append(dict(wall=wall, counts=launch_counts(),
                         syncs=fused._host_any.syncs,
                         host_iters=fused._iteration.calls, sol=host))
        print(f"[main] solve {rep}: {wall:.3f} s, {B_MAIN / wall:.1f} "
              f"solves/s, launches {runs[-1]['counts']}")
    first, last = runs[0], runs[-1]
    sol = last["sol"]
    cost = sol["cost"].numpy()
    iters = sol["iterations"].numpy()
    if not np.all(np.isfinite(cost)):
        raise AssertionError("non-finite costs on the main path")
    c = first["counts"]
    if c["rollout_packed"] != 1:
        raise AssertionError(f"rollout_packed ran {c['rollout_packed']} "
                             "times in one solve (expected 1)")
    if c["iteration_packed"] < first["host_iters"]:
        raise AssertionError("iteration_packed ran fewer launches than "
                             "iterations")
    if c["sweep_packed"] or c["linesearch_packed"]:
        raise AssertionError(f"the merged path launched split kernels: {c}")
    mean_cost = float(cost.mean())
    if not mean_cost < 0.05 * init_cost:
        raise AssertionError(f"mean cost {mean_cost} did not fall well below "
                             f"the initial rollout's {init_cost}")
    walls = [r["wall"] for r in runs]
    hist = {int(k): int(v) for k, v in
            zip(*np.unique(sol["reason"].numpy(), return_counts=True))}
    out = dict(
        solves_per_s=B_MAIN / float(np.median(walls)),
        wall_s=walls, mean_cost=mean_cost, init_mean_cost=init_cost,
        mean_iters=float(iters.mean()), reason_hist=hist,
        launches=c, host_iterations=first["host_iters"],
        host_syncs=first["syncs"],
        syncs_per_iteration=first["syncs"] / max(1, first["host_iters"]),
        ms_per_iteration=float(np.median(walls)) * 1e3
        / max(1, first["host_iters"]))
    print(f"[main] B={B_MAIN} T={T} max_iter={MAX_ITER}: "
          f"{out['solves_per_s']:.1f} solves/s (median of {len(walls)}), "
          f"mean_cost {mean_cost:.4f} (initial rollout {init_cost:.1f}; "
          f"the TPU v5e's f32 kernels gave {MAIN_TPU_MEAN_COST} — a TPU "
          f"figure, not this card's), mean_iters {out['mean_iters']:.2f}, "
          f"reasons {hist}, host iterations {first['host_iters']}, host "
          f"syncs/iteration {out['syncs_per_iteration']:.3f}, "
          f"{out['ms_per_iteration']:.3f} ms/iteration")
    return out


@contextlib.contextmanager
def plain_ops():
    """Points the fused solver's four ops at their plain versions, so that
    the same solve runs on the card without a kernel. A comparison only:
    the package itself never runs a plain version on a CUDA tensor."""
    plain = {"rollout_packed": kernel_rollout.rollout_plain,
             "sweep_packed": kernel_sweep.sweep_plain,
             "linesearch_packed": kernel_rollout.linesearch_plain,
             "iteration_packed": kernel_iter.iteration_plain}
    saved = {name: getattr(fused, name) for name in plain}
    try:
        for name, fn in plain.items():
            setattr(fused, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(fused, name, fn)


def profile_main_path(model, params, cfg, wall_s):
    """Where one flagship solve's time goes: device time by kernel from
    torch.profiler (CUPTI), and the device's busy share of the unprofiled
    median wall time ``wall_s`` of phase 4."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(2)
    x0 = (0.05 * rng.normal(size=(B_MAIN, N))).astype(np.float32)
    u0 = np.zeros((T, M), np.float32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve_batch_fused(model, params, cfg, DT, x0, u0)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("[profile] the profiler recorded no device time: not measured")
        return None
    by_name = {}
    for e in kernels:
        name = next((k for k in ("iteration_kernel", "rollout_kernel",
                                 "sweep_kernel", "linesearch_kernel")
                     if k in e.name), "other (PyTorch ops, copies)")
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    out = dict(device_ms_by_kernel={k: v / 1e3 for k, v in by_name.items()},
               device_busy_ms=busy_ms, wall_ms=wall_s * 1e3,
               device_busy_share=busy_ms / (wall_s * 1e3),
               device_events=len(kernels))
    print(f"[profile] one solve: device busy {busy_ms:.1f} ms of the "
          f"{wall_s * 1e3:.1f} ms median wall (share "
          f"{out['device_busy_share']:.3f}); by kernel (ms) "
          + ", ".join(f"{k} {v / 1e3:.1f}" for k, v in by_name.items())
          + f"; {len(kernels)} device events")
    return out


def run_split_path(dev, model, params, cfg):
    """Phase 5: split vs merged, and the kernel path vs the plain path on
    the card, at B = 1024; then, for information only, how far rounding
    alone moves per-lane costs on this chaotic workload."""
    rng = np.random.default_rng(1)
    x0 = (0.05 * rng.normal(size=(B_SPLIT, N))).astype(np.float32)
    u0 = np.zeros((T, M), np.float32)
    c12 = cfg.replace(max_iter=ITER_SPLIT)
    merged = solve_batch_fused(model, params, c12, DT, x0, u0)
    reset_launch_counts()
    split = solve_batch_fused(model, params, c12.replace(iter_kernel="split"),
                              DT, x0, u0)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts["sweep_packed"] < 1 or counts["linesearch_packed"] < 1:
        raise AssertionError(f"split path skipped its kernels: {counts}")
    t0 = time.perf_counter()
    with plain_ops():
        plain = solve_batch_fused(model, params, c12, DT, x0, u0)
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    cm, cs = merged.cost.cpu().numpy(), split.cost.cpu().numpy()
    cp = plain.cost.cpu().numpy()
    res = {}
    for label, a, b in (("split_vs_merged", cs, cm),
                        ("kernel_vs_plain_on_card", cm, cp)):
        p99, mx = gauge(a, b)
        res[label] = dict(p99=p99, max=mx)
        print(f"[split] {label} at B={B_SPLIT} T={T} max_iter={ITER_SPLIT}: "
              f"per-lane |c1-c2|/(1+|c2|) p99 {p99:.3e} (≤ {GAUGE_P99:g}), "
              f"max {mx:.3e} (≤ {GAUGE_MAX:g})")
        if not (np.isfinite(a).all() and p99 <= GAUGE_P99 and mx <= GAUGE_MAX):
            raise AssertionError(f"{label} outside the gauge")
    print(f"[split] launches on the split path {counts}; the plain path on "
          f"the card took {plain_s:.1f} s")

    # Not asserted: the CPU's sin/cos round differently from the card's in
    # the last ulp, and an x0 moved by 1e-6 shows how far such a difference
    # alone can carry a lane by iteration 12 (experiments/equiv_tpu.py).
    t0 = time.perf_counter()
    cpu = solve_batch_fused(model, params, c12, DT, x0, u0, device="cpu")
    cpu_s = time.perf_counter() - t0
    nudged = solve_batch_fused(model, params, c12, DT, x0 + np.float32(1e-6),
                               u0)
    for label, a in (("cpu_plain_vs_card", cpu.cost.numpy()),
                     ("card_x0+1e-6_vs_card", nudged.cost.cpu().numpy())):
        p99, mx = gauge(a, cm)
        forked = float(np.mean(np.abs(a - cm) / (1.0 + np.abs(cm)) > 1e-3))
        res[label] = dict(p99=p99, max=mx, share_over_1e3=forked)
        print(f"[split] {label} (information, not asserted): p99 {p99:.3e}, "
              f"max {mx:.3e}, share of lanes over 1e-3 {forked:.4f}")
    print(f"[split] the plain path on the CPU took {cpu_s:.1f} s")
    return counts, res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = nvidia_smi()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    print(f"[env] {smi}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    model = get_model("acrobot")
    params = acrobot.default_params()
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       use_control_limits=True, max_iter=MAX_ITER)
    pp = kernel_rollout.pack_params(params, DT, dev)
    rows = compare_kernels(dev, model, pp, cfg)

    main_out = run_main_path(dev, model, params, cfg)
    for name in ("rollout_packed", "iteration_packed"):
        rows[name]["launches"] = main_out["launches"][name]
    main_out["profile"] = profile_main_path(model, params, cfg,
                                            float(np.median(main_out["wall_s"])))
    split_counts, gauges = run_split_path(dev, model, params, cfg)
    for name in ("sweep_packed", "linesearch_packed"):
        rows[name]["launches"] = split_counts[name]
    if not all(r["launches"] for r in rows.values()):
        raise AssertionError(f"a kernel was never launched: {rows}")

    print(json.dumps({"main_path": main_out, "split_path": gauges}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
