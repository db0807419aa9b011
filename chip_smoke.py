#!/usr/bin/env python3
"""Drives ilqr_tpu_torch's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: the CUDA kernels from ilqr_tpu_torch/csrc with nvcc, one
     process per source, all started together (each source's seconds and
     each kernel's registers, stack and spills printed);
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes (B = 8192, T = 499, A = 11; the derivative kernel in both
     its modes), with times (CUDA events) and bounds;
  4. the fused path: acrobot swing-up through solve_batch_fused at
     B = 8192, T = 499, max_iter = 100 — solves/s, cost, iterations, launch
     counts; then one more solve under torch.profiler for the device time
     by kernel and the device's busy share;
  5. the fused split route (sweep + line-search kernels) against the merged
     one, and the kernel path against the plain path on the card, at
     B = 1024, max_iter = 4; beside them, not asserted, the plain path on
     the CPU and the kernel path from an x0 moved by 1e-6, which show how
     far rounding alone carries a lane on this chaotic workload;
  6. the composable path: solve_batch at the same size on the same x0
     (derivative, backward and rollout kernels; the line search as one
     rollout over B·A lanes) beside solve_batch_fused — solves/s, cost,
     iterations, launches, λ retries — and one profiled solve;
  7. equivalence at B = 1024, T = T_EQ, 12 iterations: the composable
     path and the fused split sweep each against the fused merged route
     (the gauge below), with the share of lanes a 1e-6 nudge of x0 forks;
  8. the m = 2…4 slice (experiments/secondary_bench.py's workloads): each
     model's four kernels against their plain versions at its path's
     shapes (the quadrotor at B = 1024, T = 80, A = 11; the double
     integrator and the 3-D point mass at B = 1024, T = 99); the quadrotor
     path at full width (B = 1024, T = 80, max_iter = 40: solves/s, cost,
     iterations, reasons, launches, a profiled solve, and unasserted at
     B = 8192) and its merged route against its split one under the gauge;
     the double integrator (with and without limits) and 3-D point mass
     paths, and their split routes against the merged ones; the double
     integrator's reference solve against golden/integrator_golden.csv, and
     short solves of the point mass and the quadrotor against the plain
     path on the CPU;
  9. the m ≥ 5 slice (projected Newton in the sweep): the four kernels of
     omni_thruster, free_flyer and thruster_ring against their plain
     versions at B = 1024, T = 80, A = 11 (and omni_thruster's sweep and
     iteration without limits), those of thruster_ring16/20/24 with the
     sweep and iteration at T = 4; the thruster_ring path at full width
     (B = 1024, T = 80, max_iter = 40: solves/s, cost, iterations,
     reasons, the share of controls on the lower bound, launches, a
     profiled solve, and unasserted at B = 8192) and its merged route; the
     omni_thruster (with and without limits) and free_flyer paths and their
     merged routes under the gauge; thruster_ring24 at the cap (one solve,
     max_iter cut if it would take over a minute) and thruster_ring16/20
     at a cut depth; short omni_thruster and thruster_ring solves against
     the plain path on the CPU;
 10. the last four models (pendulum, cartpole, bicycle, power_mass — the
     live cxu, cxx off-diagonals and full cuu of the sweep's general
     terms): their four kernels, and the whole iteration without limits,
     against their plain versions at their paths' shapes; each model's
     path at full width (the CLI's canonical problem at --batch 1024,
     uncut: solves/s, ms per iteration, cost against the initial
     rollout's, iterations, reasons, launches, a profiled solve), its
     split route against the merged one under the gauge, its path without
     limits, and a short solve against the plain path on the CPU;
 11. one JSON line listing every kernel × model instantiation launched, the
     card's line, and the last line {"ok": true, "device": {...}}. Each
     phase prints its seconds.

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

from ilqr_tpu_torch import (
    SolverConfig,
    fused,
    get_model,
    solve_batch,
    solve_batch_fused,
    solver,
)
from ilqr_tpu_torch.models import acrobot, omni_thruster, quadrotor
from ilqr_tpu_torch.ops import (
    _build,
    kernel_backward,
    kernel_derivs,
    kernel_iter,
    kernel_rollout,
    kernel_sweep,
    launch_counts,
    reset_launch_counts,
)

B_MAIN, T, DT, MAX_ITER = 8192, 499, 0.02, 100
# Phase 5 at a cut depth: its plain path takes ~7 s per iteration at
# T = 499 on an H100 80GB HBM3 (700 W).
B_SPLIT, ITER_SPLIT = 1024, 4
# Equivalence of whole solves across routes: a horizon short enough that
# rounding alone (a 1e-6 nudge of x0) forks under 1% of lanes by iteration
# 12; phase 7 prints that share.
T_EQ, ITER_EQ = 50, 12
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
    "derivs_packed": "ilqr_tpu/ops/pallas_derivs.py:173",
    "backward_sweep_packed": "ilqr_tpu/ops/pallas_backward.py:185",
}
SOURCES = {
    "derivs_packed": "ilqr_tpu_torch/csrc/derivs.cu",
    "backward_sweep_packed": "ilqr_tpu_torch/csrc/backward.cu",
}
KERNEL_NAMES = ("iteration_kernel", "rollout_kernel", "sweep_kernel",
                "linesearch_kernel", "derivs_kernel", "backward_kernel")


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


_ARITH = {"add", "sub", "mul", "div", "neg", "rsub", "sin", "cos", "tan",
          "reciprocal", "where", "maximum", "minimum", "clamp", "abs"}


def count_ops(fn) -> int:
    """f32 operations ``fn()`` performs, counted result element by result
    element at PyTorch's dispatcher (each sin/cos/tan as one)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if (name in _ARITH and isinstance(out, torch.Tensor)
                    and out.dtype == torch.float32):
                Count.n += out.numel()
            return out

    with Count():
        fn()
    return Count.n


def ops_per_step(plain_at):
    """(per (t, lane), per lane once) operation counts of a plain version
    that ``plain_at(T)`` runs on one CPU lane with horizon T: the
    difference of T = 2 and T = 1, and what T = 1 does besides."""
    one, two = count_ops(lambda: plain_at(1)), count_ops(lambda: plain_at(2))
    return two - one, 2 * one - two


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
        unread = None
        if name == "rollout_packed":
            ops = OPS_ROLLOUT_STEP * T * B
        elif name == "sweep_packed":
            ops = OPS_SWEEP_STEP * T * B
        else:
            # A candidates and the emitted rollout (+ the sweep); the
            # previous gains are read only on lanes that drop the new ones
            ops = (A + 1) * (OPS_ROLLOUT_STEP + 2) * T * B
            if name == "iteration_packed":
                ops += OPS_SWEEP_STEP * T * B
                kept = lambda got: (got[10] < 0.5) & (live > 0.5)
            else:
                kept = lambda got: keep > 0.5
            unread = lambda got, kept=kept: (
                nbytes(kold, Kold) * kept(got).float().mean().item())
        rows[name] = compare_stage(name, op, plain, args, ops,
                                   f"at B={B} T={T} A={A}", unread)
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
    rows.update(compare_stage_kernels(dev, model, pp, xs0, xT0, us0))
    return {name: dict(
        name=name, route="cuda",
        source=SOURCES.get(name, "ilqr_tpu_torch/csrc/kernels.cu"),
        replaces=REPLACES[name], launches=None, tol=KERNEL_TOL,
        library_ms=None,
        library_note="no single PyTorch call computes this function", **r)
        for name, r in rows.items()}


def compare_stage(label, op, plain, args, ops, where, unread=None,
                  plain_reps=2):
    """One kernel against its plain version on the same inputs: errors,
    times, and the bound — every input read once and every output written
    once, less ``unread(outputs)`` bytes the function need not read. With
    ``plain_reps=0`` the plain version's time is that of the comparison
    call itself (CUDA events), for plain versions that take seconds."""
    got = op(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain(*args)
    end.record()
    end.synchronize()
    abs_e, rel_e = max_errs(got, want)
    # bit for bit, NaNs in the same places counting as equal
    bitwise = all(bool(((g == w) | (torch.isnan(g) & torch.isnan(w))).all())
                  for g, w in zip(got, want))
    ms = time_ms(lambda: op(*args), reps=5)
    plain_ms = (time_ms(lambda: plain(*args), reps=plain_reps) if plain_reps
                else start.elapsed_time(end))
    total = nbytes(*[a for a in args if isinstance(a, torch.Tensor)], *got)
    if unread is not None:
        total -= unread(got)
    b_ms, b_by = bound_ms(total, ops)
    print(f"[kernel] {label}: max_abs_err {abs_e:.3e} max_err {rel_e:.3e} "
          f"(tol {KERNEL_TOL:g}) bitwise {bitwise} | kernel {ms:.3f} ms "
          f"plain {plain_ms:.1f} ms bound {b_ms:.4f} ms ({b_by}; {total:.0f} "
          f"B, {ops} ops) {where}")
    if not rel_e <= KERNEL_TOL:
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{rel_e} > {KERNEL_TOL}")
    return dict(max_abs_err=abs_e, max_err=rel_e, bitwise_equal=bitwise,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bound_bytes=total, bound_ops=ops)


def compare_stage_kernels(dev, model, pp, xs0, xT0, us0):
    """Phase 3, the composable path's kernels: derivs_packed in both modes
    and backward_sweep_packed, at the main path's shapes, on the flagship's
    open-loop trajectory and its derivatives; operations counted from the
    plain versions (the same arithmetic as the kernels)."""
    B = us0.shape[-1]
    xs_full = torch.cat([xs0, xT0[None]]).contiguous()
    pp_cpu = kernel_rollout.pack_params(acrobot.default_params(), DT)
    rng = np.random.default_rng(3)

    def lane_inputs(t):
        xs = torch.as_tensor(0.3 * rng.normal(size=(t + 1, N, 1)),
                             dtype=torch.float32)
        us = torch.as_tensor(2.0 * rng.normal(size=(t, M, 1)),
                             dtype=torch.float32)
        return xs, us

    rows = {}
    for mode in ("jvp", "fd"):
        step, rest = ops_per_step(lambda t: kernel_derivs.derivs_plain(
            model, "euler", pp_cpu, *lane_inputs(t), mode=mode))
        r = compare_stage(
            f"derivs_packed ({mode})", kernel_derivs.derivs_packed,
            kernel_derivs.derivs_plain,
            (model, "euler", pp, xs_full, us0, mode), step * T * B + rest * B,
            f"({step} per (t, lane)) at B={B} T={T}")
        if mode == "jvp":   # the main path's mode (deriv_mode="analytic")
            rows["derivs_packed"] = r
            derivs = kernel_derivs.derivs_packed(model, "euler", pp,
                                                 xs_full, us0)
        else:
            rows["derivs_packed"].update(
                {f"fd_{k}": v for k, v in r.items()})

    fx, fu, cx, cu, cxx, cxu, cuu = derivs
    p, _dt = kernel_rollout.unpack_params(pp)
    args = (fx, fu[:, :, 0], cx[:-1], cu[:, 0], cxx[:-1], cxu[:, :, 0],
            cuu[:, 0, 0], p.u_min[0] - us0[:, 0], p.u_max[0] - us0[:, 0],
            torch.ones(B, device=dev), cx[-1], cxx[-1])

    def backward_at(t):
        xs, us = lane_inputs(t)
        d = kernel_derivs.derivs_plain(model, "euler", pp_cpu, xs, us)
        return kernel_backward.backward_plain(
            d[0], d[1][:, :, 0], d[2][:-1], d[3][:, 0], d[4][:-1],
            d[5][:, :, 0], d[6][:, 0, 0], -5.0 - us[:, 0], 5.0 - us[:, 0],
            torch.ones(1), d[2][-1], d[4][-1])

    # the backward recursion's own operations: its count minus the
    # derivative op that builds its inputs above
    step_all, rest_all = ops_per_step(backward_at)
    step_d, rest_d = ops_per_step(lambda t: kernel_derivs.derivs_plain(
        model, "euler", pp_cpu, *lane_inputs(t)))
    step, rest = step_all - step_d, rest_all - rest_d
    rows["backward_sweep_packed"] = compare_stage(
        "backward_sweep_packed", kernel_backward.backward_sweep_packed,
        kernel_backward.backward_plain, args, step * T * B + rest * B,
        f"({step} per (t, lane)) at B={B} T={T}")
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
        fused._iteration.retried = 0
        t0 = time.perf_counter()
        sol = solve_batch_fused(model, params, cfg, DT, x0, u0)
        host = {k: v.cpu() for k, v in sol._asdict().items()}  # full D2H
        wall = time.perf_counter() - t0
        runs.append(dict(wall=wall, counts=launch_counts(),
                         syncs=fused._host_any.syncs,
                         host_iters=fused._iteration.calls,
                         retried=fused._iteration.retried, sol=host))
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
        retried_share=first["retried"] / max(1, first["host_iters"]),
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


def profile_solve(label, solve_fn, wall_s, x0=None, u0=None):
    """Where one solve's time goes: device time by kernel from
    torch.profiler (CUPTI), and the device's busy share of the unprofiled
    median wall time ``wall_s``. ``solve_fn(x0, u0)`` runs it; x0 and u0
    default to a flagship-size acrobot draw."""
    from torch.profiler import ProfilerActivity, profile

    if x0 is None:
        rng = np.random.default_rng(2)
        x0 = (0.05 * rng.normal(size=(B_MAIN, N))).astype(np.float32)
        u0 = np.zeros((T, M), np.float32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve_fn(x0, u0)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"[profile] {label}: the profiler recorded no device time: "
              "not measured")
        return None
    by_name = {}
    for e in kernels:
        name = next((k for k in KERNEL_NAMES if k in e.name),
                    "other (PyTorch ops, copies)")
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    out = dict(device_ms_by_kernel={k: v / 1e3 for k, v in by_name.items()},
               device_busy_ms=busy_ms, wall_ms=wall_s * 1e3,
               device_busy_share=busy_ms / (wall_s * 1e3),
               device_events=len(kernels))
    print(f"[profile] {label}, one solve: device busy {busy_ms:.1f} ms of the "
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
    c4 = cfg.replace(max_iter=ITER_SPLIT)
    merged = solve_batch_fused(model, params, c4, DT, x0, u0)
    reset_launch_counts()
    split = solve_batch_fused(model, params, c4.replace(iter_kernel="split"),
                              DT, x0, u0)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts["sweep_packed"] < 1 or counts["linesearch_packed"] < 1:
        raise AssertionError(f"split path skipped its kernels: {counts}")
    t0 = time.perf_counter()
    with plain_ops():
        plain = solve_batch_fused(model, params, c4, DT, x0, u0)
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
    # alone can carry a lane by iteration 4 (experiments/equiv_tpu.py).
    t0 = time.perf_counter()
    cpu = solve_batch_fused(model, params, c4, DT, x0, u0, device="cpu")
    cpu_s = time.perf_counter() - t0
    nudged = solve_batch_fused(model, params, c4, DT, x0 + np.float32(1e-6),
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


def run_composable_path(dev, model, params, cfg, fused_out):
    """Phase 6: solve_batch at the flagship size on the x0 draws of phase 4
    (so each timed solve faces the same problems as the fused one there),
    then one profiled solve."""
    rng = np.random.default_rng(0)
    draw = lambda: (0.05 * rng.normal(size=(B_MAIN, N))).astype(np.float32)
    u0 = np.zeros((B_MAIN, T, M), np.float32)
    t0 = time.perf_counter()
    solve_batch(model, params, cfg, DT, draw(), u0)
    torch.cuda.synchronize()
    print(f"[composable] warm-up solve {time.perf_counter() - t0:.2f} s")
    runs = []
    for rep in range(3):
        x0 = draw()
        reset_launch_counts()
        solver._host_any.syncs = 0
        solver.ilqr_iteration.calls = 0
        solver.ilqr_iteration.retried = 0
        t0 = time.perf_counter()
        sol = solve_batch(model, params, cfg, DT, x0, u0)
        host = {k: v.cpu() for k, v in sol._asdict().items()}  # full D2H
        wall = time.perf_counter() - t0
        runs.append(dict(wall=wall, counts=launch_counts(),
                         syncs=solver._host_any.syncs,
                         host_iters=solver.ilqr_iteration.calls,
                         retried=solver.ilqr_iteration.retried, sol=host))
        print(f"[composable] solve {rep}: {wall:.3f} s, {B_MAIN / wall:.1f} "
              f"solves/s, launches {runs[-1]['counts']}")
    first, sol = runs[0], runs[-1]["sol"]
    cost = sol["cost"].numpy()
    c = first["counts"]
    if not np.all(np.isfinite(cost)):
        raise AssertionError("non-finite costs on the composable path")
    for name in ("rollout_packed", "derivs_packed", "backward_sweep_packed"):
        if c[name] < 1:
            raise AssertionError(f"the composable path never launched {name}")
    if c["iteration_packed"] or c["sweep_packed"] or c["linesearch_packed"]:
        raise AssertionError(f"the composable path launched fused kernels: "
                             f"{c}")
    mean_cost = float(cost.mean())
    init = fused_out["init_mean_cost"]
    if not mean_cost < 0.05 * init:
        raise AssertionError(f"composable mean cost {mean_cost} did not fall "
                             f"well below the initial rollout's {init}")
    rel = abs(mean_cost - fused_out["mean_cost"]) / fused_out["mean_cost"]
    if not rel <= 0.01:
        raise AssertionError(f"composable mean cost {mean_cost} is not within "
                             f"1% of the fused path's {fused_out['mean_cost']}")
    walls = [r["wall"] for r in runs]
    iters = first["host_iters"]
    hist = {int(k): int(v) for k, v in
            zip(*np.unique(sol["reason"].numpy(), return_counts=True))}
    out = dict(
        solves_per_s=B_MAIN / float(np.median(walls)), wall_s=walls,
        mean_cost=mean_cost, mean_iters=float(sol["iterations"].float()
                                              .mean()),
        reason_hist=hist, launches=c, host_iterations=iters,
        host_syncs=first["syncs"], syncs_per_iteration=first["syncs"] / iters,
        backward_launches_per_iteration=c["backward_sweep_packed"] / iters,
        retried_share=first["retried"] / iters,
        ms_per_iteration=float(np.median(walls)) * 1e3 / iters,
        mean_cost_rel_diff_to_fused=rel)
    f = fused_out
    print(f"[composable] B={B_MAIN} T={T} max_iter={MAX_ITER}: "
          f"{out['solves_per_s']:.1f} solves/s against the fused path's "
          f"{f['solves_per_s']:.1f} on the same x0 ({nvidia_smi()}); "
          f"{out['ms_per_iteration']:.3f} vs {f['ms_per_iteration']:.3f} "
          f"ms/iteration; mean_cost {mean_cost:.4f} vs {f['mean_cost']:.4f} "
          f"(rel. diff {rel:.2e}, ≤ 1e-2); mean_iters {out['mean_iters']:.2f}"
          f" vs {f['mean_iters']:.2f}; reasons {hist} vs {f['reason_hist']};"
          f" backward launches/iteration {out['backward_launches_per_iteration']:.3f},"
          f" iterations that retried {out['retried_share']:.3f} (fused merged"
          f" {f['retried_share']:.3f}); host syncs/iteration "
          f"{out['syncs_per_iteration']:.3f}")
    # the fused split sweep on the last x0: the same derivative and backward
    # kernels, the line search as one kernel (one call, not a median)
    reset_launch_counts()
    fused._iteration.calls = fused._iteration.retried = 0
    t0 = time.perf_counter()
    ssol = solve_batch_fused(model, params, cfg.replace(sweep_kernel="split"),
                             DT, x0, u0)
    scost = ssol.cost.cpu().numpy()
    swall = time.perf_counter() - t0
    sc, its = launch_counts(), max(1, fused._iteration.calls)
    out["split_sweep"] = dict(
        solves_per_s=B_MAIN / swall, wall_s=swall,
        mean_cost=float(scost.mean()),
        mean_iters=float(ssol.iterations.float().mean().item()),
        launches=sc, backward_launches_per_iteration=(
            sc["backward_sweep_packed"] / its),
        retried_share=fused._iteration.retried / its,
        ms_per_iteration=swall * 1e3 / its)
    ss = out["split_sweep"]
    print(f"[composable] the fused split sweep on the last x0 (one call): "
          f"{ss['solves_per_s']:.1f} solves/s, {ss['ms_per_iteration']:.3f} "
          f"ms/iteration, mean_cost {ss['mean_cost']:.4f}, mean_iters "
          f"{ss['mean_iters']:.2f}, backward launches/iteration "
          f"{ss['backward_launches_per_iteration']:.3f}, iterations that "
          f"retried {ss['retried_share']:.3f}, launches {sc}")
    if not np.all(np.isfinite(scost)):
        raise AssertionError("non-finite costs on the fused split sweep")
    out["rollout_ba"] = time_rollout_ba(dev, model, params, len(cfg.alphas))
    out["profile"] = profile_solve(
        "composable", lambda x0, u0: solve_batch(model, params, cfg, DT, x0,
                                                 u0),
        float(np.median(walls)))
    return out


def time_rollout_ba(dev, model, params, A):
    """rollout_packed as the composable line search launches it: one
    closed-loop rollout over B·A lanes (the α candidates folded into the
    lanes), timed against its bound."""
    rng = np.random.default_rng(5)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    L = B_MAIN * A
    pp = kernel_rollout.pack_params(params, DT, dev)
    x0 = f(0.05 * rng.normal(size=(N, L)))
    uff = f(0.5 * rng.normal(size=(T, M, L)))
    K = f(0.05 * rng.normal(size=(T, M, N, L)))
    xsr = kernel_rollout.rollout_packed(model, "euler", True, pp, x0, uff,
                                        torch.zeros_like(uff).expand(
                                            T, N, L).contiguous(),
                                        torch.zeros_like(K))[0]
    args = (model, "euler", True, pp, x0, uff, xsr, K)
    ms = time_ms(lambda: kernel_rollout.rollout_packed(*args), reps=5)
    got = kernel_rollout.rollout_packed(*args)
    total = nbytes(x0, uff, xsr, K, *got)
    b_ms, b_by = bound_ms(total, OPS_ROLLOUT_STEP * T * L)
    print(f"[composable] rollout_packed at B·A = {L} lanes: {ms:.3f} ms per "
          f"launch, bound {b_ms:.4f} ms ({b_by}; {total} B), "
          f"{total / (ms * 1e-3) / 1e12:.2f} TB/s")
    return dict(lanes=L, ms=ms, bound_ms=b_ms, bound_by=b_by,
                bound_bytes=total)


def run_equivalence(dev, model, params, cfg):
    """Phase 7: at B = 1024, T = T_EQ, 12 iterations, the composable path
    and the fused split sweep each against the fused merged route under the
    gauge, and the share of lanes a 1e-6 nudge of x0 forks (printed)."""
    rng = np.random.default_rng(4)
    x0 = (0.05 * rng.normal(size=(B_SPLIT, N))).astype(np.float32)
    u0 = np.zeros((T_EQ, M), np.float32)
    c12 = cfg.replace(max_iter=ITER_EQ)
    merged = solve_batch_fused(model, params, c12, DT, x0, u0)
    reset_launch_counts()
    fused._iteration.calls = fused._iteration.retried = 0
    split = solve_batch_fused(model, params,
                              c12.replace(sweep_kernel="split"), DT, x0, u0)
    torch.cuda.synchronize()
    counts = launch_counts()
    if (counts["derivs_packed"] < 1 or counts["backward_sweep_packed"] < 1
            or counts["linesearch_packed"] < 1
            or counts["iteration_packed"] or counts["sweep_packed"]):
        raise AssertionError(f"the split sweep ran other kernels: {counts}")
    split_retried = fused._iteration.retried / max(1, fused._iteration.calls)
    comp = solve_batch(model, params, c12, DT, x0, u0)
    nudged = solve_batch_fused(model, params, c12, DT, x0 + np.float32(1e-6),
                               u0)
    cm = merged.cost.cpu().numpy()
    res = dict(split_sweep_launches=counts, split_retried_share=split_retried)
    for label, a, asserted in (
            ("composable_vs_merged", comp.cost.cpu().numpy(), True),
            ("split_sweep_vs_merged", split.cost.cpu().numpy(), True),
            ("card_x0+1e-6_vs_merged", nudged.cost.cpu().numpy(), False)):
        p99, mx = gauge(a, cm)
        share = float(np.mean(np.abs(a - cm) / (1.0 + np.abs(cm)) > 1e-3))
        res[label] = dict(p99=p99, max=mx, share_over_1e3=share)
        print(f"[equiv] {label} at B={B_SPLIT} T={T_EQ} max_iter="
              f"{ITER_EQ}: p99 {p99:.3e} (≤ {GAUGE_P99:g}), max {mx:.3e} "
              f"(≤ {GAUGE_MAX:g}), share of lanes over 1e-3 {share:.4f}"
              + ("" if asserted else " (information, not asserted)"))
        if asserted and not (np.isfinite(a).all() and p99 <= GAUGE_P99
                             and mx <= GAUGE_MAX):
            raise AssertionError(f"{label} outside the gauge")
    print(f"[equiv] split sweep launches {counts}; iterations that retried "
          f"{split_retried:.3f}")
    return res

# ---------------------------------------------------------------------------
# The m = 2…4 slice: experiments/secondary_bench.py's workloads, the
# quadrotor at :88-116 (full width, uncut), the double integrator and the
# 3-D point mass at :55-70.

B_M = 1024
B_WIDE = 8192          # the quadrotor path again: printed, not asserted
QUAD_T, QUAD_ITERS = 80, 40
M23_T, M23_ITERS = 99, 100
SLICE_MODELS = ("double_integrator", "point_mass_3d", "quadrotor")
# The reference binary's integrator solve from x0 = (-1, 0, 0, -0.2): its
# converged cost (its log) and trajectory (golden/integrator_golden.csv),
# as tests/test_solver.py:30-46 holds the JAX package to them.
GOLDEN_CSV = "golden/integrator_golden.csv"
GOLDEN_COST, GOLDEN_COST_TOL, GOLDEN_US_TOL = 356.1685, 1e-2, 1e-3
# Short solves on the card against the plain path on the CPU: the models
# without trig agree to the bit; 1e-3 covers the sin/cos/tan ulps of the
# others.
CPU_RTOL = {"point_mass_3d": 1e-4, "quadrotor": 1e-3,
            "omni_thruster": 1e-3, "thruster_ring": 1e-3,
            "pendulum": 1e-3, "cartpole": 1e-3, "bicycle": 1e-3,
            "power_mass": 1e-4}

# The m ≥ 5 slice: experiments/secondary_bench.py's m12_fused (:176-232,
# thruster_ring: the full-width path, uncut), m6_fused (:146-175,
# omni_thruster) and m8_fused (:117-145, free_flyer), and the wider rings,
# thruster_ring24 at the fused solver's m = 24 cap.
WIDE_MODELS = ("omni_thruster", "free_flyer", "thruster_ring",
               "thruster_ring16", "thruster_ring20", "thruster_ring24")
WIDE_T, WIDE_ITERS, WIDE_DT = 80, 40, 0.05
# thruster_ring16/20/24: the sweep and iteration kernels against their
# plain versions at T = 4 (the plain sweep at m = 24 runs ~10⁵ PyTorch ops
# per step on the card)
WIDE_T_BACKWARD = 4
CAP_SOLVE_S = 60.0    # thruster_ring24: max_iter is cut if a solve would
#                       take longer
SHORT_ITERS = 2       # thruster_ring16/20's solves (and ring24's merged
#                       route): a cut depth that launches every kernel
LOWER_SHARE = 0.3     # controls on the lower bound where limits apply
#                       (tests/test_fused_solver.py:423,991)

# The last four models: the CLI's canonical problems (ilqr_tpu/__main__.py
# :101-111; T, dt) at --batch 1024, uncut, with the flags of the JAX
# package's fused tests (--deriv-mode analytic --clamp-forward): x0 = the
# spec's x0 (zeros) + 0.05·normal from default_rng(0) (:198-202), u0 = 0,
# max_iter = 100. power_mass is the headline: its running cost's live cxu,
# cxx off-diagonals and full cuu run the sweep's general terms.
CLI_MODELS = {"pendulum": (199, 0.02), "cartpole": (299, 0.02),
              "bicycle": (100, 0.05), "power_mass": (120, 0.05)}
CLI_ITERS = 100
CLI_CPU_T, CLI_CPU_ITERS = 30, 5   # the short card-against-CPU solves


def workload(name, B=B_M):
    """(model, params, cfg, T, dt, u0 (T, m), draw(rng) -> x0 (B, n)) of
    the path for ``name``, as secondary_bench.py draws it."""
    model = get_model(name)
    params = model.default_params()
    dt = DT
    if name in WIDE_MODELS:      # m6_fused, m8_fused, m12_fused
        T, iters, dt = WIDE_T, WIDE_ITERS, WIDE_DT
        scale = 0.3 if name == "free_flyer" else 0.2
        u0 = (np.tile(omni_thruster.hover_control(params).numpy()[None],
                      (T, 1)) if name == "omni_thruster"
              else np.zeros((T, model.m)))
        draw = lambda rng: scale * rng.normal(size=(B, 6))
    elif name == "quadrotor":
        T, iters = QUAD_T, QUAD_ITERS
        u0 = np.tile(quadrotor.hover_control(params).numpy()[None], (T, 1))
        draw = lambda rng: 0.05 * rng.normal(size=(B, 12))
    elif name == "double_integrator":
        T, iters = M23_T, M23_ITERS
        u0 = np.zeros((T, 2))
        draw = lambda rng: (np.asarray([-1.0, 0.0, 0.0, -0.2])
                            + 0.1 * rng.normal(size=(B, 4)))
    elif name in CLI_MODELS:
        (T, dt), iters = CLI_MODELS[name], CLI_ITERS
        u0 = np.zeros((T, model.m))
        draw = lambda rng: 0.05 * rng.normal(size=(B, model.n))
    else:
        T, iters = M23_T, M23_ITERS
        u0 = np.zeros((T, 3))
        draw = lambda rng: 0.3 * rng.normal(size=(B, 6))
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       use_control_limits=True, max_iter=iters)
    return (model, params, cfg, T, dt, u0.astype(np.float32),
            lambda rng: draw(rng).astype(np.float32))


def lane_ops(model, params, kind, use_limits=True, A=11, dt=DT):
    """f32 operations per (t, lane) and per lane of a kernel, counted from
    its plain version (the same arithmetic) on one CPU lane."""
    rng = np.random.default_rng(6)
    pp = kernel_rollout.pack_params(params, dt)
    n, m = model.n, model.m
    f = lambda *s: torch.as_tensor(0.1 * rng.normal(size=s),
                                   dtype=torch.float32)
    al = torch.linspace(1.0, 0.001, A)
    one = torch.ones(1)

    def at(t):
        x0, xs, xT, us = f(n, 1), f(t, n, 1), f(n, 1), 1.0 + f(t, m, 1)
        K, k = f(t, m, n, 1), f(t, m, 1)
        if kind == "rollout":
            return kernel_rollout.rollout_plain(model, "euler", True, pp, x0,
                                                us, xs, K)
        if kind == "sweep":
            return kernel_sweep.sweep_plain(model, "euler", pp, xs, xT, us,
                                            one, "jvp", use_limits)
        if kind == "linesearch":
            return kernel_rollout.linesearch_plain(
                model, "euler", True, pp, x0, us, xs, xT, K, k, K, k, al,
                torch.stack([-one, one]), one, one, one, 0.0)
        return kernel_iter.iteration_plain(
            model, "euler", True, pp, x0, xs, xT, us, k, K, one, one, one,
            al, "jvp", use_limits)
    return ops_per_step(at)


def compare_model_kernels(dev, name, t_backward=None):
    """Phases 8a and 9a: the model's four kernels (and, for the double
    integrator and omni_thruster, the whole iteration without limits, which
    their unconstrained paths run) against their plain versions on the card
    at its path's shapes, on its path's x0, open-loop rollout and first
    gains; masks mixed. ``t_backward`` cuts the horizon of the sweep and
    iteration cases (their plain versions at m = 16…24 take minutes at the
    path's T)."""
    model, params, cfg, T, dt, u0, draw = workload(name)
    B, A, n, m = B_M, len(cfg.alphas), model.n, model.m
    rng = np.random.default_rng(0)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pp = kernel_rollout.pack_params(params, dt, dev)
    x0 = f(draw(rng)).t().contiguous()
    us_in = f(u0)[:, :, None].expand(T, m, B).contiguous()
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    xs0, us0, xT0, c0 = kernel_rollout.rollout_plain(
        model, "euler", True, pp, x0, us_in, zeros(T, n, B),
        zeros(T, m, n, B))
    lam = torch.ones(B, device=dev)
    # the first iteration's gains, as the line search receives them (from
    # the kernel: its plain version takes seconds here)
    k1, K1, dv1, _d, _g = kernel_sweep.sweep_packed(model, "euler", pp, xs0,
                                                    xT0, us0, lam)
    live, gate, keep = (f(rng.uniform(size=B) > 0.5) for _ in range(3))
    alphas = f(cfg.alphas)
    xsr = xs0 + f(0.01 * rng.normal(size=(T, n, B)))
    Kr = f(0.05 * rng.normal(size=(T, m, n, B)))
    uff = us0 + f(0.2 * rng.normal(size=(T, m, B)))
    kold, Kold = f(rng.normal(size=(T, m, B))), f(rng.normal(size=(T, m, n,
                                                                   B)))
    old_bytes = nbytes(kold, Kold)
    Tb = T if t_backward is None else t_backward
    # the sweep and iteration cases on the first Tb steps of the same
    # trajectory (x_Tb its terminal state)
    xsb, usb = xs0[:Tb].contiguous(), us0[:Tb].contiguous()
    xTb = xT0 if Tb == T else xs0[Tb].contiguous()
    koldb, Koldb = kold[:Tb].contiguous(), Kold[:Tb].contiguous()
    old_b = nbytes(koldb, Koldb)
    cases = {
        "rollout_packed": (kernel_rollout.rollout_packed,
                           kernel_rollout.rollout_plain,
                           (model, "euler", True, pp, x0, uff, xsr, Kr),
                           "rollout", True, None),
        "sweep_packed": (kernel_sweep.sweep_packed, kernel_sweep.sweep_plain,
                         (model, "euler", pp, xsb, xTb, usb, lam), "sweep",
                         True, None),
        "linesearch_packed": (
            kernel_rollout.linesearch_packed, kernel_rollout.linesearch_plain,
            (model, "euler", True, pp, x0, us0, xs0, xT0, K1, k1, Kold, kold,
             alphas, dv1, c0, gate, keep, cfg.z_min), "linesearch", True,
            lambda got: old_bytes * (keep > 0.5).float().mean().item()),
        "iteration_packed": (
            kernel_iter.iteration_packed, kernel_iter.iteration_plain,
            (model, "euler", True, pp, x0, xsb, xTb, usb, koldb, Koldb, lam,
             c0, live, alphas, "jvp", True, cfg.z_min, cfg.tol_grad,
             cfg.lambda_grad_term), "iteration", True,
            lambda got: old_b * ((got[10] < 0.5) & (live > 0.5))
            .float().mean().item()),
    }
    if name == "omni_thruster":   # its unconstrained path is the split one
        cases["sweep_packed/unconstrained"] = (
            kernel_sweep.sweep_packed, kernel_sweep.sweep_plain,
            (model, "euler", pp, xsb, xTb, usb, lam, "jvp", False), "sweep",
            False, None)
    if name in ("double_integrator", "omni_thruster", *CLI_MODELS):
        cases["iteration_packed/unconstrained"] = (
            kernel_iter.iteration_packed, kernel_iter.iteration_plain,
            (model, "euler", False, pp, x0, xsb, xTb, usb, koldb, Koldb, lam,
             c0, live, alphas, "jvp", False, cfg.z_min, cfg.tol_grad,
             cfg.lambda_grad_term), "iteration", False,
            lambda got: old_b * ((got[10] < 0.5) & (live > 0.5))
            .float().mean().item())
    rows = {}
    for label, (op, plain, args, kind, limits, unread) in cases.items():
        key = f"{label.split('/')[0]}/{name}" + (
            "" if limits else "/unconstrained")
        Tc = Tb if kind in ("sweep", "iteration") else T
        step, rest = lane_ops(model, params, kind, limits, A, dt)
        row = compare_stage(
            key, op, plain, args, step * Tc * B + rest * B,
            f"({step} per (t, lane)) at B={B} T={Tc} A={A}", unread,
            plain_reps=0)
        rows[key] = dict(row, kernel=f"{kind}_kernel", model=name,
                         limits=limits, T=Tc)
    return rows


def run_model_path(dev, name, label, B=B_M, reps=3, warmup=True,
                   **cfg_extra):
    """One slice path through solve_batch_fused: a warm-up solve on the
    first x0 draw (unless ``warmup`` is False), then ``reps`` timed solves
    on new draws, each ending in a full device-to-host copy, with the
    launch counts of the first timed solve (set to 0 just before it, read
    just after)."""
    model, params, cfg, T, dt, u0, draw = workload(name, B)
    cfg = cfg.replace(**cfg_extra)
    rng = np.random.default_rng(0)
    x0_first = draw(rng)
    pp = kernel_rollout.pack_params(params, dt, dev)
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    us_in = torch.as_tensor(u0, device=dev)[:, :, None].expand(
        T, model.m, B).contiguous()
    init = kernel_rollout.rollout_packed(
        model, "euler", cfg.clamp_forward, pp,
        torch.as_tensor(x0_first, device=dev).t().contiguous(), us_in,
        zeros(T, model.n, B), zeros(T, model.m, model.n, B))[3]
    init_cost = float(init.mean().item())
    first_cost = None
    if warmup:
        first = solve_batch_fused(model, params, cfg, dt, x0_first, u0)
        first_cost = first.cost.cpu().numpy()
    runs = []
    for rep in range(reps):
        x0 = draw(rng)
        reset_launch_counts()
        fused._host_any.syncs = 0
        fused._iteration.calls = 0
        fused._iteration.retried = 0
        t0 = time.perf_counter()
        sol = solve_batch_fused(model, params, cfg, dt, x0, u0)
        host = {k: v.cpu() for k, v in sol._asdict().items()}  # full D2H
        wall = time.perf_counter() - t0
        runs.append(dict(wall=wall, counts=launch_counts(),
                         host_iters=fused._iteration.calls,
                         syncs=fused._host_any.syncs,
                         retried=fused._iteration.retried, sol=host))
    walls = [r["wall"] for r in runs]
    sol, c = runs[-1]["sol"], runs[0]["counts"]
    cost = sol["cost"].numpy()
    its = max(1, runs[0]["host_iters"])
    hist = {int(k): int(v) for k, v in
            zip(*np.unique(sol["reason"].numpy(), return_counts=True))}
    # controls exactly on their lower bound (the clamped rollout puts
    # them there): the one-sided thrusters' share
    at_lower = float((sol["us"] <= params.u_min.reshape(-1) + 1e-5)
                     .float().mean())
    out = dict(
        B=B, T=T, dt=dt, max_iter=cfg.max_iter, solves_per_s=B / float(
            np.median(walls)), wall_s=walls, mean_cost=float(cost.mean()),
        init_mean_cost=init_cost,
        mean_iters=float(sol["iterations"].float().mean()),
        reason_hist=hist, launches=c, host_iterations=runs[0]["host_iters"],
        syncs_per_iteration=runs[0]["syncs"] / its,
        retried_share=runs[0]["retried"] / its,
        ms_per_iteration=float(np.median(walls)) * 1e3 / its,
        lower_bound_share=at_lower)
    print(f"[slice] {label}: B={B} T={T} max_iter={cfg.max_iter}: "
          f"{out['solves_per_s']:.1f} solves/s (median of {reps}; "
          f"{nvidia_smi()}), {out['ms_per_iteration']:.3f} ms/iteration, "
          f"mean_cost {out['mean_cost']:.4f} (initial rollout "
          f"{init_cost:.4f}), mean_iters {out['mean_iters']:.2f}, reasons "
          f"{hist}, controls at the lower bound {at_lower:.3f}, launches "
          f"{c}, host syncs/iteration {out['syncs_per_iteration']:.3f}, "
          f"iterations that retried {out['retried_share']:.3f}")
    if not np.all(np.isfinite(cost)):
        raise AssertionError(f"non-finite costs on the {label} path")
    if not out["mean_cost"] < init_cost:
        raise AssertionError(f"{label}: mean cost {out['mean_cost']} is not "
                             f"below the initial rollout's {init_cost}")
    if c["rollout_packed"] != 1:
        raise AssertionError(f"{label}: rollout_packed ran "
                             f"{c['rollout_packed']} times in one solve")
    return out, (x0_first, first_cost, walls)


def route_gauge(dev, name, label, x0, ref_cost, **cfg_extra):
    """The same first x0 through another route (launch counts set to 0 just
    before, read just after), held against ``ref_cost`` under the gauge."""
    model, params, cfg, T, dt, u0, _draw = workload(name)
    reset_launch_counts()
    sol = solve_batch_fused(model, params, cfg.replace(**cfg_extra), dt, x0,
                            u0)
    cost = sol.cost.cpu().numpy()
    counts = launch_counts()
    p99, mx = gauge(cost, ref_cost)
    print(f"[slice] {label} at B={len(x0)} T={T} max_iter={cfg.max_iter}: "
          f"per-lane |c1-c2|/(1+|c2|) p99 {p99:.3e} (≤ {GAUGE_P99:g}), max "
          f"{mx:.3e} (≤ {GAUGE_MAX:g}); launches {counts}")
    if not (np.isfinite(cost).all() and p99 <= GAUGE_P99
            and mx <= GAUGE_MAX):
        raise AssertionError(f"{label} outside the gauge")
    return dict(p99=p99, max=mx, launches=counts)


def check_references(dev):
    """The slice's solutions against the repo's references on small
    inputs: the double integrator's reference solve against the reference
    binary's golden trajectory and cost, and short point-mass and
    quadrotor solves against the plain path on the CPU."""
    out = {}
    model, params, cfg, T, dt, u0, _d = workload("double_integrator")
    sol = solve_batch_fused(model, params, cfg, dt,
                            np.asarray([[-1.0, 0.0, 0.0, -0.2]], np.float32),
                            u0)
    rows = [[float(v) for v in line.replace(",", " ").split()]
            for line in open(GOLDEN_CSV).read().splitlines()[1:]]
    gu = np.asarray([r[4:6] for r in rows[:-1]])
    cost = float(sol.cost.item())
    us_err = float(np.abs(sol.us[0].cpu().numpy() - gu).max())
    out["integrator_golden"] = dict(cost=cost, golden_cost=GOLDEN_COST,
                                    max_us_err=us_err,
                                    iterations=int(sol.iterations.item()))
    print(f"[slice] double integrator from (-1, 0, 0, -0.2): cost {cost:.4f} "
          f"(reference {GOLDEN_COST}, ≤ {GOLDEN_COST_TOL}), max |u − u_ref| "
          f"{us_err:.2e} (≤ {GOLDEN_US_TOL:g}) after "
          f"{int(sol.iterations.item())} iterations")
    if not (abs(cost - GOLDEN_COST) <= GOLDEN_COST_TOL
            and us_err <= GOLDEN_US_TOL):
        raise AssertionError("the double integrator left the reference's "
                             "solution")
    for name, T_c, iters in (("point_mass_3d", M23_T, 10),
                             ("quadrotor", 20, 5)):
        out[f"{name}_card_vs_cpu"] = card_vs_cpu(name, T_c, iters)
    return out


def card_vs_cpu(name, T_c, iters, lanes=4):
    """A short solve on the card against the plain path on the CPU (the
    path's first ``T_c`` steps), held to CPU_RTOL[name] in relative cost."""
    model, params, cfg, _T, dt, u0, draw = workload(name, B=lanes)
    cfg = cfg.replace(max_iter=iters)
    x0 = draw(np.random.default_rng(9))
    card = solve_batch_fused(model, params, cfg, dt, x0, u0[:T_c])
    cpu = solve_batch_fused(model, params, cfg, dt, x0, u0[:T_c],
                            device="cpu")
    c_card, c_cpu = card.cost.cpu().numpy(), cpu.cost.numpy()
    rel = float(np.max(np.abs(c_card - c_cpu) / np.abs(c_cpu)))
    print(f"[slice] {name}, {lanes} lanes, T={T_c}, max_iter={iters}: card "
          f"vs the plain path on the CPU, max relative cost difference "
          f"{rel:.2e} (≤ {CPU_RTOL[name]:g})")
    if not (np.isfinite(c_card).all() and rel <= CPU_RTOL[name]):
        raise AssertionError(f"{name}: the card left the CPU's solve")
    return dict(T=T_c, max_iter=iters, lanes=lanes, max_rel_cost_diff=rel)


def ptxas_table(log: str):
    """(kernel, model, limits) → registers, spills and source file, from
    ptxas -v. The build log heads each source's report with "ptxas log of
    <file>": each csrc/kernels_<model>.cu (and kernels_<model>_iteration.cu,
    where a model's iteration kernels compile apart) instantiates one
    model, and the other sources (kernels.cu, derivs.cu, backward.cu) are
    acrobot's."""
    table, entry, model, source = {}, None, "acrobot", None
    for line in log.splitlines():
        if line.startswith("ptxas log of "):
            source = line[len("ptxas log of "):].strip()
            stem = source.removesuffix(".cu")
            model = (stem[len("kernels_"):].removesuffix("_iteration")
                     if stem.startswith("kernels_") else "acrobot")
        elif "Compiling entry function" in line:
            name = line.split("'")[1]
            kernel = next((k for k in KERNEL_NAMES if k in name), name)
            limits = None   # the sweep and iteration kernels' template flag
            if kernel in ("sweep_kernel", "iteration_kernel"):
                limits = "Lb1E" in name
            entry = table.setdefault((kernel, model, limits), {})
            entry["source"] = f"ilqr_tpu_torch/csrc/{source}"
        elif entry is not None and "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            entry.update(stack_bytes=nums[0], spill_stores=nums[1],
                         spill_loads=nums[2])
        elif entry is not None and "Used" in line and "registers" in line:
            entry["registers"] = int(line.split("Used")[1].split()[0])
            entry = None
    return table


def run_slice(dev):
    """Phase 8: the m = 2…4 slice. Returns (kernel rows, results)."""
    rows = {}
    for name in SLICE_MODELS:
        rows.update(compare_model_kernels(dev, name))
    res = {}
    quad, (qx0, qcost, qwalls) = run_model_path(dev, "quadrotor",
                                                "quadrotor")
    c = quad["launches"]
    if (c["sweep_packed"] < quad["host_iterations"]
            or c["linesearch_packed"] < 1 or c["iteration_packed"]):
        raise AssertionError(f"the quadrotor's auto route is the split "
                             f"iteration (m·n ≥ 32): {c}")
    model, params, cfg, T, dt, u0, draw = workload("quadrotor")
    quad["profile"] = profile_solve(
        "quadrotor", lambda x0, u0_: solve_batch_fused(model, params, cfg,
                                                       dt, x0, u0_),
        float(np.median(qwalls)), draw(np.random.default_rng(2)), u0)
    quad["wide"], _w = run_model_path(dev, "quadrotor",
                                      "quadrotor at B = 8192 (not asserted)",
                                      B=B_WIDE, reps=1)
    quad["merged_route"] = route_gauge(
        dev, "quadrotor", "quadrotor merged route vs split", qx0, qcost,
        iter_kernel="merged")
    res["quadrotor"] = quad
    for key in ("rollout_packed", "sweep_packed", "linesearch_packed"):
        rows[f"{key}/quadrotor"]["launches"] = c[key]
    rows["iteration_packed/quadrotor"]["launches"] = (
        quad["merged_route"]["launches"]["iteration_packed"])

    for name in ("double_integrator", "point_mass_3d"):
        out, (x0, cost, _w) = run_model_path(dev, name, name)
        c = out["launches"]
        if (c["iteration_packed"] < out["host_iterations"]
                or c["sweep_packed"] or c["linesearch_packed"]):
            raise AssertionError(f"{name}: the auto route is the whole "
                                 f"iteration kernel (m·n < 32): {c}")
        out["split_route"] = route_gauge(
            dev, name, f"{name} split route vs merged", x0, cost,
            iter_kernel="split")
        for key in ("rollout_packed", "iteration_packed"):
            rows[f"{key}/{name}"]["launches"] = c[key]
        for key in ("sweep_packed", "linesearch_packed"):
            rows[f"{key}/{name}"]["launches"] = (
                out["split_route"]["launches"][key])
        res[name] = out
    free, _x = run_model_path(dev, "double_integrator",
                              "double integrator without limits",
                              use_control_limits=False, clamp_forward=False)
    rows["iteration_packed/double_integrator/unconstrained"]["launches"] = (
        free["launches"]["iteration_packed"])
    res["double_integrator_unconstrained"] = free
    res["references"] = check_references(dev)
    return rows, res


def short_solve(name, label, max_iter, **cfg_extra):
    """One solve of ``name``'s workload cut to ``max_iter`` iterations (the
    cut printed), launch counts set to 0 just before it and read just
    after; costs must be finite."""
    model, params, cfg, T, dt, u0, draw = workload(name)
    cfg = cfg.replace(max_iter=max_iter, **cfg_extra)
    x0 = draw(np.random.default_rng(0))
    reset_launch_counts()
    t0 = time.perf_counter()
    sol = solve_batch_fused(model, params, cfg, dt, x0, u0)
    cost = sol.cost.cpu().numpy()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    print(f"[wide] {label}: B={len(x0)} T={T} max_iter={max_iter} (cut from "
          f"{WIDE_ITERS}) {wall:.3f} s, mean_cost {cost.mean():.4f}, "
          f"launches {counts}")
    if not np.isfinite(cost).all():
        raise AssertionError(f"{label}: non-finite costs")
    return dict(max_iter=max_iter, wall_s=wall, mean_cost=float(cost.mean()),
                launches=counts)


def run_wide_slice(dev):
    """Phase 9: the m ≥ 5 slice. Returns (kernel rows, results)."""
    rows, res = {}, {}
    t0 = time.perf_counter()
    for name in WIDE_MODELS:
        rows.update(compare_model_kernels(
            dev, name, t_backward=None if name in (
                "omni_thruster", "free_flyer", "thruster_ring")
            else WIDE_T_BACKWARD))
    print(f"[time] phase 9a (kernels against plain versions) "
          f"{time.perf_counter() - t0:.1f} s")

    def split_route(out, label):
        c = out["launches"]
        if (c["sweep_packed"] < out["host_iterations"]
                or c["linesearch_packed"] < 1 or c["iteration_packed"]
                or c["rollout_packed"] != 1):
            raise AssertionError(f"{label}: the auto route is the split "
                                 f"iteration (m·n ≥ 32): {c}")

    def record(name, split_counts, merged_counts, suffix=""):
        for key in ("rollout_packed", "sweep_packed", "linesearch_packed"):
            if f"{key}/{name}{suffix}" in rows:
                rows[f"{key}/{name}{suffix}"]["launches"] = split_counts[key]
        rows[f"iteration_packed/{name}{suffix}"]["launches"] = (
            merged_counts["iteration_packed"])

    # (b) thruster_ring, the full-width path
    t0 = time.perf_counter()
    ring, (rx0, rcost, rwalls) = run_model_path(
        dev, "thruster_ring", "thruster_ring (m = 12, full width)")
    split_route(ring, "thruster_ring")
    model, params, cfg, T, dt, u0, draw = workload("thruster_ring")
    ring["profile"] = profile_solve(
        "thruster_ring", lambda x0, u0_: solve_batch_fused(
            model, params, cfg, dt, x0, u0_),
        float(np.median(rwalls)), draw(np.random.default_rng(2)), u0)
    ring["wide"], _w = run_model_path(
        dev, "thruster_ring", "thruster_ring at B = 8192 (not asserted)",
        B=B_WIDE, reps=1, warmup=False)
    ring["merged_route"] = route_gauge(
        dev, "thruster_ring", "thruster_ring merged route vs split", rx0,
        rcost, iter_kernel="merged")
    record("thruster_ring", ring["launches"],
           ring["merged_route"]["launches"])
    res["thruster_ring"] = ring
    print(f"[time] phase 9b (thruster_ring) {time.perf_counter() - t0:.1f} s")

    # (c) omni_thruster with and without limits, free_flyer; (e) their
    # merged routes against the split ones
    t0 = time.perf_counter()
    for name, label, extra in (
            ("omni_thruster", "omni_thruster", {}),
            ("omni_thruster", "omni_thruster without limits",
             dict(use_control_limits=False, clamp_forward=False)),
            ("free_flyer", "free_flyer", {})):
        out, (x0, cost, _w) = run_model_path(dev, name, label, **extra)
        split_route(out, label)
        limits = extra.get("use_control_limits", True)
        if limits and not out["lower_bound_share"] > LOWER_SHARE:
            raise AssertionError(
                f"{label}: {out['lower_bound_share']} of the controls on "
                f"the lower bound (expected > {LOWER_SHARE})")
        out["merged_route"] = route_gauge(
            dev, name, f"{label}: merged route vs split", x0, cost,
            iter_kernel="merged", **extra)
        record(name, out["launches"], out["merged_route"]["launches"],
               "" if limits else "/unconstrained")
        res[label] = out
    print(f"[time] phase 9c (omni_thruster, free_flyer) "
          f"{time.perf_counter() - t0:.1f} s")

    # (d) thruster_ring24 at the cap; thruster_ring16/20 at a cut depth
    t0 = time.perf_counter()
    model, params, cfg, T, dt, u0, draw = workload("thruster_ring24")
    pp = kernel_rollout.pack_params(params, dt, dev)
    x0 = torch.as_tensor(draw(np.random.default_rng(0)), device=dev)
    z = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=dev)
    us_in = torch.as_tensor(u0, device=dev)[:, :, None].expand(
        T, model.m, B_M).contiguous()
    xs0, us0, xT0, _c = kernel_rollout.rollout_packed(
        model, "euler", True, pp, x0.t().contiguous(), us_in,
        z(T, model.n, B_M), z(T, model.m, model.n, B_M))
    sweep_ms = time_ms(lambda: kernel_sweep.sweep_packed(
        model, "euler", pp, xs0, xT0, us0, torch.ones(B_M, device=dev)),
        reps=1)
    # a solve runs about one sweep and one line search per iteration
    cap_iters = min(WIDE_ITERS, max(1, int(CAP_SOLVE_S * 1e3
                                           / (1.5 * sweep_ms))))
    print(f"[wide] thruster_ring24: one sweep launch {sweep_ms:.1f} ms at "
          f"B={B_M} T={T}; max_iter {cap_iters}"
          + ("" if cap_iters == WIDE_ITERS else
             f" (cut from {WIDE_ITERS} to keep one solve under "
             f"{CAP_SOLVE_S:g} s)"))
    cap, _r = run_model_path(dev, "thruster_ring24",
                             "thruster_ring24 (m = 24, the cap)", reps=1,
                             warmup=False, max_iter=cap_iters)
    split_route(cap, "thruster_ring24")
    cap["sweep_ms_per_launch"] = sweep_ms
    cap["merged_short"] = short_solve(
        "thruster_ring24", "thruster_ring24 merged route", SHORT_ITERS,
        iter_kernel="merged")
    record("thruster_ring24", cap["launches"],
           cap["merged_short"]["launches"])
    res["thruster_ring24"] = cap
    for name in ("thruster_ring16", "thruster_ring20"):
        split = short_solve(name, name, SHORT_ITERS)
        merged = short_solve(name, f"{name} merged route", SHORT_ITERS,
                             iter_kernel="merged")
        record(name, split["launches"], merged["launches"])
        res[name] = dict(split=split, merged=merged)
    print(f"[time] phase 9d (thruster_ring16/20/24) "
          f"{time.perf_counter() - t0:.1f} s")

    # (f) card against CPU on short solves
    res["card_vs_cpu"] = {name: card_vs_cpu(name, 10, 3) for name in
                          ("omni_thruster", "thruster_ring")}
    return rows, res


def run_cli_slice(dev):
    """Phase 10: the last four models. Returns (kernel rows, results)."""
    rows, res = {}, {}
    t0 = time.perf_counter()
    for name in CLI_MODELS:
        rows.update(compare_model_kernels(dev, name))
    print(f"[time] phase 10a (kernels against plain versions) "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    for name in CLI_MODELS:
        out, (x0, cost, walls) = run_model_path(
            dev, name, f"{name} (CLI problem, full width)")
        c = out["launches"]
        if (c["iteration_packed"] < out["host_iterations"]
                or c["sweep_packed"] or c["linesearch_packed"]):
            raise AssertionError(f"{name}: the auto route is the whole "
                                 f"iteration kernel (m·n < 32): {c}")
        # every lane of the warm-up solve ends at or below its own initial
        # rollout's cost (iLQR accepts only steps that lower it)
        model, params, cfg, T, dt, u0, draw = workload(name)
        pp = kernel_rollout.pack_params(params, dt, dev)
        z = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=dev)
        init = kernel_rollout.rollout_packed(
            model, "euler", True, pp,
            torch.as_tensor(x0, device=dev).t().contiguous(),
            torch.as_tensor(u0, device=dev)[:, :, None].expand(
                T, model.m, len(x0)).contiguous(),
            z(T, model.n, len(x0)), z(T, model.m, model.n, len(x0)))[3]
        init = init.cpu().numpy()
        out["lanes_below_initial"] = float(np.mean(cost < init))
        out["first_draw_mean_cost"] = float(cost.mean())
        print(f"[slice] {name}: on the first x0 draw (the warm-up solve) "
              f"mean cost {cost.mean():.4f}; {out['lanes_below_initial']:.4f}"
              f" of the lanes end below their initial rollout's cost, none "
              f"above")
        if not np.all(cost <= init):
            raise AssertionError(f"{name}: a lane ended above its initial "
                                 f"rollout's cost")
        out["profile"] = profile_solve(
            name, lambda x0_, u0_: solve_batch_fused(model, params, cfg, dt,
                                                     x0_, u0_),
            float(np.median(walls)), draw(np.random.default_rng(2)), u0)
        out["split_route"] = route_gauge(
            dev, name, f"{name} split route vs merged", x0, cost,
            iter_kernel="split")
        free, _f = run_model_path(
            dev, name, f"{name} without limits", reps=1, warmup=False,
            use_control_limits=False, clamp_forward=False)
        out["unconstrained"] = free
        for key in ("rollout_packed", "iteration_packed"):
            rows[f"{key}/{name}"]["launches"] = c[key]
        for key in ("sweep_packed", "linesearch_packed"):
            rows[f"{key}/{name}"]["launches"] = (
                out["split_route"]["launches"][key])
        rows[f"iteration_packed/{name}/unconstrained"]["launches"] = (
            free["launches"]["iteration_packed"])
        res[name] = out
    print(f"[time] phase 10b (the four paths) "
          f"{time.perf_counter() - t0:.1f} s")
    res["card_vs_cpu"] = {name: card_vs_cpu(name, CLI_CPU_T, CLI_CPU_ITERS)
                          for name in CLI_MODELS}
    return rows, res


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
    print(f"[build] {lib.name} from {len(_build.sources())} sources in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          f"{' '.join(_build.NVCC_FLAGS)}, one process per .cu); seconds "
          f"per source {json.dumps(_build.compile_seconds())}")
    ptxas = ptxas_table(_build.build_log())
    for (kernel, model_name, limits), e in sorted(
            ptxas.items(), key=lambda kv: str(kv[0])):
        print(f"[build] {kernel}<{model_name}"
              + ("" if limits is None else f", limits={limits}")
              + f">: {e.get('registers')} registers, "
              f"{e.get('stack_bytes')} B stack, {e.get('spill_stores')} B "
              f"spill stores, {e.get('spill_loads')} B spill loads")

    t_phase = t0

    def tick(label):
        nonlocal t_phase
        now = time.perf_counter()
        print(f"[time] {label} {now - t_phase:.1f} s", flush=True)
        t_phase = now

    tick("phases 1-2 (environment, build)")
    model = get_model("acrobot")
    params = acrobot.default_params()
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       use_control_limits=True, max_iter=MAX_ITER)
    pp = kernel_rollout.pack_params(params, DT, dev)
    rows = compare_kernels(dev, model, pp, cfg)
    tick("phase 3 (acrobot kernels against plain versions)")

    main_out = run_main_path(dev, model, params, cfg)
    for name in ("rollout_packed", "iteration_packed"):
        rows[name]["launches"] = main_out["launches"][name]
    main_out["profile"] = profile_solve(
        "fused", lambda x0, u0: solve_batch_fused(model, params, cfg, DT, x0,
                                                  u0),
        float(np.median(main_out["wall_s"])))
    tick("phase 4 (the flagship path)")
    split_counts, gauges = run_split_path(dev, model, params, cfg)
    for name in ("sweep_packed", "linesearch_packed"):
        rows[name]["launches"] = split_counts[name]
    tick("phase 5 (split route, plain path)")
    comp_out = run_composable_path(dev, model, params, cfg, main_out)
    for name in ("derivs_packed", "backward_sweep_packed"):
        rows[name]["launches"] = comp_out["launches"][name]
    tick("phase 6 (composable path)")
    equiv = run_equivalence(dev, model, params, cfg)
    tick("phase 7 (equivalence)")
    rows = {f"{name}/acrobot": dict(r, kernel=name.replace(
        "_packed", "_kernel").replace("backward_sweep", "backward"),
        model="acrobot", limits=True) for name, r in rows.items()}
    slice_rows, slice_out = run_slice(dev)
    rows.update(slice_rows)
    tick("phase 8 (the m = 2…4 slice)")
    wide_rows, wide_out = run_wide_slice(dev)
    rows.update(wide_rows)
    tick("phase 9 (the m ≥ 5 slice)")
    cli_rows, cli_out = run_cli_slice(dev)
    rows.update(cli_rows)
    tick("phase 10 (pendulum, cartpole, bicycle, power_mass)")
    print(f"[time] phases 2-10 {time.perf_counter() - t0:.1f} s", flush=True)
    for name, r in rows.items():
        r["name"] = name
        if r["model"] != "acrobot":
            r.update(route="cuda",
                     source=f"ilqr_tpu_torch/csrc/kernels_{r['model']}.cu",
                     replaces=REPLACES[name.split("/")[0]], tol=KERNEL_TOL,
                     library_ms=None, library_note=(
                         "no single PyTorch call computes this function"))
        limits = r["limits"] if r["kernel"] in (
            "sweep_kernel", "iteration_kernel") else None
        r.update(ptxas.get((r["kernel"], r["model"], limits), {}))
    if not all(r.get("launches") for r in rows.values()):
        raise AssertionError(f"a kernel was never launched: {rows}")

    print(json.dumps({"main_path": main_out, "split_path": gauges,
                      "composable_path": comp_out, "equivalence": equiv,
                      "slice": slice_out, "wide_slice": wide_out,
                      "cli_slice": cli_out}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
