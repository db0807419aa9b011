#!/usr/bin/env python3
"""Drives ilqr_tpu_torch's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: the CUDA kernels from ilqr_tpu_torch/csrc with nvcc, one
     process per source, all started together (each source's seconds and
     each kernel's registers, stack and spills printed);
  3. every kernel × model instantiation (and each RK4 reading, a runtime
     mode of a kernel) against its plain PyTorch version on the card, on
     the inputs of its path at that path's shapes: the flagship's at
     B = 8192, T = 499, A = 11 (the derivative kernel in both its modes);
     each m ≥ 2 model's four kernels (the analytic ones at phases 8-10's
     shapes, the stencil sweep and iteration and the RK4 rollout and line
     search at the CLI problem's); the dual-number sweep and iteration of
     all 14 models and the split sweep's derivative and backward kernels
     of acrobot, pendulum and cartpole at phase 12's shapes
     (thruster_ring16/20/24's sweep and iteration on their first 4
     steps). This process times each kernel
     alone on the card (CUDA events); then worker processes run the plain
     versions, which are host-bound, longest first; each case prints its
     errors, times and bound;
  4. the fused path: acrobot swing-up through solve_batch_fused at
     B = 8192, T = 499, max_iter = 100 — solves/s, cost, iterations, launch
     counts; then one more solve under torch.profiler for the device time
     by kernel and the device's busy share;
  5. the fused split route (sweep + line-search kernels) against the merged
     one, and the kernel path against the plain path on the card, at
     B = 1024, max_iter = 4; beside them, not asserted, the kernel path
     from an x0 moved by 1e-6, which shows how far rounding alone carries
     a lane on this chaotic workload;
  6. the composable path: solve_batch at the same size on the same x0
     (derivative, backward and rollout kernels; the line search as one
     rollout over B·A lanes) beside solve_batch_fused — solves/s, cost,
     iterations, launches, λ retries — and one profiled solve;
  7. equivalence at B = 1024, T = T_EQ, 12 iterations: the composable
     path and the fused split sweep each against the fused merged route
     (the gauge below), with the share of lanes a 1e-6 nudge of x0 forks;
  8. the m = 2…4 slice (experiments/secondary_bench.py's workloads): the
     quadrotor path at full width (B = 1024, T = 80, max_iter = 40:
     solves/s, cost, iterations, reasons, launches, a profiled solve) and
     its merged route against its split one under the gauge; the double
     integrator (with and without limits) and 3-D point mass paths
     (B = 1024, T = 99), and their split routes against the merged ones; the double integrator's reference solve
     against golden/integrator_golden.csv, and short solves of the point
     mass and the quadrotor against the plain path on the CPU;
  9. the m ≥ 5 slice (projected Newton in the sweep): the thruster_ring
     path at full width (B = 1024, T = 80, max_iter = 40: solves/s, cost,
     iterations, reasons, the share of controls on the lower bound,
     launches, a profiled solve) and its merged route; the omni_thruster
     (with and without limits) and free_flyer paths and their merged
     routes under the gauge;
     thruster_ring24 at the cap (one solve, max_iter cut if it would take
     over 10 s) and thruster_ring16/20 at a cut depth; short omni_thruster
     and thruster_ring solves against the plain path on the CPU;
 10. the last four models (pendulum, cartpole, bicycle, power_mass — the
     live cxu, cxx off-diagonals and full cuu of the sweep's general
     terms): each model's path at full width (the CLI's canonical problem
     at --batch 1024, uncut: solves/s, ms per iteration, cost against the
     initial rollout's, iterations, reasons, launches; power_mass, the
     headline, timed thrice and profiled), its split route against the
     merged one under the gauge, its path
     without limits, and a short solve against the plain path on the CPU;
 11. the reference's central stencils inside the fused sweep
     (deriv_mode="fd", the CLI's default) and RK4: the CLI's batch solves
     (ilqr_tpu/__main__.py:176-229) at full width: acrobot at B = 8192,
     T = 499, max_iter = 100 with Euler and with RK4 (and the costs of
     its first 64 lanes, which tests/test_torch_cli_predict.py solves on
     the CPU), the quadrotor with RK4 (B = 1024, T = 120, the split
     iteration), the other twelve models' canonical problems at B = 1024
     (the rings 16-24 at a cut depth, thruster_ring's max_iter capped) —
     solves/s, ms per iteration, host iterations, cost against each lane's
     initial rollout's, reasons, launches, acrobot's solve profiled — each
     route
     against the other under the gauge (the m·n ≥ 32 models' merged routes
     at a cut depth), the paths without limits, and short solves against
     the plain path on the CPU;
 12. the dual-number slice: the CLI's batch solves with analytic
     derivatives and RK4 (--deriv-mode analytic --integrator-scheme rk4:
     the sweep's in-kernel JVP route, exact dual-number derivatives of the
     RK4 step): acrobot at B = 8192, T = 499 (the first 64 lanes' costs
     printed), the quadrotor (the split iteration), the other twelve
     canonical problems (rings 16-24 at a cut depth, thruster_ring's
     max_iter capped), each route against the other, without limits where
     phase 11 runs so; the split sweep (--sweep-kernel split: the
     derivative and backward kernels) of pendulum and cartpole (analytic
     Euler, analytic RK4, fd Euler) and acrobot (analytic and fd RK4, B =
     8192, T = 499), each against the merged route under the gauge; short
     solves against the plain path on the CPU;
 13. per-problem params and the fleet warm start: first, every per-lane
     kernel with lane 0's problem on every row against the same problem
     as shared params, bit for bit; then (a) examples/free_flyer_docking.py's
     fleet at B = 1024, T = 80, max_iter 40 (per-craft docking ports and
     thrust ceilings; solves/s, cost, iterations, median docking error;
     every craft under its own ceiling, every lane at or below its initial
     rollout's cost); (b) the CLI's pendulum problem (T = 199) at B = 1024
     with per-lane goals and limits ±8 on the whole-iteration kernel and
     on the split sweep (each lane at or below its initial cost, three
     lanes solved alone with shared params equal to the batch, the split
     sweep against the merged one under the gauge); (c) the fleet MPC of
     experiments/secondary_bench.py:296-327 (acrobot, B = 1024, T = 199,
     max_iter 20): a cold fleet_init, a warm re-solve from the same states
     (no lane worse by over 1e-3), FLEET_CYCLES fleet_step replans
     (replans/s, cycle ms, iterations); phase 3 holds the per-lane params
     mode of the rollout, sweep and line search at (a)'s shapes and of the
     rollout, whole iteration and derivative kernel at (b)'s (lanes_cases;
     readings lanes_* of their rows);
 14. one JSON line listing every kernel × model instantiation launched (the
     RK4 readings as rk4_* fields of the kernel's row, the stencil mode's
     RK4 reading of the derivative kernel as rk4_fd_*, the per-lane params
     readings as lanes_*), the card's line, and the last line
     {"ok": true, "device": {...}}. Each phase prints its seconds.

It needs one CUDA device and the ilqr_tpu_torch package beside it; without
either it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import multiprocessing
import os
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch import (
    SolverConfig,
    fused,
    get_model,
    mpc,
    solve_batch,
    solve_batch_fused,
    solve_batch_fused_warm,
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
# Phase 5 at a cut depth (4 iterations): its plain path takes ~7 s per
# iteration at T = 499 on an H100 80GB HBM3 (700 W).
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

def flagship():
    """(model, params, cfg) of the acrobot flagship (bench.py:109-148)."""
    return (get_model("acrobot"), acrobot.default_params(),
            SolverConfig(deriv_mode="analytic", clamp_forward=True,
                         use_control_limits=True, max_iter=MAX_ITER))


class Case(NamedTuple):
    """One kernel on one set of inputs, beside its plain version."""
    op: Callable            # the op: its kernel, on CUDA tensors
    plain: Callable         # the op's plain version
    args: tuple
    ops: Callable           # () → f32 operations of one call
    where: str              # the shapes, as printed
    unread: Callable | None  # outputs → bytes the function need not read
    meta: dict              # row, group, kernel, model, limits, T, effort


def effort(kind, Tc, n, m):
    """A rough measure of a plain version's host time (one PyTorch op per
    operation of the kernel), by which the longest comparisons start
    first."""
    z = n + m
    per_step = {"rollout": z, "linesearch": 11 * z, "derivs": z,
                "backward": z}.get(kind, z * z * max(1, m // 4))
    return Tc * per_step


def acrobot_cases(dev):
    """The flagship's kernels at the main path's shapes, on realistic
    inputs: the flagship x0, its open-loop rollout and the first
    iteration's gains; masks mixed over the lanes. Then the composable
    path's: derivs_packed in both modes and backward_sweep_packed, on the
    open-loop trajectory and its derivatives."""
    model, params, cfg = flagship()
    pp = kernel_rollout.pack_params(params, DT, dev)
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
    xs0, us0, xT0, c0 = kernel_rollout.rollout_packed(
        model, "euler", True, pp, x0, zeros(T, M, B), zeros(T, N, B),
        zeros(T, M, N, B))
    k1, K1, dv1, _d, _g = kernel_sweep.sweep_packed(model, "euler", pp, xs0,
                                                    xT0, us0, lam)
    xsr = xs0 + f(0.01 * rng.normal(size=(T, N, B)))
    Kr = f(0.05 * rng.normal(size=(T, M, N, B)))
    uff = us0 + f(0.5 * rng.normal(size=(T, M, B)))
    kold = f(rng.normal(size=(T, M, B)))
    Kold = f(rng.normal(size=(T, M, N, B)))
    at = f"at B={B} T={T} A={A}"
    # A candidates and the emitted rollout (+ the sweep); the previous
    # gains are read only on lanes that drop the new ones
    ls_ops = (A + 1) * (OPS_ROLLOUT_STEP + 2) * T * B
    old = nbytes(kold, Kold)

    def meta(label, kind, row=None, group="row"):
        return dict(row=row or f"{label}/acrobot", group=group,
                    kernel=f"{kind}_kernel", model="acrobot", limits=True,
                    T=T, effort=effort(kind, T, N, M))

    cases = {
        "rollout_packed": Case(
            kernel_rollout.rollout_packed, kernel_rollout.rollout_plain,
            (model, "euler", True, pp, x0, uff, xsr, Kr),
            lambda: OPS_ROLLOUT_STEP * T * B, at, None,
            meta("rollout_packed", "rollout")),
        "sweep_packed": Case(
            kernel_sweep.sweep_packed, kernel_sweep.sweep_plain,
            (model, "euler", pp, xs0, xT0, us0, lam),
            lambda: OPS_SWEEP_STEP * T * B, at, None,
            meta("sweep_packed", "sweep")),
        "linesearch_packed": Case(
            kernel_rollout.linesearch_packed, kernel_rollout.linesearch_plain,
            (model, "euler", True, pp, x0, us0, xs0, xT0, K1, k1, Kold, kold,
             alphas, dv1, c0, gate, keep, cfg.z_min),
            lambda: ls_ops, at,
            lambda got: old * (keep > 0.5).float().mean().item(),
            meta("linesearch_packed", "linesearch")),
        "iteration_packed": Case(
            kernel_iter.iteration_packed, kernel_iter.iteration_plain,
            (model, "euler", True, pp, x0, xs0, xT0, us0, kold, Kold, lam,
             c0, live, alphas, "jvp", True, cfg.z_min, cfg.tol_grad,
             cfg.lambda_grad_term),
            lambda: ls_ops + OPS_SWEEP_STEP * T * B, at,
            lambda got: old * ((got[10] < 0.5) & (live > 0.5)).float()
            .mean().item(),
            meta("iteration_packed", "iteration")),
    }

    xs_full = torch.cat([xs0, xT0[None]]).contiguous()
    pp_cpu = kernel_rollout.pack_params(params, DT)
    lane_rng = np.random.default_rng(3)

    def lane_inputs(t):
        xs = torch.as_tensor(0.3 * lane_rng.normal(size=(t + 1, N, 1)),
                             dtype=torch.float32)
        us = torch.as_tensor(2.0 * lane_rng.normal(size=(t, M, 1)),
                             dtype=torch.float32)
        return xs, us

    def derivs_ops(mode):
        step, rest = ops_per_step(lambda t: kernel_derivs.derivs_plain(
            model, "euler", pp_cpu, *lane_inputs(t), mode=mode))
        return step * T * B + rest * B

    for mode in ("jvp", "fd"):
        # the jvp row is the main path's mode (deriv_mode="analytic"); the
        # fd mode rides on it as fd_* fields
        cases[f"derivs_packed ({mode})"] = Case(
            kernel_derivs.derivs_packed, kernel_derivs.derivs_plain,
            (model, "euler", pp, xs_full, us0, mode),
            lambda mode=mode: derivs_ops(mode), f"at B={B} T={T}", None,
            meta("derivs_packed", "derivs", "derivs_packed/acrobot",
                 "row" if mode == "jvp" else "fd_of"))

    fx, fu, cx, cu, cxx, cxu, cuu = kernel_derivs.derivs_packed(
        model, "euler", pp, xs_full, us0)
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

    def backward_ops():
        # the backward recursion's own operations: its count minus the
        # derivative op that builds its inputs above
        step_all, rest_all = ops_per_step(backward_at)
        step_d, rest_d = ops_per_step(lambda t: kernel_derivs.derivs_plain(
            model, "euler", pp_cpu, *lane_inputs(t)))
        return (step_all - step_d) * T * B + (rest_all - rest_d) * B

    cases["backward_sweep_packed"] = Case(
        kernel_backward.backward_sweep_packed, kernel_backward.backward_plain,
        args, backward_ops, f"at B={B} T={T}", None,
        meta("backward_sweep_packed", "backward"))
    return cases


def design_traffic_line():
    """This design's traffic per flagship iteration_packed launch: xs and us
    read by each of the three phases, the (T, 5, B) gain buffer written
    once and read twice, the previous gains read, the new state written."""
    f32 = 4
    xs_us = (T * N + T * M) * B_MAIN * f32
    gains = (T * M + T * M * N) * B_MAIN * f32
    gain_buf = (M * (N + 1)) * T * B_MAIN * f32
    design = 3 * xs_us + 3 * gain_buf + gains + (xs_us + gains)
    return (f"[kernel] iteration_packed in this design moves ~"
            f"{design / 1e9:.3f} GB per launch (~"
            f"{design / PEAK_BYTES * 1e3:.3f} ms at the peak rate); the least "
            f"any design must move is ~{2 * (xs_us + gains) / 1e9:.3f} GB")


def check_case(case):
    """``case``'s kernel and its plain version, once each on the same
    inputs: errors, the plain version's time (CUDA events around its one
    call) and the bound — every input read once and every output written
    once, less ``case.unread(outputs)`` bytes."""
    got = case.op(*case.args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = case.plain(*case.args)
    end.record()
    end.synchronize()
    abs_e, rel_e = max_errs(got, want)
    # bit for bit, NaNs in the same places counting as equal
    bitwise = all(bool(((g == w) | (torch.isnan(g) & torch.isnan(w))).all())
                  for g, w in zip(got, want))
    # every tensor argument, the packed params (one row per lane in the
    # per-lane mode) among them, read once and every output written once
    total = nbytes(*[a.vec if isinstance(a, kernel_rollout.PackedParams)
                     else a for a in case.args
                     if isinstance(a, (torch.Tensor,
                                       kernel_rollout.PackedParams))], *got)
    if case.unread is not None:
        total -= case.unread(got)
    ops = case.ops()
    b_ms, b_by = bound_ms(total, ops)
    return dict(max_abs_err=abs_e, max_err=rel_e, bitwise_equal=bitwise,
                plain_ms=start.elapsed_time(end), bound_ms=b_ms,
                bound_by=b_by, bound_bytes=total, bound_ops=ops)


def comparison_sets():
    """The case builders of phase 3, in the order their rows print."""
    return ([("acrobot",)]
            + [("model", name) for name in (*SLICE_MODELS, *WIDE_MODELS,
                                            *CLI_MODELS)]
            + [("fd", name) for name in CLI_SPECS]
            + [("jvp", name) for name in CLI_SPECS]
            + [("split", name) for name in SPLIT_MODELS]
            + [("lanes", name) for name in LANES_KERNELS])


def build_cases(dev, which):
    if which[0] == "acrobot":
        return acrobot_cases(dev)
    if which[0] == "model":
        return model_cases(dev, which[1])
    if which[0] == "jvp":
        return jvp_cases(dev, which[1])
    if which[0] == "split":
        return split_cases(dev, which[1])
    if which[0] == "lanes":
        return lanes_cases(dev, which[1])
    return fd_cases(dev, which[1])


_WORKER_CASES = {}


def _worker_init():
    torch.set_num_threads(1)


def _worker_job(key):
    """In a worker process: the comparison of case ``key`` = (builder,
    label), its builder's inputs made once per process."""
    which, label = key
    if which not in _WORKER_CASES:
        _WORKER_CASES[which] = build_cases(torch.device(DEVICE), which)
    t0 = time.perf_counter()
    r = check_case(_WORKER_CASES[which][label])
    # the plain version's temporaries back to the card: the processes
    # share its memory with the kernels' local memory
    torch.cuda.empty_cache()
    return key, dict(r, job_s=time.perf_counter() - t0)


# the readings of a row's kernel in another mode, by their group: their key
# in the readings (the row's key and this suffix) and their fields' prefix
READING_SUFFIX = {"rk4": "", "rk4_fd": "#fd", "lanes": "#lanes"}
READING_PREFIX = {"": "rk4_", "fd": "rk4_fd_", "lanes": "lanes_"}


def run_comparisons(dev, tick):
    """Phase 3: every kernel × model instantiation against its plain version
    on the card (and each reading of a kernel's runtime mode: RK4, per-lane
    params). This process times the kernels while it is alone on the card
    (3a); then COMPARE_WORKERS processes run the plain versions, which are
    host-bound and take minutes in sum, longest first (3b). Returns (rows
    by key, readings by the key of their row and READING_SUFFIX)."""
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(COMPARE_WORKERS, initializer=_worker_init) as pool:
        order, times, wheres, metas, jobs = [], {}, {}, {}, []
        for which in comparison_sets():
            cases = build_cases(dev, which)
            for label, case in cases.items():
                key = (which, label)
                order.append(key)
                times[key] = time_ms(lambda: case.op(*case.args), reps=5)
                wheres[key], metas[key] = case.where, case.meta
                jobs.append((case.meta["effort"], key))
            del cases
        torch.cuda.empty_cache()
        tick(f"phase 3a (kernel times, {len(order)} cases)")
        jobs.sort(key=lambda j: -j[0])
        t0 = time.perf_counter()
        results = dict(pool.imap_unordered(_worker_job,
                                           [key for _e, key in jobs]))
        pool.close()
        pool.join()
    wall = time.perf_counter() - t0
    rows, rk4, failed = {}, {}, []
    for key in order:
        r = dict(results[key], ms=times[key])
        job_s = r.pop("job_s")
        print(f"[kernel] {key[1]}: max_abs_err {r['max_abs_err']:.3e} "
              f"max_err {r['max_err']:.3e} (tol {KERNEL_TOL:g}) bitwise "
              f"{r['bitwise_equal']} | kernel {r['ms']:.3f} ms plain "
              f"{r['plain_ms']:.1f} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {r['bound_bytes']:.0f} B, "
              f"{r['bound_ops']} ops) {wheres[key]}; {job_s:.1f} s")
        if not r["max_err"] <= KERNEL_TOL:
            failed.append(key[1])
        meta = metas[key]
        if meta["group"] == "fd_of":
            rows[meta["row"]].update({f"fd_{k}": v for k, v in r.items()})
            continue
        row = dict(r, **{k: v for k, v in meta.items()
                         if k not in ("row", "group", "effort")})
        if meta["group"] == "row":
            rows[meta["row"]] = row
        else:   # "rk4"; "rk4_fd", the RK4 reading of the row's fd mode;
            #     "lanes", the per-lane params reading
            rk4[meta["row"] + READING_SUFFIX[meta["group"]]] = row
    print(design_traffic_line())
    busy = sum(results[key]["job_s"] for key in order)
    print(f"[compare] {len(order)} plain comparisons in {COMPARE_WORKERS} "
          f"processes: {wall:.1f} s wall for {busy:.1f} s of comparisons "
          f"(plain ms: one call, with the other processes sharing the card "
          f"and the host's {os.cpu_count()} cores)")
    if failed:
        raise AssertionError(f"disagree with their plain versions beyond "
                             f"{KERNEL_TOL}: {failed}")
    return rows, rk4


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
    the card, at B = 1024; then, for information only, how far a 1e-6
    nudge of x0 moves per-lane costs on this chaotic workload."""
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

    # Not asserted: an x0 moved by 1e-6 shows how far a last-ulp difference
    # alone can carry a lane by iteration 4 (experiments/equiv_tpu.py).
    nudged = solve_batch_fused(model, params, c4, DT, x0 + np.float32(1e-6),
                               u0)
    a = nudged.cost.cpu().numpy()
    p99, mx = gauge(a, cm)
    forked = float(np.mean(np.abs(a - cm) / (1.0 + np.abs(cm)) > 1e-3))
    res["card_x0+1e-6_vs_card"] = dict(p99=p99, max=mx,
                                       share_over_1e3=forked)
    print(f"[split] card_x0+1e-6_vs_card (information, not asserted): p99 "
          f"{p99:.3e}, max {mx:.3e}, share of lanes over 1e-3 {forked:.4f}")
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
# The sweep and iteration kernels of thruster_ring16/20/24 (analytic and
# fd) against their plain versions on their paths' first 4 steps: the plain
# sweep at m = 24 runs ~10⁵ PyTorch ops per step on the card. Every other
# comparison runs at its path's shapes.
T_BACKWARD = {"thruster_ring16": 4, "thruster_ring20": 4,
              "thruster_ring24": 4}
# Phase 3's plain versions run in this many worker processes (one per host
# core but one): they are host-bound, one PyTorch op per operation.
COMPARE_WORKERS = max(1, min(7, (os.cpu_count() or 2) - 1))
DEVICE = "cuda"
CAP_SOLVE_S = 10.0    # thruster_ring24: max_iter is cut if a solve would
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


def lane_ops(model, params, kind, use_limits=True, A=11, dt=DT, mode="jvp",
             integrator="euler"):
    """f32 operations per (t, lane) and per lane of a kernel, counted from
    its plain version (the same arithmetic) on one CPU lane, with the
    sweep's derivative ``mode`` and the ``integrator`` step."""
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
            return kernel_rollout.rollout_plain(model, integrator, True, pp,
                                                x0, us, xs, K)
        if kind == "sweep":
            return kernel_sweep.sweep_plain(model, integrator, pp, xs, xT, us,
                                            one, mode, use_limits)
        if kind == "linesearch":
            return kernel_rollout.linesearch_plain(
                model, integrator, True, pp, x0, us, xs, xT, K, k, K, k, al,
                torch.stack([-one, one]), one, one, one, 0.0)
        return kernel_iter.iteration_plain(
            model, integrator, True, pp, x0, xs, xT, us, k, K, one, one, one,
            al, mode, use_limits)
    return ops_per_step(at)


def model_cases(dev, name):
    """The model's four kernels (and, for the double integrator,
    omni_thruster and the last four models, the kernels without limits that
    their unconstrained paths run) at its path's shapes, on its path's x0,
    open-loop rollout and first gains; masks mixed. The sweep and
    iteration of thruster_ring16/20/24 on their first T_BACKWARD steps
    (their plain versions take seconds per step)."""
    model, params, cfg, T, dt, u0, draw = workload(name)
    B, A, n, m = B_M, len(cfg.alphas), model.n, model.m
    rng = np.random.default_rng(0)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pp = kernel_rollout.pack_params(params, dt, dev)
    x0 = f(draw(rng)).t().contiguous()
    us_in = f(u0)[:, :, None].expand(T, m, B).contiguous()
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    xs0, us0, xT0, c0 = kernel_rollout.rollout_packed(
        model, "euler", True, pp, x0, us_in, zeros(T, n, B),
        zeros(T, m, n, B))
    lam = torch.ones(B, device=dev)
    # the first iteration's gains, as the line search receives them
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
    Tb = T_BACKWARD.get(name, T)
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
    out = {}
    for label, (op, plain, args, kind, limits, unread) in cases.items():
        key = f"{label.split('/')[0]}/{name}" + (
            "" if limits else "/unconstrained")
        Tc = Tb if kind in ("sweep", "iteration") else T

        def ops(kind=kind, limits=limits, Tc=Tc):
            step, rest = lane_ops(model, params, kind, limits, A, dt)
            return step * Tc * B + rest * B

        out[key] = Case(op, plain, args, ops, f"at B={B} T={Tc} A={A}",
                        unread, dict(row=key, group="row",
                                     kernel=f"{kind}_kernel", model=name,
                                     limits=limits, T=Tc,
                                     effort=effort(kind, Tc, n, m)))
    return out


def run_model_path(dev, name, label, B=B_M, reps=1, warmup=True,
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
        out[f"{name}_card_vs_cpu"] = card_vs_cpu(name, T_c, iters,
                                                 CPU_RTOL[name])
    return out


def card_vs_cpu(name, T_c, iters, tol, lanes=4, integrator=None,
                **cfg_extra):
    """A short solve on the card against the plain path on the CPU (the
    path's first ``T_c`` steps), held to ``tol`` in relative cost (None:
    printed only). With ``integrator`` the problem is the CLI's one
    (cli_workload) with that integrator and ``cfg_extra``; without, the
    slice's workload."""
    if integrator is None:
        model, params, cfg, _T, dt, u0, draw = workload(name, B=lanes)
        x0 = draw(np.random.default_rng(9))
    else:
        model, params, cfg, _T, dt, u0, x0 = cli_workload(name, lanes)
        cfg = cfg.replace(integrator=integrator, **cfg_extra)
    cfg = cfg.replace(max_iter=iters)
    card = solve_batch_fused(model, params, cfg, dt, x0, u0[:T_c])
    cpu = solve_batch_fused(model, params, cfg, dt, x0, u0[:T_c],
                            device="cpu")
    c_card, c_cpu = card.cost.cpu().numpy(), cpu.cost.numpy()
    rel = float(np.max(np.abs(c_card - c_cpu) / np.abs(c_cpu)))
    route = "" if integrator is None else (
        f" {cfg.deriv_mode} {integrator}"
        + ("" if cfg.sweep_kernel == "merged" else f" {cfg.sweep_kernel}"))
    print(f"[slice] {name}{route}, {lanes} "
          f"lanes, T={T_c}, max_iter={iters}: card vs the plain path on the "
          f"CPU, max relative cost difference {rel:.2e} ("
          + (f"≤ {tol:g})" if tol is not None else
             "information, not asserted: the CPU's sin/cos ulps, scaled by "
             "the stencils' 1/(4·eps²))"))
    if not np.isfinite(c_card).all() or (tol is not None and rel > tol):
        raise AssertionError(f"{name}: the card left the CPU's solve")
    return dict(T=T_c, max_iter=iters, lanes=lanes, integrator=cfg.integrator,
                deriv_mode=cfg.deriv_mode, sweep_kernel=cfg.sweep_kernel,
                max_rel_cost_diff=rel)


def ptxas_table(log: str):
    """(kernel, model, limits) → registers, spills and source file, from
    ptxas -v. The build log heads each source's report with "ptxas log of
    <file>": each csrc/kernels_<model>.cu (and kernels_<model>_iteration.cu,
    where a model's iteration kernels compile apart, and the stencil and
    dual-number instantiations' kernels_<model>[_iteration]_fd.cu and
    kernels_<model>[_iteration]_jvp.cu) instantiates one model, and
    kernels.cu is acrobot's. derivs.cu instantiates the split sweep's models
    (the model read from the mangled name) and backward.cu one kernel per n
    (n = 2 filed under pendulum, n = 4 under acrobot and cartpole). The
    stencil and dual-number sweep, iteration and derivative kernels are
    filed as <kernel>_fd and <kernel>_jvp (the derivative kernel's jvp mode
    as derivs_kernel)."""
    table, entry, model, source = {}, None, "acrobot", None
    for line in log.splitlines():
        if line.startswith("ptxas log of "):
            source = line[len("ptxas log of "):].strip()
            stem = source.removesuffix(".cu")
            model = (stem[len("kernels_"):].removesuffix("_fd")
                     .removesuffix("_jvp").removesuffix("_iteration")
                     if stem.startswith("kernels_") else "acrobot")
        elif "Compiling entry function" in line:
            name = line.split("'")[1]
            kernel = next((k for k in KERNEL_NAMES if k in name), name)
            limits = None   # the sweep and iteration kernels' template flag
            models = [model]
            if kernel in ("sweep_kernel", "iteration_kernel"):
                limits = "Lb1E" in name
            if kernel != "backward_kernel":
                if "FiniteDiff" in name:   # the stencil instantiations
                    kernel += "_fd"
                elif "Jvp" in name and kernel != "derivs_kernel":
                    kernel += "_jvp"
            if kernel.startswith("derivs_kernel"):
                models = [next((mm for mm in ("pendulum", "cartpole")
                                if mm in name), "acrobot")]
            elif kernel == "backward_kernel":
                models = (["pendulum"] if "ILi2E" in name
                          else ["acrobot", "cartpole"])
            entry = {"source": f"ilqr_tpu_torch/csrc/{source}"}
            for mm in models:
                table[(kernel, mm, limits)] = entry
        elif entry is not None and "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            entry.update(stack_bytes=nums[0], spill_stores=nums[1],
                         spill_loads=nums[2])
        elif entry is not None and "Used" in line and "registers" in line:
            entry["registers"] = int(line.split("Used")[1].split()[0])
            entry = None
    return table


def run_slice(dev, rows):
    """Phase 8: the m = 2…4 slice; the launches of its paths go into
    ``rows``. Returns the results."""
    res = {}
    quad, (qx0, qcost, qwalls) = run_model_path(dev, "quadrotor",
                                                "quadrotor", reps=3)
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
    return res


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


def run_wide_slice(dev, rows):
    """Phase 9: the m ≥ 5 slice; the launches of its paths go into
    ``rows``. Returns the results."""
    res = {}

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
        dev, "thruster_ring", "thruster_ring (m = 12, full width)", reps=3)
    split_route(ring, "thruster_ring")
    model, params, cfg, T, dt, u0, draw = workload("thruster_ring")
    ring["profile"] = profile_solve(
        "thruster_ring", lambda x0, u0_: solve_batch_fused(
            model, params, cfg, dt, x0, u0_),
        float(np.median(rwalls)), draw(np.random.default_rng(2)), u0)
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
    res["card_vs_cpu"] = {name: card_vs_cpu(name, 10, 3, CPU_RTOL[name])
                          for name in ("omni_thruster", "thruster_ring")}
    return res


def run_cli_slice(dev, rows):
    """Phase 10: the last four models; the launches of their paths go into
    ``rows``. Returns the results."""
    res = {}
    for name in CLI_MODELS:
        headline = name == "power_mass"
        out, (x0, cost, walls) = run_model_path(
            dev, name, f"{name} (CLI problem, full width)",
            reps=3 if headline else 1)
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
        if headline:
            out["profile"] = profile_solve(
                name, lambda x0_, u0_: solve_batch_fused(
                    model, params, cfg, dt, x0_, u0_),
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
    res["card_vs_cpu"] = {name: card_vs_cpu(name, CLI_CPU_T, CLI_CPU_ITERS,
                                            CPU_RTOL[name])
                          for name in CLI_MODELS}
    return res


# ---------------------------------------------------------------------------
# The sixth slice: the reference's central stencils inside the merged sweep
# (deriv_mode="fd", the CLI's default linearization) and RK4 in the
# rollout, line-search, sweep and whole-iteration kernels. The full-width
# paths are the CLI's batch solves (ilqr_tpu/__main__.py:176-229) of each
# model's canonical problem (:93-147): x0 = the spec's x0 + 0.05·normal from
# default_rng(0) (:198-202), u0 = zeros (hover thrust for the quadrotor and
# omni_thruster), SolverConfig(deriv_mode="fd") with the CLI's defaults
# (the reference's unclamped rollout, limits ±box, boxqp "auto", fd_eps
# 1e-3, Euler), max_iter 100.

CLI_SPECS = {   # name: (T, dt, the spec's x0, hover u0)
    "acrobot": (499, 0.02, (0.0,) * 4, False),
    "double_integrator": (99, 0.02, (-1.0, 0.0, 0.0, -0.2), False),
    "point_mass_3d": (99, 0.02, (0.0,) * 6, False),
    "pendulum": (199, 0.02, (0.0,) * 2, False),
    "cartpole": (299, 0.02, (0.0,) * 4, False),
    "bicycle": (100, 0.05, (0.0,) * 4, False),
    "power_mass": (120, 0.05, (0.0,) * 4, False),
    "quadrotor": (120, 0.02, (0.0,) * 12, True),
    "omni_thruster": (120, 0.05, (0.0,) * 6, True),
    "free_flyer": (120, 0.05, (0.0,) * 6, False),
    "thruster_ring": (100, 0.05, (0.0,) * 6, False),
    "thruster_ring16": (100, 0.05, (0.0,) * 6, False),
    "thruster_ring20": (100, 0.05, (0.0,) * 6, False),
    "thruster_ring24": (100, 0.05, (0.0,) * 6, False),
}
# The models whose paths phases 8-10 also run without limits
FD_FREE = ("double_integrator", "omni_thruster", "pendulum", "cartpole",
           "bicycle", "power_mass")
FD_CAP_S = 20.0   # thruster_ring's fd path: max_iter cut if a solve would
#                   take longer
FD_EQ_T, FD_EQ_ITERS = T_EQ, ITER_EQ   # acrobot's merged-vs-split routes
FD_CPU_T, FD_CPU_ITERS = 30, 5         # the short card-against-CPU solves


def cli_workload(name, B=B_M):
    """(model, params, cfg, T, dt, u0 (T, m), x0 (B, n)) of the CLI's batch
    solve of ``name``'s canonical problem at --batch B (see above)."""
    T, dt, x0_spec, hover = CLI_SPECS[name]
    model = get_model(name)
    params = model.default_params()
    if hover:
        mod = quadrotor if name == "quadrotor" else omni_thruster
        u0 = np.tile(mod.hover_control(params).numpy()[None], (T, 1))
    else:
        u0 = np.zeros((T, model.m))
    rng = np.random.default_rng(0)
    x0 = (np.asarray(x0_spec, np.float32)[None] + np.float32(0.05)
          * rng.normal(size=(B, model.n)).astype(np.float32))
    cfg = SolverConfig(deriv_mode="fd", clamp_forward=False,
                       use_control_limits=True, max_iter=CLI_ITERS)
    return model, params, cfg, T, dt, u0.astype(np.float32), x0


def fd_cases(dev, name):
    """``name``'s stencil sweep and iteration kernels (Euler; for acrobot
    and the quadrotor, whose paths run RK4, also RK4) and its rollout and
    line search with the RK4 step, at its CLI path's shapes (B = 8192 for
    acrobot, else 1024; the sweep and iteration of thruster_ring16/20/24 on
    their first T_BACKWARD steps), on that path's x0, its unclamped
    open-loop rollout and first stencil gains; masks mixed. The RK4 cases
    are readings of a row's kernel (group "rk4")."""
    B = B_MAIN if name == "acrobot" else B_M
    model, params, cfg, T, dt, u0, x0_np = cli_workload(name, B)
    A, n, m = len(cfg.alphas), model.n, model.m
    rng = np.random.default_rng(0)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pp = kernel_rollout.pack_params(params, dt, dev)
    x0 = f(x0_np).t().contiguous()
    zeros = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=dev)
    xs0, us0, xT0, c0 = kernel_rollout.rollout_packed(
        model, "euler", False, pp, x0,
        f(u0)[:, :, None].expand(T, m, B).contiguous(), zeros(T, n, B),
        zeros(T, m, n, B))
    lam = torch.ones(B, device=dev)
    k1, K1, dv1, _d, _g = kernel_sweep.sweep_packed(model, "euler", pp, xs0,
                                                    xT0, us0, lam, "fd")
    live, gate, keep = (f(rng.uniform(size=B) > 0.5) for _ in range(3))
    alphas = f(cfg.alphas)
    xsr = xs0 + f(0.01 * rng.normal(size=(T, n, B)))
    Kr = f(0.05 * rng.normal(size=(T, m, n, B)))
    uff = us0 + f(0.2 * rng.normal(size=(T, m, B)))
    kold, Kold = f(rng.normal(size=(T, m, B))), f(rng.normal(size=(T, m, n,
                                                                   B)))
    # the sweep and iteration on the first Tb steps (x_Tb the terminal)
    Tb = T_BACKWARD.get(name, T)
    xsb, usb = xs0[:Tb].contiguous(), us0[:Tb].contiguous()
    xTb = xT0 if Tb == T else xs0[Tb].contiguous()
    kob, Kob = kold[:Tb].contiguous(), Kold[:Tb].contiguous()
    old_b, old = nbytes(kob, Kob), nbytes(kold, Kold)

    def sweep_case(integ, limits):
        return (kernel_sweep.sweep_packed, kernel_sweep.sweep_plain,
                (model, integ, pp, xsb, xTb, usb, lam, "fd", limits),
                "sweep", limits, integ, Tb, None)

    def iteration_case(integ, limits):
        return (kernel_iter.iteration_packed, kernel_iter.iteration_plain,
                (model, integ, False, pp, x0, xsb, xTb, usb, kob, Kob, lam,
                 c0, live, alphas, "fd", limits, cfg.z_min, cfg.tol_grad,
                 cfg.lambda_grad_term),
                "iteration", limits, integ, Tb,
                lambda got: old_b * ((got[10] < 0.5) & (live > 0.5))
                .float().mean().item())

    rows = {f"sweep_packed/{name}/fd": sweep_case("euler", True),
            f"iteration_packed/{name}/fd": iteration_case("euler", True)}
    if name in FD_FREE:
        free = "sweep" if m * n >= 32 else "iteration"
        rows[f"{free}_packed/{name}/fd/unconstrained"] = (
            sweep_case if free == "sweep" else iteration_case)("euler", False)
    rk4 = {
        f"rollout_packed/{name}": (
            kernel_rollout.rollout_packed, kernel_rollout.rollout_plain,
            (model, "rk4", False, pp, x0, uff, xsr, Kr), "rollout", True,
            "rk4", T, None),
        f"linesearch_packed/{name}": (
            kernel_rollout.linesearch_packed, kernel_rollout.linesearch_plain,
            (model, "rk4", False, pp, x0, us0, xs0, xT0, K1, k1, Kold, kold,
             alphas, dv1, c0, gate, keep, cfg.z_min), "linesearch", True,
            "rk4", T, lambda got: old * (keep > 0.5).float().mean().item())}
    if name in ("acrobot", "quadrotor"):   # their paths run RK4
        rk4[f"sweep_packed/{name}/fd"] = sweep_case("rk4", True)
    if name == "acrobot":
        rk4[f"iteration_packed/{name}/fd"] = iteration_case("rk4", True)

    out = {}
    for group, cases in (("row", rows), ("rk4", rk4)):
        for key, (op, plain, args, kind, limits, integ, Tc,
                  unread) in cases.items():
            mode = "fd" if kind in ("sweep", "iteration") else "jvp"

            def ops(kind=kind, limits=limits, integ=integ, Tc=Tc, mode=mode):
                step, rest = lane_ops(model, params, kind, limits, A, dt,
                                      mode, integ)
                return step * Tc * B + rest * B

            meta = dict(row=key, group=group,
                        kernel=f"{kind}_kernel" + ("_fd" if mode == "fd"
                                                   else ""),
                        model=name, limits=limits, T=Tc,
                        effort=effort(kind, Tc, n, m) * (
                            4 if integ == "rk4" else 1))
            if group == "row":
                stem = ("kernels_quadrotor_iteration_fd.cu"
                        if kind == "iteration" and name == "quadrotor"
                        else f"kernels_{name}_fd.cu")
                meta["source"] = f"ilqr_tpu_torch/csrc/{stem}"
            out[f"{key} ({integ})"] = Case(
                op, plain, args, ops, f"at B={B} T={Tc} A={A}", unread, meta)
    return out


def run_fd_path(dev, name, label, B=B_M, reps=1, warmup=False, profile=False,
                **cfg_extra):
    """One CLI batch solve through solve_batch_fused: an untimed warm-up
    solve (unless ``warmup`` is False), then ``reps`` timed solves of the
    same problem, each ending in a full device-to-host copy, with the launch
    counts of the first (set to 0 just before it, read just after). Every
    cost finite, every lane at or below its own initial rollout's cost."""
    model, params, cfg, T, dt, u0, x0 = cli_workload(name, B)
    cfg = cfg.replace(**cfg_extra)
    tag = "fd" if cfg.deriv_mode == "fd" else "jvp"
    pp = kernel_rollout.pack_params(params, dt, dev)
    zeros = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=dev)
    init = kernel_rollout.rollout_packed(
        model, cfg.integrator, cfg.clamp_forward, pp,
        torch.as_tensor(x0, device=dev).t().contiguous(),
        torch.as_tensor(u0, device=dev)[:, :, None].expand(
            T, model.m, B).contiguous(),
        zeros(T, model.n, B), zeros(T, model.m, model.n, B))[3].cpu().numpy()
    if warmup:
        solve_batch_fused(model, params, cfg, dt, x0, u0)
        torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        reset_launch_counts()
        fused._host_any.syncs = 0
        fused._iteration.calls = 0
        fused._iteration.retried = 0
        t0 = time.perf_counter()
        sol = solve_batch_fused(model, params, cfg, dt, x0, u0)
        host = {k: v.cpu() for k, v in sol._asdict().items()}  # full D2H
        runs.append(dict(wall=time.perf_counter() - t0, counts=launch_counts(),
                         host_iters=fused._iteration.calls,
                         syncs=fused._host_any.syncs,
                         retried=fused._iteration.retried, sol=host))
    walls = [r["wall"] for r in runs]
    sol, c, its = runs[0]["sol"], runs[0]["counts"], runs[0]["host_iters"]
    cost = sol["cost"].numpy()
    iters = sol["iterations"].numpy()
    hist = {int(k): int(v) for k, v in
            zip(*np.unique(sol["reason"].numpy(), return_counts=True))}
    wall = float(np.median(walls))
    out = dict(
        B=B, T=T, dt=dt, max_iter=cfg.max_iter, integrator=cfg.integrator,
        deriv_mode=cfg.deriv_mode, sweep_kernel=cfg.sweep_kernel,
        use_control_limits=cfg.use_control_limits,
        iter_kernel=cfg.iter_kernel, solves_per_s=B / wall, wall_s=walls,
        mean_cost=float(cost.mean()), init_mean_cost=float(init.mean()),
        mean_iters=float(iters.mean()), max_iters=int(iters.max()),
        reason_hist=hist, launches=c, host_iterations=its,
        ms_per_iteration=wall * 1e3 / max(1, its),
        syncs_per_iteration=runs[0]["syncs"] / max(1, its),
        retried_share=runs[0]["retried"] / max(1, its),
        lanes_below_initial=float(np.mean(cost < init)),
        cost_quantiles={q: float(np.percentile(cost, q))
                        for q in (50, 90, 99, 100)},
        first_64_lanes_mean_cost=float(cost[:64].mean()))
    if name == "acrobot":
        # each of the first 64 lanes, beside the plain path's on the CPU
        # (tests/test_torch_cli_predict.py solves the same lanes there)
        out["first_64_lanes_costs"] = [float(v) for v in cost[:64]]
        print(f"[{tag}] {label}: the first 64 lanes' costs "
              f"{[round(float(v), 4) for v in cost[:64]]}")
    print(f"[{tag}] {label}: B={B} T={T} max_iter={cfg.max_iter} "
          f"{cfg.integrator}: {out['solves_per_s']:.1f} solves/s (median of "
          f"{reps}; {nvidia_smi()}), {out['ms_per_iteration']:.3f} "
          f"ms/iteration over {its} host iterations, mean_cost "
          f"{out['mean_cost']:.4f} (initial rollout {out['init_mean_cost']:.4f}"
          f"), mean_iters {out['mean_iters']:.2f} (largest "
          f"{out['max_iters']}), reasons {hist}, "
          f"{out['lanes_below_initial']:.4f} of the lanes below their initial "
          f"cost, cost quantiles (50, 90, 99, 100) "
          f"{list(out['cost_quantiles'].values())}, the first 64 lanes' mean "
          f"{out['first_64_lanes_mean_cost']:.4f}, launches {c}, host "
          f"syncs/iteration "
          f"{out['syncs_per_iteration']:.3f}, iterations that retried "
          f"{out['retried_share']:.3f}")
    if not np.all(np.isfinite(cost)):
        raise AssertionError(f"{label}: non-finite costs")
    if not np.all(cost <= init):
        raise AssertionError(f"{label}: a lane ended above its initial "
                             f"rollout's cost")
    if c["rollout_packed"] != 1:
        raise AssertionError(f"{label}: rollout_packed ran "
                             f"{c['rollout_packed']} times in one solve")
    route = ("iteration_packed" if fused._use_iter_kernel(model, cfg)
             else "backward_sweep_packed" if cfg.sweep_kernel == "split"
             else "sweep_packed")
    if c[route] < its:
        raise AssertionError(f"{label}: {route} ran fewer launches than "
                             f"iterations: {c}")
    if profile:
        out["profile"] = profile_solve(
            label, lambda x0_, u0_: solve_batch_fused(model, params, cfg, dt,
                                                      x0_, u0_),
            wall, x0, u0)
    return out, cost


def fd_solve(dev, name, label, ref_cost=None, B=B_M, T=None,
             assert_gauge=True, **cfg_extra):
    """The CLI problem of ``name`` (its first T steps) through the route of
    ``cfg_extra``, launch counts set to 0 just before and read just after;
    held against ``ref_cost`` under the gauge where one is given (printed
    only with ``assert_gauge`` False). Returns (readings, costs)."""
    model, params, cfg, T_full, dt, u0, x0 = cli_workload(name, B)
    T = T_full if T is None else T
    cfg = cfg.replace(**cfg_extra)
    tag = "fd" if cfg.deriv_mode == "fd" else "jvp"
    reset_launch_counts()
    sol = solve_batch_fused(model, params, cfg, dt, x0, u0[:T])
    cost = sol.cost.cpu().numpy()
    out = dict(launches=launch_counts(), T=T, max_iter=cfg.max_iter,
               mean_cost=float(cost.mean()))
    if not np.isfinite(cost).all():
        raise AssertionError(f"{label}: non-finite costs")
    if ref_cost is None:
        print(f"[{tag}] {label} at B={B} T={T}: mean_cost {cost.mean():.4f}, "
              f"launches {out['launches']}")
        return out, cost
    p99, mx = gauge(cost, ref_cost)
    out.update(p99=p99, max=mx)
    if not assert_gauge:
        print(f"[{tag}] {label} at B={B} T={T} max_iter={cfg.max_iter}: "
              f"per-lane |c1-c2|/(1+|c2|) p99 {p99:.3e}, max {mx:.3e} "
              f"(information, not asserted)")
        return out, cost
    print(f"[{tag}] {label} at B={B} T={T}: per-lane |c1-c2|/(1+|c2|) p99 "
          f"{p99:.3e} (≤ {GAUGE_P99:g}), max {mx:.3e} (≤ {GAUGE_MAX:g}); "
          f"launches {out['launches']}")
    if not (p99 <= GAUGE_P99 and mx <= GAUGE_MAX):
        raise AssertionError(f"{label} outside the gauge")
    return out, cost


def run_fd_slice(dev, rows, rk4):
    """Phase 11: the stencils in the fused kernels and RK4; the launches of
    its paths go into ``rows`` and the RK4 readings ``rk4``. Returns the
    results."""
    res = {}

    def record(key, counts, mode="fd"):
        """The launches on a path of a row (mode "fd") or of an RK4 reading
        (mode "rk4", the row's rk4_launches)."""
        (rows if mode == "fd" else rk4)[key]["launches"] = counts[
            key.split("/")[0]]

    # (b) the headline: the CLI's default batch solve of acrobot, and its
    # RK4 twin; their split routes against the merged ones at T = FD_EQ_T
    t0 = time.perf_counter()
    for integ in ("euler", "rk4"):   # phase 3 warmed the kernels up
        out, _c = run_fd_path(
            dev, "acrobot", f"acrobot {integ} (the CLI's batch solve)",
            B=B_MAIN, profile=integ == "euler", integrator=integ)
        short = dict(B=B_SPLIT, T=FD_EQ_T, max_iter=FD_EQ_ITERS,
                     integrator=integ)
        merged, ref = fd_solve(dev, "acrobot", f"acrobot {integ} merged",
                               **short)
        out["split_route"], _c = fd_solve(
            dev, "acrobot", f"acrobot {integ} split route vs merged", ref,
            iter_kernel="split", **short)
        res[f"acrobot_{integ}"] = out
        split = out["split_route"]["launches"]
        if integ == "euler":
            record("iteration_packed/acrobot/fd", out["launches"])
            record("sweep_packed/acrobot/fd", split)
        else:
            for key in ("rollout_packed/acrobot",
                        "iteration_packed/acrobot/fd"):
                record(key, out["launches"], "rk4")
            for key in ("sweep_packed/acrobot/fd",
                        "linesearch_packed/acrobot"):
                record(key, split, "rk4")
    print(f"[time] phase 11b (acrobot) {time.perf_counter() - t0:.1f} s",
          flush=True)

    # (c) the quadrotor's CLI problem with fd and RK4 (the split iteration)
    # and its merged route
    t0 = time.perf_counter()
    quad, qcost = run_fd_path(dev, "quadrotor", "quadrotor fd + rk4",
                              integrator="rk4")
    # the merged route at a cut depth (it runs the split route's
    # arithmetic, one launch where the split takes two)
    _s, qcost = fd_solve(dev, "quadrotor", f"quadrotor rk4 at max_iter "
                         f"{SHORT_ITERS}", max_iter=SHORT_ITERS,
                         integrator="rk4")
    quad["merged_route"], _c = fd_solve(
        dev, "quadrotor", "quadrotor rk4 merged route vs split", qcost,
        iter_kernel="merged", integrator="rk4", max_iter=SHORT_ITERS)
    for key in ("rollout_packed/quadrotor", "linesearch_packed/quadrotor",
                "sweep_packed/quadrotor/fd"):
        record(key, quad["launches"], "rk4")
    # the path's stencil sweep kernel, RK4 its mode
    record("sweep_packed/quadrotor/fd", quad["launches"])
    record("iteration_packed/quadrotor/fd",
           quad["merged_route"]["launches"])
    res["quadrotor_rk4"] = quad
    print(f"[time] phase 11c (quadrotor) {time.perf_counter() - t0:.1f} s",
          flush=True)

    # (d) the other twelve models' CLI problems, fd and Euler; each route
    # against the other, and without limits where phases 8-10 run so
    t0 = time.perf_counter()
    for name in CLI_SPECS:
        if name in ("acrobot", "quadrotor"):
            continue
        model = get_model(name)
        merged_auto = model.m * model.n < 32
        other = dict(iter_kernel="split" if merged_auto else "merged")
        label = f"{name} fd (the CLI's batch solve)"
        if name in ("thruster_ring16", "thruster_ring20", "thruster_ring24"):
            out, cost = fd_solve(dev, name, f"{name} fd at max_iter "
                                 f"{SHORT_ITERS} (cut from {CLI_ITERS})",
                                 max_iter=SHORT_ITERS)
            out["other_route"], _c = fd_solve(
                dev, name, f"{name} merged route vs split", cost,
                max_iter=SHORT_ITERS, **other)
        elif name in ("omni_thruster", "free_flyer", "thruster_ring"):
            m_, p_, cfg, T, dt, u0, x0 = cli_workload(name)
            pp = kernel_rollout.pack_params(p_, dt, dev)
            B = len(x0)
            z = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=dev)
            xs0, us0, xT0, _c = kernel_rollout.rollout_packed(
                m_, "euler", False, pp,
                torch.as_tensor(x0, device=dev).t().contiguous(),
                torch.as_tensor(u0, device=dev)[:, :, None].expand(
                    T, m_.m, B).contiguous(), z(T, m_.n, B),
                z(T, m_.m, m_.n, B))
            sweep_ms = time_ms(lambda: kernel_sweep.sweep_packed(
                m_, "euler", pp, xs0, xT0, us0, torch.ones(B, device=dev),
                "fd"), reps=1)
            cap = min(CLI_ITERS, max(SHORT_ITERS, int(
                FD_CAP_S * 1e3 / (1.5 * sweep_ms))))
            print(f"[fd] {name}: one stencil sweep {sweep_ms:.1f} ms "
                  f"at B={B} T={T}; max_iter {cap}"
                  + ("" if cap == CLI_ITERS else
                     f" (cut from {CLI_ITERS} to keep one solve under "
                     f"{FD_CAP_S:g} s)"))
            out, _cost = run_fd_path(dev, name, label, max_iter=cap)
            out["sweep_ms_per_launch"] = sweep_ms
            # the merged route at a cut depth: it runs the split route's
            # arithmetic, one launch where the split takes two
            split_short, cost = fd_solve(dev, name, f"{name} at max_iter "
                                         f"{SHORT_ITERS}",
                                         max_iter=SHORT_ITERS)
            out["other_route"], _c = fd_solve(
                dev, name, f"{name} merged route vs split", cost,
                max_iter=SHORT_ITERS, **other)
        else:
            out, cost = run_fd_path(dev, name, label)
            out["other_route"], _c = fd_solve(
                dev, name, f"{name} {other['iter_kernel']} route vs auto",
                cost, **other)
        auto_key = ("iteration_packed" if merged_auto else "sweep_packed")
        other_key = ("sweep_packed" if merged_auto else "iteration_packed")
        record(f"{auto_key}/{name}/fd", out["launches"])
        record(f"{other_key}/{name}/fd", out["other_route"]["launches"])
        if name in FD_FREE:
            free, _c = run_fd_path(dev, name, f"{name} fd without limits",
                                   use_control_limits=False)
            record(f"{auto_key}/{name}/fd/unconstrained", free["launches"])
            out["unconstrained"] = free
        res[name] = out
    print(f"[time] phase 11d (the twelve CLI problems) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (e) short solves on the card against the plain path on the CPU
    res["card_vs_cpu"] = {
        f"{name}_{integ}": card_vs_cpu(name, FD_CPU_T, FD_CPU_ITERS, tol,
                                       integrator=integ)
        for name, integ, tol in (("power_mass", "euler", 1e-4),
                                 ("double_integrator", "rk4", 1e-4),
                                 ("acrobot", "rk4", None))}
    return res


# ---------------------------------------------------------------------------
# The seventh slice: the dual-number slice. The sweep's in-kernel JVP route
# (deriv_mode="analytic" with RK4: exact derivatives of the RK4 step by the
# dual numbers of csrc/dual.cuh, csrc/jvp.cuh, the sweep::Jvp policy) for
# all 14 models, and the split sweep (sweep_kernel="split":
# derivs_packed, then backward_sweep_packed) for acrobot, pendulum and
# cartpole, in both derivative modes and with either step. The full-width
# paths are the CLI's batch solves (cli_workload) with
# --deriv-mode analytic --integrator-scheme rk4 and --sweep-kernel split.

SPLIT_MODELS = ("acrobot", "pendulum", "cartpole")
# The split sweep against the merged one: its backward kernel is the JAX
# package's own arithmetic (an asymmetric Vxx, pallas_backward.py), not the
# merged step's, so the two routes round differently. With exact
# derivatives they hold the gauge at ITER_EQ iterations; with the f32
# stencils every ulp of the trajectory moves the next iteration's Hessians
# by ulp(cost)/(4·eps²), so the fd routes agree only on their first
# iteration, where they share the trajectory (ROADMAP.md §C).
SPLIT_FD_EQ_ITERS = 1


def jvp_cases(dev, name):
    """``name``'s dual-number sweep and iteration kernels with the RK4 step
    (and without limits, where phase 12 runs the path so) at its CLI path's
    shapes (B = 8192 for acrobot, else 1024; the sweep and iteration of
    thruster_ring16/20/24 on their first T_BACKWARD steps), on that path's
    x0, its unclamped open-loop RK4 rollout and λ = 1; masks mixed."""
    B = B_MAIN if name == "acrobot" else B_M
    model, params, cfg, T, dt, u0, x0_np = cli_workload(name, B)
    A, n, m = len(cfg.alphas), model.n, model.m
    rng = np.random.default_rng(4)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pp = kernel_rollout.pack_params(params, dt, dev)
    x0 = f(x0_np).t().contiguous()
    zeros = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=dev)
    xs0, us0, xT0, c0 = kernel_rollout.rollout_packed(
        model, "rk4", False, pp, x0,
        f(u0)[:, :, None].expand(T, m, B).contiguous(), zeros(T, n, B),
        zeros(T, m, n, B))
    lam = torch.ones(B, device=dev)
    live = f(rng.uniform(size=B) > 0.5)
    alphas = f(cfg.alphas)
    Tb = T_BACKWARD.get(name, T)
    xsb, usb = xs0[:Tb].contiguous(), us0[:Tb].contiguous()
    xTb = xT0 if Tb == T else xs0[Tb].contiguous()
    kob = f(rng.normal(size=(Tb, m, B)))
    Kob = f(rng.normal(size=(Tb, m, n, B)))
    old_b = nbytes(kob, Kob)

    def sweep_case(limits):
        return (kernel_sweep.sweep_packed, kernel_sweep.sweep_plain,
                (model, "rk4", pp, xsb, xTb, usb, lam, "jvp", limits),
                "sweep", limits, None)

    def iteration_case(limits):
        return (kernel_iter.iteration_packed, kernel_iter.iteration_plain,
                (model, "rk4", False, pp, x0, xsb, xTb, usb, kob, Kob, lam,
                 c0, live, alphas, "jvp", limits, cfg.z_min, cfg.tol_grad,
                 cfg.lambda_grad_term),
                "iteration", limits,
                lambda got: old_b * ((got[10] < 0.5) & (live > 0.5))
                .float().mean().item())

    cases = {f"sweep_packed/{name}/jvp": sweep_case(True),
             f"iteration_packed/{name}/jvp": iteration_case(True)}
    if name in FD_FREE:
        free = "sweep" if m * n >= 32 else "iteration"
        cases[f"{free}_packed/{name}/jvp/unconstrained"] = (
            sweep_case if free == "sweep" else iteration_case)(False)
    out = {}
    for key, (op, plain, args, kind, limits, unread) in cases.items():
        def ops(kind=kind, limits=limits):
            step, rest = lane_ops(model, params, kind, limits, A, dt, "jvp",
                                  "rk4")
            return step * Tb * B + rest * B

        stem = ("kernels_quadrotor_iteration_jvp.cu"
                if kind == "iteration" and name == "quadrotor"
                else f"kernels_{name}_jvp.cu")
        meta = dict(row=key, group="row", kernel=f"{kind}_kernel_jvp",
                    model=name, limits=limits, T=Tb,
                    effort=8 * effort(kind, Tb, n, m),
                    source=f"ilqr_tpu_torch/csrc/{stem}")
        out[f"{key} (rk4)"] = Case(op, plain, args, ops,
                                   f"at B={B} T={Tb} A={A}", unread, meta)
    return out


def split_cases(dev, name):
    """The split sweep's kernels of ``name`` at its CLI path's shapes
    (acrobot B = 8192, T = 499; else B = 1024 and the CLI's T), on that
    path's x0 and unclamped open-loop rollout: derivs_packed with the Euler
    step in jvp mode (the row) and fd mode (its fd_* fields), each with an
    RK4 reading (rk4_*, rk4_fd_*), and backward_sweep_packed on the jvp
    derivatives (n = 2 for pendulum, n = 4 for cartpole). Acrobot's rows
    are phase 3's flagship ones; here only its RK4 readings."""
    B = B_MAIN if name == "acrobot" else B_M
    model, params, cfg, T, dt, u0, x0_np = cli_workload(name, B)
    n, m = model.n, model.m
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pp = kernel_rollout.pack_params(params, dt, dev)
    zeros = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=dev)
    xs0, us0, xT0, _c = kernel_rollout.rollout_packed(
        model, "euler", False, pp, f(x0_np).t().contiguous(),
        f(u0)[:, :, None].expand(T, m, B).contiguous(), zeros(T, n, B),
        zeros(T, m, n, B))
    xs_full = torch.cat([xs0, xT0[None]]).contiguous()
    pp_cpu = kernel_rollout.pack_params(params, dt)
    lane_rng = np.random.default_rng(3)

    def lane_inputs(t):
        xs = torch.as_tensor(0.3 * lane_rng.normal(size=(t + 1, n, 1)),
                             dtype=torch.float32)
        us = torch.as_tensor(lane_rng.normal(size=(t, m, 1)),
                             dtype=torch.float32)
        return xs, us

    def derivs_ops(mode, integ):
        step, rest = ops_per_step(lambda t: kernel_derivs.derivs_plain(
            model, integ, pp_cpu, *lane_inputs(t), mode=mode))
        return step * T * B + rest * B

    out = {}
    src = "ilqr_tpu_torch/csrc/derivs.cu"
    readings = [("jvp", "rk4", "rk4"), ("fd", "rk4", "rk4_fd")]
    if name != "acrobot":
        readings = [("jvp", "euler", "row"), ("fd", "euler", "fd_of")] + (
            readings)
    for mode, integ, group in readings:
        meta = dict(row=f"derivs_packed/{name}", group=group,
                    kernel="derivs_kernel", model=name, limits=True, T=T,
                    effort=effort("derivs", T, n, m)
                    * (4 if integ == "rk4" else 1), source=src)
        out[f"derivs_packed/{name} ({mode}, {integ})"] = Case(
            kernel_derivs.derivs_packed, kernel_derivs.derivs_plain,
            (model, integ, pp, xs_full, us0, mode),
            lambda mode=mode, integ=integ: derivs_ops(mode, integ),
            f"at B={B} T={T}", None, meta)
    if name == "acrobot":
        return out

    fx, fu, cx, cu, cxx, cxu, cuu = kernel_derivs.derivs_packed(
        model, "euler", pp, xs_full, us0)
    p, _dt = kernel_rollout.unpack_params(pp)
    args = (fx, fu[:, :, 0], cx[:-1], cu[:, 0], cxx[:-1], cxu[:, :, 0],
            cuu[:, 0, 0], p.u_min[0] - us0[:, 0], p.u_max[0] - us0[:, 0],
            torch.ones(B, device=dev), cx[-1], cxx[-1])
    args = tuple(a.contiguous() for a in args)
    lo, hi = float(p.u_min[0]), float(p.u_max[0])

    def backward_at(t):
        xs, us = lane_inputs(t)
        d = kernel_derivs.derivs_plain(model, "euler", pp_cpu, xs, us)
        return kernel_backward.backward_plain(
            d[0], d[1][:, :, 0], d[2][:-1], d[3][:, 0], d[4][:-1],
            d[5][:, :, 0], d[6][:, 0, 0], lo - us[:, 0], hi - us[:, 0],
            torch.ones(1), d[2][-1], d[4][-1])

    def backward_ops():
        step_all, rest_all = ops_per_step(backward_at)
        step_d, rest_d = ops_per_step(lambda t: kernel_derivs.derivs_plain(
            model, "euler", pp_cpu, *lane_inputs(t)))
        return (step_all - step_d) * T * B + (rest_all - rest_d) * B

    out[f"backward_sweep_packed/{name}"] = Case(
        kernel_backward.backward_sweep_packed, kernel_backward.backward_plain,
        args, backward_ops, f"at B={B} T={T} n={n}", None,
        dict(row=f"backward_sweep_packed/{name}", group="row",
             kernel="backward_kernel", model=name, limits=True, T=T,
             effort=effort("backward", T, n, m),
             source="ilqr_tpu_torch/csrc/backward.cu"))
    return out


def run_jvp_slice(dev, rows, rk4):
    """Phase 12: the in-kernel JVP route (analytic + RK4) and the split
    sweep on the CLI's problems; the launches of its paths go into ``rows``
    and the RK4 readings ``rk4``. Returns the results."""
    res = {}
    jvp = dict(deriv_mode="analytic", integrator="rk4")

    def record(key, counts, reading=False):
        (rk4 if reading else rows)[key]["launches"] = counts[
            key.split("/")[0]]

    # (a) the headline: the CLI's analytic + RK4 batch solve of acrobot;
    # its split iteration against the whole-iteration kernel at T = T_EQ
    t0 = time.perf_counter()
    out, _c = run_fd_path(dev, "acrobot",
                          "acrobot analytic + rk4 (the CLI's batch solve)",
                          B=B_MAIN, profile=True, **jvp)
    short = dict(B=B_SPLIT, T=T_EQ, max_iter=ITER_EQ, **jvp)
    _m, ref = fd_solve(dev, "acrobot", "acrobot analytic rk4 merged", **short)
    out["split_iteration"], _c = fd_solve(
        dev, "acrobot", "acrobot analytic rk4 split iteration vs merged", ref,
        iter_kernel="split", **short)
    record("iteration_packed/acrobot/jvp", out["launches"])
    record("sweep_packed/acrobot/jvp", out["split_iteration"]["launches"])
    res["acrobot"] = out
    print(f"[time] phase 12a (acrobot) {time.perf_counter() - t0:.1f} s",
          flush=True)

    # (b) the quadrotor's CLI problem (the split iteration: the JVP sweep at
    # full width) and its merged route at a cut depth
    t0 = time.perf_counter()
    quad, _c = run_fd_path(dev, "quadrotor", "quadrotor analytic + rk4",
                           **jvp)
    _s, qcost = fd_solve(dev, "quadrotor", f"quadrotor analytic rk4 at "
                         f"max_iter {SHORT_ITERS}", max_iter=SHORT_ITERS,
                         **jvp)
    quad["merged_route"], _c = fd_solve(
        dev, "quadrotor", "quadrotor analytic rk4 merged route vs split",
        qcost, iter_kernel="merged", max_iter=SHORT_ITERS, **jvp)
    record("sweep_packed/quadrotor/jvp", quad["launches"])
    record("iteration_packed/quadrotor/jvp", quad["merged_route"]["launches"])
    res["quadrotor"] = quad
    print(f"[time] phase 12b (quadrotor) {time.perf_counter() - t0:.1f} s",
          flush=True)

    # (c) the other twelve models' CLI problems; each route against the
    # other, and without limits where phase 11 runs so
    t0 = time.perf_counter()
    for name in CLI_SPECS:
        if name in ("acrobot", "quadrotor"):
            continue
        model = get_model(name)
        merged_auto = model.m * model.n < 32
        other = dict(iter_kernel="split" if merged_auto else "merged")
        label = f"{name} analytic + rk4 (the CLI's batch solve)"
        if name in ("thruster_ring16", "thruster_ring20", "thruster_ring24"):
            out, cost = fd_solve(dev, name, f"{name} analytic rk4 at max_iter "
                                 f"{SHORT_ITERS} (cut from {CLI_ITERS})",
                                 max_iter=SHORT_ITERS, **jvp)
            out["other_route"], _c = fd_solve(
                dev, name, f"{name} merged route vs split", cost,
                max_iter=SHORT_ITERS, **other, **jvp)
        else:
            cap = CLI_ITERS
            if name == "thruster_ring":
                m_, p_, cfg, T, dt, u0, x0 = cli_workload(name)
                pp = kernel_rollout.pack_params(p_, dt, dev)
                B = len(x0)
                z = lambda *sh: torch.zeros(sh, dtype=torch.float32,
                                            device=dev)
                xs0, us0, xT0, _c = kernel_rollout.rollout_packed(
                    m_, "rk4", False, pp,
                    torch.as_tensor(x0, device=dev).t().contiguous(),
                    torch.as_tensor(u0, device=dev)[:, :, None].expand(
                        T, m_.m, B).contiguous(), z(T, m_.n, B),
                    z(T, m_.m, m_.n, B))
                sweep_ms = time_ms(lambda: kernel_sweep.sweep_packed(
                    m_, "rk4", pp, xs0, xT0, us0, torch.ones(B, device=dev),
                    "jvp"), reps=1)
                cap = min(CLI_ITERS, max(SHORT_ITERS, int(
                    FD_CAP_S * 1e3 / (1.5 * sweep_ms))))
                print(f"[jvp] {name}: one JVP sweep {sweep_ms:.1f} ms at "
                      f"B={B} T={T}; max_iter {cap}"
                      + ("" if cap == CLI_ITERS else
                         f" (cut from {CLI_ITERS} to keep one solve under "
                         f"{FD_CAP_S:g} s)"))
            out, cost = run_fd_path(dev, name, label, max_iter=cap, **jvp)
            # the m·n ≥ 32 models' merged route at a cut depth: it runs the
            # split route's arithmetic, one launch where the split takes two
            depth = CLI_ITERS if merged_auto else SHORT_ITERS
            if depth != cap:
                _s, cost = fd_solve(dev, name, f"{name} at max_iter {depth}",
                                    max_iter=depth, **jvp)
            out["other_route"], _c = fd_solve(
                dev, name, f"{name} {other['iter_kernel']} route vs auto",
                cost, max_iter=depth, **other, **jvp)
        auto_key = ("iteration_packed" if merged_auto else "sweep_packed")
        other_key = ("sweep_packed" if merged_auto else "iteration_packed")
        record(f"{auto_key}/{name}/jvp", out["launches"])
        record(f"{other_key}/{name}/jvp", out["other_route"]["launches"])
        if name in FD_FREE:
            free, _c = run_fd_path(dev, name, f"{name} analytic + rk4 "
                                   "without limits",
                                   use_control_limits=False, **jvp)
            record(f"{auto_key}/{name}/jvp/unconstrained", free["launches"])
            out["unconstrained"] = free
        res[name] = out
    print(f"[time] phase 12c (the twelve CLI problems) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (d) the split sweep: pendulum and cartpole (analytic + Euler, analytic
    # + RK4, fd + Euler) and acrobot (analytic + RK4, fd + RK4) at full
    # width, each against the merged route under the gauge
    t0 = time.perf_counter()
    split = dict(sweep_kernel="split")
    for name, routes in (("pendulum", (("analytic", "euler"),
                                       ("analytic", "rk4"),
                                       ("fd", "euler"))),
                         ("cartpole", (("analytic", "euler"),
                                       ("analytic", "rk4"),
                                       ("fd", "euler"))),
                         ("acrobot", (("analytic", "rk4"), ("fd", "rk4")))):
        B = B_MAIN if name == "acrobot" else B_M
        for dm, integ in routes:
            cfg_r = dict(deriv_mode=dm, integrator=integ)
            out, cost = run_fd_path(
                dev, name, f"{name} {dm} + {integ}, split sweep", B=B,
                **split, **cfg_r)
            # the gauge: acrobot at T = T_EQ (rounding alone forks its
            # lanes at T = 499); fd on its first iteration (see
            # SPLIT_FD_EQ_ITERS), the 12-iteration figures printed beside
            eq = dict(B=B_M, T=T_EQ if name == "acrobot" else None,
                      max_iter=(SPLIT_FD_EQ_ITERS if dm == "fd"
                                and name != "acrobot" else ITER_EQ))
            _m, ref = fd_solve(dev, name, f"{name} {dm} {integ} merged",
                               **eq, **cfg_r)
            out["vs_merged"], _c = fd_solve(
                dev, name, f"{name} {dm} {integ} split sweep vs merged", ref,
                **eq, **split, **cfg_r)
            if eq["max_iter"] != ITER_EQ:
                eq12 = dict(eq, max_iter=ITER_EQ)
                _m, ref = fd_solve(dev, name, f"{name} {dm} {integ} merged",
                                   **eq12, **cfg_r)
                out["vs_merged_12"], _c = fd_solve(
                    dev, name, f"{name} {dm} {integ} split sweep vs merged",
                    ref, assert_gauge=False, **eq12, **split, **cfg_r)
            res[f"{name}_split_{dm}_{integ}"] = out
            c = out["launches"]
            if name == "acrobot":
                rk4["derivs_packed/acrobot" + ("#fd" if dm == "fd" else "")][
                    "launches"] = c["derivs_packed"]
                continue
            if (dm, integ) == ("analytic", "euler"):
                rows[f"derivs_packed/{name}"]["launches"] = c["derivs_packed"]
                rows[f"backward_sweep_packed/{name}"]["launches"] = c[
                    "backward_sweep_packed"]
            elif dm == "fd":
                rows[f"derivs_packed/{name}"]["fd_launches"] = c[
                    "derivs_packed"]
            else:
                rk4[f"derivs_packed/{name}"]["launches"] = c["derivs_packed"]
    print(f"[time] phase 12d (the split sweep) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (e) short solves on the card against the plain path on the CPU
    res["card_vs_cpu"] = {}
    for name, tol, extra in (("power_mass", 1e-4, {}),
                             ("pendulum", 1e-4, dict(sweep_kernel="split")),
                             ("omni_thruster", 1e-4, {}),
                             ("acrobot", 1e-3, dict(clamp_forward=True))):
        key = "_".join([name, *(f"{k}={v}" for k, v in extra.items())])
        res["card_vs_cpu"][key] = card_vs_cpu(
            name, FD_CPU_T, FD_CPU_ITERS, tol, integrator="rk4",
            deriv_mode="analytic", **extra)
    return res


# ---------------------------------------------------------------------------
# The eighth slice: per-problem params (params_batched=True: one row of the
# packed params per lane, which every kernel reads on its lane — the
# per-lane params mode of the five model kernels) and the fleet warm start
# (solve_batch_fused_warm) with the fleet MPC on it (ilqr_tpu_torch.mpc).
# Three paths at full width, B = 1024: (a) examples/free_flyer_docking.py's
# fleet, each craft with its own docking port and thrust ceiling (the
# split iteration: rollout, sweep and line-search kernels); (b) the CLI's
# pendulum problem (ilqr_tpu/__main__.py:101) with per-lane goals and
# limits ±8, on the whole-iteration kernel and on the split sweep
# (derivative and backward kernels); (c) experiments/secondary_bench.py
# :296-327's fleet MPC (acrobot, T = 199, analytic, clamped, max_iter 20):
# a cold fleet_init, then warm fleet_step replans.

DOCK_T, DOCK_ITERS, DOCK_DT = 80, 40, 0.05
# tests/test_fused_batched_params.py:37-64 solves goals of -2.5, 2.0 and
# 3.14159 rad; the pendulum fleet spreads its 1024 goals over that span
PEND_GOAL_SPAN, PEND_LIMIT = (-2.5, 3.14159), 8.0
FLEET_T, FLEET_ITERS, FLEET_CYCLES = 199, 20, 6
WARM_WORSEN_TOL = 1e-3   # tests/test_fused_solver.py:134
# the kernels of each per-lane path compared in phase 3 (lanes_* readings)
LANES_KERNELS = {
    "free_flyer": ("rollout", "sweep", "linesearch"),
    "pendulum": ("rollout", "iteration", "derivs"),
}


def _rows(params, B):
    """``params`` (one problem's leaves) repeated on B lanes, numpy."""
    return type(params)(*[np.repeat(np.asarray(v, np.float32)[None], B,
                                    axis=0) for v in params])


def docking_workload(B=B_M):
    """examples/free_flyer_docking.py at --batch B (--horizon 80,
    --max-iter 40, dt 0.05), its draws from default_rng(0): docking ports
    on a ring of radius 2 at heights in ±0.5, thrust ceilings in 2.5-4.0,
    x0 = 0.2·normal for the first (untimed) call and again for the timed
    one. Returns (model, per-lane params, cfg, T, dt, u0, x0, x0 of the
    timed call, goals, ceilings)."""
    model = get_model("free_flyer")
    rng = np.random.default_rng(0)
    theta = 2.0 * np.pi * rng.uniform(size=B)
    goals = np.zeros((B, 6), np.float32)
    goals[:, 0] = 2.0 * np.cos(theta)
    goals[:, 1] = 2.0 * np.sin(theta)
    goals[:, 2] = rng.uniform(-0.5, 0.5, size=B)
    fmax = rng.uniform(2.5, 4.0, size=B).astype(np.float32)
    params = _rows(model.default_params(), B)._replace(
        goal=goals, u_max=np.repeat(fmax[:, None], model.m, axis=1))
    x0 = (0.2 * rng.normal(size=(B, 6))).astype(np.float32)
    x0_timed = (0.2 * rng.normal(size=(B, 6))).astype(np.float32)
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=DOCK_ITERS)
    return (model, params, cfg, DOCK_T, DOCK_DT,
            np.zeros((DOCK_T, model.m), np.float32), x0, x0_timed, goals,
            fmax)


def pendulum_goals_workload(B=B_M):
    """The CLI's pendulum problem as phase 10 runs it (T = 199, dt 0.02,
    x0 = 0.05·normal from default_rng(0), analytic, clamped, max_iter 100)
    with per-lane goal angles spread over PEND_GOAL_SPAN and limits
    ±PEND_LIMIT. Returns (model, per-lane params, cfg, T, dt, u0, x0)."""
    model, params, cfg, T, dt, u0, draw = workload("pendulum", B)
    goals = np.stack([np.linspace(*PEND_GOAL_SPAN, B), np.zeros(B)], axis=1)
    params = _rows(params, B)._replace(
        goal=goals.astype(np.float32),
        u_min=np.full((B, 1), -PEND_LIMIT, np.float32),
        u_max=np.full((B, 1), PEND_LIMIT, np.float32))
    return model, params, cfg, T, dt, u0, draw(np.random.default_rng(0))


def _lane_params(params, b):
    """Lane b's problem of per-lane numpy params: shared params."""
    return type(params)(*[torch.as_tensor(v[b]) for v in params])


def lanes_cases(dev, name, packing="lanes"):
    """The per-lane params mode of the kernels of phase 13's path of
    ``name`` (LANES_KERNELS) at that path's shapes: for free_flyer the
    docking fleet's rollout, sweep and line search (B = 1024, T = 80); for
    pendulum the goal fleet's rollout, whole iteration and the split
    sweep's derivative kernel (B = 1024, T = 199). Inputs: the path's x0,
    its clamped open-loop rollout under the per-lane params and that
    rollout's first gains; masks mixed. Each is a reading (lanes_*) of its
    kernel's row. ``packing`` "shared" (lane 0's problem as shared params)
    and "rows" (lane 0's problem on every lane's row) give the inputs of
    the bitwise check of phase 13."""
    if name == "free_flyer":
        model, params, cfg, T, dt, u0, x0_np, *_r = docking_workload()
    else:
        model, params, cfg, T, dt, u0, x0_np = pendulum_goals_workload()
    B, A, n, m = len(x0_np), len(cfg.alphas), model.n, model.m
    if packing == "shared":
        pp = kernel_rollout.pack_params(_lane_params(params, 0), dt, dev)
    else:
        pp = kernel_rollout.pack_params_batched(
            params if packing == "lanes" else _rows(
                _lane_params(params, 0), B), dt, dev)
    rng = np.random.default_rng(7)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    x0 = f(x0_np).t().contiguous()
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    xs0, us0, xT0, c0 = kernel_rollout.rollout_packed(
        model, "euler", True, pp, x0,
        f(u0)[:, :, None].expand(T, m, B).contiguous(), zeros(T, n, B),
        zeros(T, m, n, B))
    lam = torch.ones(B, device=dev)
    k1, K1, dv1, _d, _g = kernel_sweep.sweep_packed(model, "euler", pp, xs0,
                                                    xT0, us0, lam)
    live, gate, keep = (f(rng.uniform(size=B) > 0.5) for _ in range(3))
    alphas = f(cfg.alphas)
    xsr = xs0 + f(0.01 * rng.normal(size=(T, n, B)))
    Kr = f(0.05 * rng.normal(size=(T, m, n, B)))
    uff = us0 + f(0.2 * rng.normal(size=(T, m, B)))
    kold, Kold = f(rng.normal(size=(T, m, B))), f(rng.normal(size=(T, m, n,
                                                                   B)))
    old = nbytes(kold, Kold)
    shared = model.default_params()
    pp_cpu = kernel_rollout.pack_params(shared, dt)

    def kernel_ops(kind):
        if kind != "derivs":
            step, rest = lane_ops(model, shared, kind, True, A, dt)
            return step * T * B + rest * B
        lane_rng = np.random.default_rng(3)
        step, rest = ops_per_step(lambda t: kernel_derivs.derivs_plain(
            model, "euler", pp_cpu,
            torch.as_tensor(0.3 * lane_rng.normal(size=(t + 1, n, 1)),
                            dtype=torch.float32),
            torch.as_tensor(lane_rng.normal(size=(t, m, 1)),
                            dtype=torch.float32)))
        return step * T * B + rest * B

    every = {
        "rollout": (kernel_rollout.rollout_packed,
                    kernel_rollout.rollout_plain,
                    (model, "euler", True, pp, x0, uff, xsr, Kr), None),
        "sweep": (kernel_sweep.sweep_packed, kernel_sweep.sweep_plain,
                  (model, "euler", pp, xs0, xT0, us0, lam), None),
        "linesearch": (
            kernel_rollout.linesearch_packed, kernel_rollout.linesearch_plain,
            (model, "euler", True, pp, x0, us0, xs0, xT0, K1, k1, Kold, kold,
             alphas, dv1, c0, gate, keep, cfg.z_min),
            lambda got: old * (keep > 0.5).float().mean().item()),
        "iteration": (
            kernel_iter.iteration_packed, kernel_iter.iteration_plain,
            (model, "euler", True, pp, x0, xs0, xT0, us0, kold, Kold, lam,
             c0, live, alphas, "jvp", True, cfg.z_min, cfg.tol_grad,
             cfg.lambda_grad_term),
            lambda got: old * ((got[10] < 0.5) & (live > 0.5)).float()
            .mean().item()),
        "derivs": (kernel_derivs.derivs_packed, kernel_derivs.derivs_plain,
                   (model, "euler", pp,
                    torch.cat([xs0, xT0[None]]).contiguous(), us0, "jvp"),
                   None),
    }
    out = {}
    for kind in LANES_KERNELS[name]:
        op, plain, args, unread = every[kind]
        row = f"{kind}_packed/{name}"
        out[f"{row} (per-lane params)"] = Case(
            op, plain, args, lambda kind=kind: kernel_ops(kind),
            f"at B={B} T={T} A={A}, one params row per lane", unread,
            dict(row=row, group="lanes", kernel=f"{kind}_kernel", model=name,
                 limits=True, T=T, effort=effort(kind, T, n, m)))
    return out


def _timed_solve(solve_fn, x0):
    """One solve ending in a full device-to-host copy, launch counts and
    host counters set to 0 just before and read just after: (host
    Solution fields, wall seconds, launches, host iterations)."""
    reset_launch_counts()
    fused._host_any.syncs = 0
    fused._iteration.calls = 0
    fused._iteration.retried = 0
    t0 = time.perf_counter()
    sol = solve_fn(x0)
    host = {k: v.cpu().numpy() for k, v in sol._asdict().items()}
    return (host, time.perf_counter() - t0, launch_counts(),
            fused._iteration.calls)


def _initial_costs(dev, model, pp, T, u0, x0):
    z = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=dev)
    B = len(x0)
    return kernel_rollout.rollout_packed(
        model, "euler", True, pp, torch.as_tensor(x0, device=dev).t()
        .contiguous(), torch.as_tensor(u0, device=dev)[:, :, None].expand(
            T, model.m, B).contiguous(), z(T, model.n, B),
        z(T, model.m, model.n, B))[3].cpu().numpy()


def run_lanes_slice(dev, readings):
    """Phase 13: per-problem params and the fleet warm start; the launches
    of the per-lane paths go into the lanes_* ``readings``. Returns the
    results."""
    res = {}

    def record(name, counts):
        for kind in LANES_KERNELS[name]:
            key = f"{kind}_packed"
            if counts[key]:
                readings[f"{key}/{name}#lanes"]["launches"] = counts[key]

    # every per-lane kernel, rows equal across the lanes: exactly the
    # shared params' outputs (the stride-0 kernels) at the paths' shapes
    for name in LANES_KERNELS:
        shared = lanes_cases(dev, name, "shared")
        rows = lanes_cases(dev, name, "rows")
        for label, case in shared.items():
            want, got = case.op(*case.args), rows[label].op(*rows[label].args)
            same = all(torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
                       and torch.equal(torch.isnan(g), torch.isnan(w))
                       for g, w in zip(got, want))
            print(f"[lanes] {label}, lane 0's problem on every row vs the "
                  f"same problem as shared params: bitwise {same}")
            if not same:
                raise AssertionError(f"{label}: identical per-lane rows "
                                     f"differ from shared params")
        del shared, rows
    torch.cuda.empty_cache()

    # (a) the docking fleet
    t0 = time.perf_counter()
    (model, params, cfg, T, dt, u0, x0, x0_timed, goals,
     fmax) = docking_workload()
    pp = kernel_rollout.pack_params_batched(params, dt, dev)
    init = _initial_costs(dev, model, pp, T, u0, x0_timed)
    solve = lambda x: solve_batch_fused(model, params, cfg, dt, x, u0,
                                        params_batched=True)
    solve(x0)                          # the example's first, untimed call
    torch.cuda.synchronize()
    sol, wall, c, its = _timed_solve(solve, x0_timed)
    cost, us = sol["cost"], sol["us"]
    err = np.linalg.norm(sol["xs"][:, -1, :3] - goals[:, :3], axis=1)
    peak = us.max(axis=(1, 2))
    out = dict(B=len(x0), T=T, max_iter=cfg.max_iter,
               solves_per_s=len(x0) / wall, wall_s=wall,
               mean_cost=float(cost.mean()), init_mean_cost=float(init.mean()),
               mean_iters=float(sol["iterations"].mean()),
               median_docking_error_m=float(np.median(err)),
               launches=c, host_iterations=its,
               ms_per_iteration=wall * 1e3 / max(1, its),
               ceilings=(float(fmax.min()), float(fmax.max())),
               crafts_at_ceiling=float(np.mean(peak >= fmax - 1e-4)))
    print(f"[lanes] docking fleet (free_flyer, per-craft ports and thrust "
          f"ceilings): B={len(x0)} T={T} max_iter={cfg.max_iter}: "
          f"{out['solves_per_s']:.1f} solves/s ({nvidia_smi()}), "
          f"{out['ms_per_iteration']:.3f} ms/iteration over {its} host "
          f"iterations, mean cost {out['mean_cost']:.4f} (initial rollout "
          f"{out['init_mean_cost']:.4f}), mean iterations "
          f"{out['mean_iters']:.2f}, median docking error "
          f"{out['median_docking_error_m']:.3f} m, crafts at their own "
          f"ceiling {out['crafts_at_ceiling']:.3f} (ceilings "
          f"{fmax.min():.2f}-{fmax.max():.2f}), launches {c}")
    if not np.all(peak <= fmax + 1e-4):
        raise AssertionError("a craft's thrust exceeds its own ceiling")
    if not (np.all(np.isfinite(cost)) and np.all(cost <= init)):
        raise AssertionError("docking: a cost is not finite or above its "
                             "initial rollout's")
    if (c["rollout_packed"] != 1 or c["sweep_packed"] < its
            or c["linesearch_packed"] < 1 or c["iteration_packed"]):
        raise AssertionError(f"docking: the route is free_flyer's split "
                             f"iteration: {c}")
    record("free_flyer", c)
    res["docking"] = out
    print(f"[time] phase 13a (docking fleet) {time.perf_counter() - t0:.1f} s",
          flush=True)

    # (b) the pendulum goals, on the whole-iteration kernel and the split
    # sweep; the split sweep against the merged one under the gauge
    t0 = time.perf_counter()
    model, params, cfg, T, dt, u0, x0 = pendulum_goals_workload()
    pp = kernel_rollout.pack_params_batched(params, dt, dev)
    init = _initial_costs(dev, model, pp, T, u0, x0)
    costs = {}
    for route, extra in (("whole-iteration", {}),
                         ("split sweep", dict(sweep_kernel="split"))):
        cfg_r = cfg.replace(**extra)
        solve = lambda x: solve_batch_fused(model, params, cfg_r, dt, x, u0,
                                            params_batched=True)
        sol, wall, c, its = _timed_solve(solve, x0)
        cost = sol["cost"]
        r = dict(solves_per_s=len(x0) / wall, wall_s=wall,
                 mean_cost=float(cost.mean()),
                 init_mean_cost=float(init.mean()),
                 mean_iters=float(sol["iterations"].mean()), launches=c,
                 host_iterations=its, ms_per_iteration=wall * 1e3 / max(1,
                                                                          its))
        print(f"[lanes] pendulum with per-lane goals ({route}): B={len(x0)} "
              f"T={T} max_iter={cfg.max_iter}: {r['solves_per_s']:.1f} "
              f"solves/s ({nvidia_smi()}), {r['ms_per_iteration']:.3f} "
              f"ms/iteration over {its} host iterations, mean cost "
              f"{r['mean_cost']:.4f} (initial rollout "
              f"{r['init_mean_cost']:.4f}), mean iterations "
              f"{r['mean_iters']:.2f}, launches {c}")
        if not (np.all(np.isfinite(cost)) and np.all(cost <= init)):
            raise AssertionError(f"pendulum goals ({route}): a cost is not "
                                 f"finite or above its initial rollout's")
        kernel = ("iteration_packed" if not extra
                  else "backward_sweep_packed")
        if c["rollout_packed"] != 1 or c[kernel] < its or (
                extra and c["derivs_packed"] < its):
            raise AssertionError(f"pendulum goals ({route}): launches {c}")
        record("pendulum", c)
        res[f"pendulum_goals_{route}"] = r
        costs[route] = cost
    # three lanes, each solved alone with its problem as shared params:
    # the same solve bit for bit (lanes never interact)
    alone = {}
    for b in (0, len(x0) // 2, len(x0) - 1):
        one = solve_batch_fused(model, _lane_params(params, b), cfg, dt,
                                x0[b:b + 1], u0)
        alone[b] = float(one.cost.item())
    print(f"[lanes] pendulum goals: lanes {list(alone)} solved alone with "
          f"shared params: costs {list(alone.values())}, in the batch "
          f"{[float(costs['whole-iteration'][b]) for b in alone]}")
    if any(alone[b] != float(costs["whole-iteration"][b]) for b in alone):
        raise AssertionError("pendulum goals: a lane solved alone with its "
                             "params shared differs from the batch")
    eq = dict(max_iter=ITER_EQ)
    merged = solve_batch_fused(model, params, cfg.replace(**eq), dt, x0, u0,
                               params_batched=True).cost.cpu().numpy()
    split = solve_batch_fused(model, params, cfg.replace(
        sweep_kernel="split", **eq), dt, x0, u0,
        params_batched=True).cost.cpu().numpy()
    p99, mx = gauge(split, merged)
    print(f"[lanes] pendulum goals, split sweep vs merged at max_iter "
          f"{ITER_EQ}: per-lane |c1-c2|/(1+|c2|) p99 {p99:.3e} (≤ "
          f"{GAUGE_P99:g}), max {mx:.3e} (≤ {GAUGE_MAX:g})")
    if not (np.isfinite(split).all() and p99 <= GAUGE_P99
            and mx <= GAUGE_MAX):
        raise AssertionError("pendulum goals: split sweep outside the gauge")
    res["pendulum_goals_split_vs_merged"] = dict(p99=p99, max=mx)
    print(f"[time] phase 13b (pendulum goals) {time.perf_counter() - t0:.1f} "
          "s", flush=True)

    # (c) the fleet MPC: a cold plan, a warm re-solve from the same states
    # (never worse than the cold plan by more than WARM_WORSEN_TOL per
    # lane), then FLEET_CYCLES warm replans of the whole fleet
    t0 = time.perf_counter()
    model, params = get_model("acrobot"), acrobot.default_params()
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=FLEET_ITERS)
    x0 = (0.05 * np.random.default_rng(0).normal(size=(B_M, N))).astype(
        np.float32)
    u0 = np.zeros((FLEET_T, M), np.float32)
    t1 = time.perf_counter()
    fleet = mpc.fleet_init(model, params, cfg, DT, x0, u0)
    cold = fleet.plan.cost.cpu().numpy()
    cold_s = time.perf_counter() - t1
    warm = solve_batch_fused_warm(model, params, cfg, DT, x0, fleet.plan)
    worse = float(np.max(warm.cost.cpu().numpy() - cold))
    print(f"[lanes] fleet MPC (acrobot, B={B_M} T={FLEET_T} max_iter="
          f"{FLEET_ITERS}): cold plan {cold_s:.3f} s, mean cost "
          f"{cold.mean():.4f}; a warm re-solve from the same states: mean "
          f"iterations {warm.iterations.float().mean().item():.2f}, largest "
          f"cost increase {worse:.3e} (≤ {WARM_WORSEN_TOL:g})")
    if not (np.isfinite(cold).all() and worse <= WARM_WORSEN_TOL):
        raise AssertionError("fleet MPC: the warm re-solve worsened a lane")
    reset_launch_counts()
    cycles, iters = [], []
    for _ in range(FLEET_CYCLES):
        t1 = time.perf_counter()
        fleet = mpc.fleet_step(model, params, cfg, DT, fleet)
        cost = fleet.plan.cost.cpu().numpy()
        cycles.append(time.perf_counter() - t1)
        iters.append(float(fleet.plan.iterations.float().mean().item()))
        if not np.isfinite(cost).all():
            raise AssertionError("fleet MPC: non-finite replanned costs")
    c = launch_counts()
    cyc = float(np.median(cycles))
    out = dict(B=B_M, T=FLEET_T, max_iter=FLEET_ITERS, cold_s=cold_s,
               cold_mean_cost=float(cold.mean()), warm_worst_increase=worse,
               cycle_ms=[v * 1e3 for v in cycles], cycle_ms_median=cyc * 1e3,
               replans_per_s=B_M / cyc, mean_iters=iters,
               mean_cost=float(cost.mean()), launches=c)
    print(f"[lanes] fleet MPC: {FLEET_CYCLES} replanning cycles (plant step, "
          f"shift, warm re-solve): {out['replans_per_s']:.1f} replans/s "
          f"({nvidia_smi()}), cycle {cyc * 1e3:.3f} ms (median; all "
          f"{[round(v * 1e3, 3) for v in cycles]}), mean iterations per "
          f"replan {[round(v, 2) for v in iters]}, mean cost "
          f"{out['mean_cost']:.4f}, launches {c}")
    if (c["rollout_packed"] != FLEET_CYCLES or not c["iteration_packed"]
            or not np.all(fleet.t.cpu().numpy() == FLEET_CYCLES)):
        raise AssertionError(f"fleet MPC: launches {c}, step counters "
                             f"{fleet.t}")
    res["fleet_mpc"] = out
    print(f"[time] phase 13c (fleet MPC) {time.perf_counter() - t0:.1f} s",
          flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(DEVICE)
    smi = nvidia_smi()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    print(f"[env] {smi}; {os.cpu_count()} CPU cores on the host (the build "
          f"runs one nvcc per source, all at once)")

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
    rows, readings = run_comparisons(dev, tick)
    tick(f"phase 3b (plain versions, {COMPARE_WORKERS} processes)")
    model, params, cfg = flagship()
    main_out = run_main_path(dev, model, params, cfg)
    for name in ("rollout_packed", "iteration_packed"):
        rows[f"{name}/acrobot"]["launches"] = main_out["launches"][name]
    main_out["profile"] = profile_solve(
        "fused", lambda x0, u0: solve_batch_fused(model, params, cfg, DT, x0,
                                                  u0),
        float(np.median(main_out["wall_s"])))
    tick("phase 4 (the flagship path)")
    split_counts, gauges = run_split_path(dev, model, params, cfg)
    for name in ("sweep_packed", "linesearch_packed"):
        rows[f"{name}/acrobot"]["launches"] = split_counts[name]
    tick("phase 5 (split route, plain path)")
    comp_out = run_composable_path(dev, model, params, cfg, main_out)
    for name in ("derivs_packed", "backward_sweep_packed"):
        rows[f"{name}/acrobot"]["launches"] = comp_out["launches"][name]
    tick("phase 6 (composable path)")
    equiv = run_equivalence(dev, model, params, cfg)
    tick("phase 7 (equivalence)")
    slice_out = run_slice(dev, rows)
    tick("phase 8 (the m = 2…4 slice)")
    wide_out = run_wide_slice(dev, rows)
    tick("phase 9 (the m ≥ 5 slice)")
    cli_out = run_cli_slice(dev, rows)
    tick("phase 10 (pendulum, cartpole, bicycle, power_mass)")
    fd_out = run_fd_slice(dev, rows, readings)
    tick("phase 11 (the stencils in the fused kernels, RK4)")
    jvp_out = run_jvp_slice(dev, rows, readings)
    tick("phase 12 (the dual-number slice: analytic + RK4, the split sweep)")
    lanes_out = run_lanes_slice(dev, readings)
    tick("phase 13 (per-problem params, the fleet warm start and MPC)")
    print(f"[time] phases 2-13 {time.perf_counter() - t0:.1f} s", flush=True)
    for key, r in readings.items():   # a mode of a row's kernel
        row, _sep, mode = key.partition("#")
        rows[row].update({f"{READING_PREFIX[mode]}{k}": v
                          for k, v in r.items()
                          if k not in ("kernel", "model", "limits",
                                       "source")})
    for name, r in rows.items():
        kind = name.split("/")[0]
        r["name"] = name
        r.setdefault("source", SOURCES.get(
            kind, "ilqr_tpu_torch/csrc/kernels.cu") if r["model"] == "acrobot"
            else f"ilqr_tpu_torch/csrc/kernels_{r['model']}.cu")
        r.update(route="cuda", replaces=REPLACES[kind], tol=KERNEL_TOL,
                 library_ms=None, library_note=(
                     "no single PyTorch call computes this function"))
        limits = r["limits"] if r["kernel"].startswith(
            ("sweep_kernel", "iteration_kernel")) else None
        r.update(ptxas.get((r["kernel"], r["model"], limits), {}))
    if not all(r.get("launches") for r in rows.values()):
        raise AssertionError(f"a kernel was never launched: {rows}")
    if not all(rows[f"{kind}_packed/{name}"].get("lanes_launches")
               for name, kinds in LANES_KERNELS.items() for kind in kinds):
        raise AssertionError("a per-lane params kernel was never launched on "
                             "its path")

    print(json.dumps({"main_path": main_out, "split_path": gauges,
                      "composable_path": comp_out, "equivalence": equiv,
                      "slice": slice_out, "wide_slice": wide_out,
                      "cli_slice": cli_out, "fd_slice": fd_out,
                      "jvp_slice": jvp_out, "lanes_slice": lanes_out}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
