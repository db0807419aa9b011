#!/usr/bin/env python3
"""Drives ilqr_tpu_torch's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: the CUDA kernels from ilqr_tpu_torch/csrc with nvcc, one
     process per source, all started together (each source's seconds and
     each kernel's registers, stack and spills printed; every sweep,
     whole-iteration, line-search and derivative launcher's kernel checked
     against the one launched_kernel names, with its threads a lane, and
     for the team, warp and derivative kernels also their blocks per SM);
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
     steps); rollout_packed's second kernel, its other modes (costs_only,
     A = 11 candidates materialized or with the step α formed in the
     kernel, one α per lane), at the line search's shapes of acrobot
     (B = 8192, T = 499, Euler and RK4), the quadrotor and thruster_ring
     (B = 1024, T = 80), pendulum with per-lane params (B = 1024, T = 199)
     and the custom unicycle (modes_cases), held bit for bit; the team
     and warp kernels, held bit for bit in their rows and on their edge
     cases: the whole iteration of acrobot, cartpole and pendulum as a
     team of 16 threads per lane (csrc/iteration_team.cuh; team_cases:
     acrobot's three forms, a partial last block, B = 8189, A = 1 and
     A = 7, every lane dead, NaN in one lane's x0; edge_cases
     "iteration_team": cartpole's three forms and pendulum's analytic one,
     the same edges at B = 1024 / 1021), that of double_integrator,
     bicycle, power_mass and point_mass_3d as the same team at 32 threads
     per lane (edge_cases "iteration_team32": point_mass_3d's analytic
     form, power_mass's stencils, bicycle's dual numbers), the backward
     kernel (csrc/backward.cuh, a team per lane fed by a cp.async ring;
     edge_cases "backward_team": cartpole's and pendulum's rows on a
     partial last block, T = 1, a NaN lane, lanes that latch div, clamped
     controls, mixed λ), the line search of every model, custom ones too,
     as a team of 16 threads per lane (csrc/linesearch_team.cuh; edge_cases
     "linesearch_team": the pendulum, the quadrotor's RK4 reading,
     thruster_ring24, those edges and the clamp flipped), the custom
     models' line search and whole iteration on the teams (the unicycle
     and unicycle_heading, 16 threads a lane by the (n, m) rule of their
     generated headers; edge_cases "custom_team": both models' line
     search and dual-number iteration, the same edges), the merged sweep
     and the whole iteration of the split-route models (m·n ≥ 32: the
     quadrotor and the m ≥ 5 models) as a warp per lane
     (csrc/sweep_team.cuh, sweep_team_cases "sweep_team": thruster_ring's
     and the quadrotor's three forms, a partial last block, B = 1021, NaN
     in one lane's x0, λ mixed so that lanes latch div, per-lane params,
     T = 1; csrc/iteration_warp.cuh, edge_cases "iteration_warp":
     thruster_ring's three forms and the quadrotor's stencils, the edges of
     the team iteration on the first 4 steps), the merged sweep of the
     m·n < 32 models' stencils and dual numbers on the team of their
     whole iteration (sweep_small_team_kernel; sweep_team_cases
     "sweep_small_team": acrobot's stencils at B = 8192 / 8189, cartpole's
     stencils and dual numbers, point_mass_3d's stencils, the unicycle's
     dual numbers, the warp sweep's edges), and
     the derivative kernel, a thread per (t, lane) storing each entry as it
     is made (csrc/derivs.cuh;
     derivs_edge_cases: acrobot's both modes at B = 8192, point_mass_3d,
     thruster_ring24 and the custom unicycle, each 3 lanes short of its
     row, T = 1, NaN in one lane's x0, per-lane params). This process
     times each kernel alone on the card (CUDA
     events, 3a); after phase 4, worker processes run the plain versions,
     which are host-bound, one job per case builder, longest first, beside
     phases 5-16 (3b; an iteration case reuses its builder's sweep's plain
     result on the same inputs, SweepMemo), and this process the edge
     cases' once the workers are done; each case prints its errors, times
     and bound;
  4. the fused path: acrobot swing-up through solve_batch_fused at
     B = 8192, T = 499, max_iter = 100 — solves/s, cost, iterations, launch
     counts; then one more solve under torch.profiler for the device time
     by kernel and the device's busy share; alone on the card, as 3a.
     From here on the phases share the card and the host's cores: phases
     5-8, 9-10 with 16, 11, and 12-13 each run in a process of their own
     (STREAMS), their logs printed when they end, 14-15 in this one
     (MAIN_PHASES), beside 3b's workers; so their times are not those of
     a card to themselves;
  5. the fused split route (sweep + line-search kernels) against the merged
     one, and the kernel path against the plain path on the card, at
     B = 1024, max_iter = 2; beside them, not asserted, the kernel path
     from an x0 moved by 1e-6, which shows how far rounding alone carries
     a lane on this chaotic workload;
  6. the composable path: solve_batch at the same size on the same x0
     (derivative, backward and rollout kernels; the line search as one
     rollout over B·A lanes) beside solve_batch_fused — solves/s, cost,
     iterations, launches, λ retries — and one profiled solve, with the
     backward kernel's device ms a launch and the device's busy share;
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
     thruster_ring24 at the cap (one solve at max_iter RING24_ITERS = 34,
     the same in every tree) and thruster_ring16/20 at a cut depth; short
     omni_thruster and thruster_ring solves against the plain path on the
     CPU;
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
 14. the composable solver at m ≥ 2 (solve, solve_verbose, solve_batch and
     the single-controller MPC on the derivative kernel of every model;
     the backward pass's QPs in plain PyTorch, as the JAX package runs
     them in XLA): (a) the reference's main path, the CLI's integrator
     problem through solve_verbose (fd, the iterative QP, unclamped, T =
     99) against golden/integrator_golden.csv, its iterations beside the
     reference's 14; (b) examples/quadrotor_waypoints.py --vmap (B = 256,
     T = 80, max_iter 40): solves/s, ms and host syncs per iteration,
     every lane at or below its initial cost, the mean cost within 2% of
     the fused solver's, a profiled iteration, a short slice against the
     CPU; (c) short solves (B = 64, T = 20) of the other ten m ≥ 2 models
     (the double integrator with RK4, omni_thruster with pn_fixed,
     power_mass with per-lane params) against the CPU; (d) 20 replans of
     tests/test_mpc.py's controller against the CPU, step by step; phase
     3 holds each model's derivative kernel at these paths' shapes
     (derivs_cases);
 15. custom models (models.register; ilqr_tpu_torch/examples/
     custom_model.py's unicycle, n = 3, m = 2, and its m = 1 companion
     unicycle_heading), whose libraries phase 2 builds from their
     generated device functions beside the main one: (a) the example's
     problem through solve (analytic, clamped, T = 80) for the example's
     goal and tests/test_custom_model.py's, each within 0.1 of its goal and
     at the CPU's cost; (b) a fleet of B = 1024 unicycles through
     solve_batch_fused (T = 80, max_iter 40; analytic with Euler — the
     dual numbers, the model having no closed forms — and RK4, fd with
     Euler, the split iteration), every lane at or below its initial cost,
     4 lanes against the CPU; (c) tests/test_custom_model.py:41-53's
     composable batch on the kernel routes at B = 1024; (d)
     unicycle_heading's split sweep (the backward kernel at n = 3) against
     its merged route, and its composable m = 1 route; (e) the unicycle
     without SoA functions on the "xla" routes against the CPU; phase 3
     holds every custom kernel bit for bit (custom_cases), and phase 14(a)
     sets the card's solve_verbose rows beside the CPU's (the C1 witness);
 16. the CLI and the examples: (a) python -m ilqr_tpu_torch acrobot
     --batch 8192 --max-iter 20 in a process of its own (the fused fd
     route), its printed mean cost and iterations and its CSV against an
     in-process solve_batch_fused on the same draw, written by the native
     trajio; (b) the pendulum through the CLI's single solve (the
     composable route) with its TIMESTUFF report, and its plot where
     matplotlib is installed; (c) the
     quadrotor batch from hover on the fused JVP route (analytic + RK4),
     its Solution checkpointed and restored bit for bit; (d) the three
     examples (quadrotor_waypoints, free_flyer_docking, mpc_fleet) at
     their default sizes; (e) --x64, --full-ddp and the assoc backward
     raise before any launch; (f) the rollout modes' path: the JAX
     kernel's two-pass line search (pass 1 the candidates' costs, pass 2
     the chosen α per lane) on phase 3's inputs, bit for bit against
     linesearch_packed, which gives the modes' launches;
 17. one JSON line listing every kernel × model instantiation launched (the
     RK4 readings as rk4_* fields of the kernel's row, the stencil mode's
     RK4 reading of the derivative kernel as rk4_fd_*, the per-lane params
     readings as lanes_*, the rollout modes as costs_only_*, candidates_*,
     alphas_*, alpha_lanes_* and alphas_rk4_*), the card's line, and the
     last line {"ok": true, "device": {...}}. Each phase prints its
     seconds.

It needs one CUDA device and the ilqr_tpu_torch package beside it; without
either it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import inspect
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch import (
    SolverConfig,
    TerminationReason,
    convergence_stats,
    fused,
    get_model,
    mpc,
    solve_batch,
    solve_batch_fused,
    solve_batch_fused_warm,
    solver,
)
from ilqr_tpu_torch.models import (
    acrobot,
    double_integrator,
    omni_thruster,
    quadrotor,
)
from ilqr_tpu_torch.ops import (
    _build,
    boxqp,
    codegen,
    kernel_backward,
    kernel_derivs,
    kernel_iter,
    kernel_rollout,
    kernel_sweep,
    launch_counts,
    reset_launch_counts,
)

B_MAIN, T, DT, MAX_ITER = 8192, 499, 0.02, 100
# Phase 5 at a cut depth (2 iterations): its plain path takes ~7 s per
# iteration at T = 499 on an H100 80GB HBM3 (700 W).
B_SPLIT, ITER_SPLIT = 1024, 2
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
    "derivs_packed": "ilqr_tpu_torch/csrc/derivs_acrobot.cu",
    "backward_sweep_packed": "ilqr_tpu_torch/csrc/backward.cu",
}
# (backward_kernel: the one-thread backward kernel of the trees before the
# team, which tools/backward_ab.py profiles beside it)
# (derivs_kernel: the one thread per (t, lane) derivative kernel of the
# trees before derivs_entry_kernel, which tools/derivs_ab.py reads beside it)
KERNEL_NAMES = ("iteration_kernel", "iteration_team_kernel",
                "iteration_warp_kernel", "sweep_team_kernel",
                "sweep_small_team_kernel", "rollout_kernel", "sweep_kernel",
                "linesearch_kernel", "linesearch_team_kernel",
                "derivs_entry_kernel", "derivs_kernel",
                "backward_team_kernel", "backward_kernel",
                "rollout_modes_kernel")
# the sweep and whole-iteration kernels, templates on the limits flag
LIMITS_KERNELS = ("sweep_kernel", "iteration_kernel", "iteration_team_kernel",
                  "iteration_warp_kernel", "sweep_team_kernel",
                  "sweep_small_team_kernel")


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
        kernel = launched_kernel(kind, model)
        return dict(row=row or f"{label}/acrobot", group=group,
                    kernel=kernel, model="acrobot", limits=True, T=T,
                    effort=effort(kind, T, N, M),
                    bitwise=held_bitwise(kernel))

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
    """This design's traffic per flagship iteration_packed launch (the team
    kernel, csrc/iteration_team.cuh): xs and us read by each of the three
    phases, the new gains written once into k_out and K_out and read twice
    (the candidates, the replay of the selected one), the new state
    written; the previous gains, read and written where a lane drops the
    new ones, are not counted."""
    f32 = 4
    xs_us = (T * N + T * M) * B_MAIN * f32
    gains = (T * M + T * M * N) * B_MAIN * f32
    design = 3 * xs_us + 3 * gains + xs_us
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
            + [("team",), ("sweep_team",), ("sweep_small_team",),
               ("derivs_edges",)]
            + [(which,) for which in EDGE_ROWS]
            + [("split", name) for name in SPLIT_MODELS]
            + [("lanes", name) for name in LANES_KERNELS]
            + [("derivs", name) for name in COMP_MODELS]
            + [("custom", name) for name in CUSTOM_MODELS]
            + [("modes", name) for name in MODES_MODELS])


def build_cases(dev, which):
    if which[0] == "acrobot":
        return acrobot_cases(dev)
    if which[0] == "model":
        return model_cases(dev, which[1])
    if which[0] == "jvp":
        return jvp_cases(dev, which[1])
    if which[0] == "team":
        return team_cases(dev)
    if which[0] in SWEEP_EDGE_ROWS:
        return sweep_team_cases(dev, which[0])
    if which[0] == "derivs_edges":
        return derivs_edge_cases(dev)
    if which[0] in EDGE_ROWS:
        return edge_cases(dev, which[0])
    if which[0] == "split":
        return split_cases(dev, which[1])
    if which[0] == "lanes":
        return lanes_cases(dev, which[1])
    if which[0] == "derivs":
        return derivs_cases(dev, which[1])
    if which[0] == "custom":
        return custom_cases(dev, which[1])
    if which[0] == "modes":
        return modes_cases(dev, which[1])
    return fd_cases(dev, which[1])


class SweepMemo:
    """kernel_sweep.sweep_plain with each result kept by its arguments (the
    tensors, the model and the packed params by identity). A builder's
    iteration case runs its sweep's plain version on the same inputs as the
    builder's sweep case (iteration_plain = sweep_plain, the gates, then
    linesearch_plain): in one worker that sweep runs once, and the case
    that reuses it adds the sweep's measured ms to its own plain ms
    (``saved_ms``). Each call returns copies, so no caller can change what
    another reads."""

    def __init__(self):
        self.results = {}
        self.saved_ms = 0.0
        self.signature = inspect.signature(kernel_sweep.sweep_plain)

    def __call__(self, *args, **kwargs):
        bound = self.signature.bind(*args, **kwargs)
        bound.apply_defaults()
        key = tuple(v if isinstance(v, (str, int, float, bool, type(None)))
                    else id(v) for v in bound.arguments.values())
        hit = self.results.get(key)
        if hit is None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = kernel_sweep.sweep_plain(*args, **kwargs)
            end.record()
            end.synchronize()
            self.results[key] = hit = (out, start.elapsed_time(end))
        else:
            self.saved_ms += hit[1]
        return tuple(t.clone() for t in hit[0])


def _worker_init():
    torch.set_num_threads(1)


def _worker_job(job):
    """In a worker process: the comparisons of one builder's cases, ``job``
    = (builder, labels), its inputs made once; its sweeps' plain versions
    shared with its iteration cases (SweepMemo). Returns [(key, result)]."""
    which, labels = job
    cases = build_cases(torch.device(DEVICE), which)
    memo = SweepMemo()
    kernel_iter.sweep_plain = memo
    out = []
    try:
        for label in labels:
            case = cases[label]
            if case.plain is kernel_sweep.sweep_plain:
                case = case._replace(plain=memo)
            t0 = time.perf_counter()
            memo.saved_ms = 0.0
            r = check_case(case)
            r["plain_ms"] += memo.saved_ms
            out.append(((which, label), dict(
                r, job_s=time.perf_counter() - t0,
                peak_reserved=torch.cuda.max_memory_reserved())))
    finally:
        kernel_iter.sweep_plain = kernel_sweep.sweep_plain
    del cases, memo
    # the plain versions' temporaries back to the card: the processes
    # share its memory with the kernels' local memory
    torch.cuda.empty_cache()
    return out


# the readings of a row's kernel in another mode, by their group: their key
# in the readings (the row's key and this suffix) and their fields' prefix
READING_SUFFIX = {"rk4": "", "rk4_fd": "#fd", "lanes": "#lanes"}
READING_PREFIX = {"": "rk4_", "fd": "rk4_fd_", "lanes": "lanes_"}


class PendingComparisons(NamedTuple):
    order: list        # every case's key, in the order the rows print
    times: dict        # key → its kernel's ms, timed alone on the card
    wheres: dict
    metas: dict
    jobs: list         # the workers' (builder, labels), longest first
    main_cases: dict   # the team kernel's edge cases (team_cases)


def time_kernels(dev):
    """Phase 3a: every kernel × model instantiation (and each reading of a
    kernel's runtime mode: RK4, per-lane params) built on its path's inputs
    and timed while this process is alone on the card. Returns what 3b
    compares: the edge cases' plain versions in this process, the rest in
    COMPARE_WORKERS worker processes (host-bound, minutes in sum), longest
    first."""
    order, times, wheres, metas, groups = [], {}, {}, {}, {}
    main_cases = {}
    for which in comparison_sets():
        cases = build_cases(dev, which)
        for label, case in cases.items():
            key = (which, label)
            order.append(key)
            times[key] = time_ms(lambda: case.op(*case.args), reps=3)
            wheres[key], metas[key] = case.where, case.meta
            if case.meta["group"] == "edge" and case.meta.get("main", True):
                main_cases[key] = case
            else:   # one job per builder, its effort the sum of its cases'
                effort_sum, labels = groups.get(which, (0, []))
                groups[which] = (effort_sum + case.meta["effort"],
                                 labels + [label])
        del cases
    torch.cuda.empty_cache()
    jobs = sorted(groups.items(), key=lambda kv: -kv[1][0])
    return PendingComparisons(order, times, wheres, metas,
                              [(which, labels)
                               for which, (_e, labels) in jobs], main_cases)


def compare_edges(pending):
    """The edge cases' comparisons, in this process (their dense plain
    versions hold several GB each); the card's memory they held freed."""
    results = {}
    for key, case in pending.main_cases.items():
        t1 = time.perf_counter()
        results[key] = dict(check_case(case),
                            job_s=time.perf_counter() - t1)
    pending.main_cases.clear()
    torch.cuda.empty_cache()
    return results


def collect_comparisons(pending, results, wall):
    """Phase 3b's results (``results`` by key, ``wall`` its seconds) printed
    and held to KERNEL_TOL, bit for bit where the case asks. Returns (rows
    by key, readings by the key of their row and READING_SUFFIX)."""
    order, times = pending.order, pending.times
    wheres, metas = pending.wheres, pending.metas
    in_workers = sum(len(labels) for _which, labels in pending.jobs)
    rows, rk4, edges, failed = {}, {}, {}, []
    for key in order:
        r = dict(results[key], ms=times[key])
        job_s = r.pop("job_s")
        r.pop("peak_reserved", None)
        print(f"[kernel] {key[1]}: max_abs_err {r['max_abs_err']:.3e} "
              f"max_err {r['max_err']:.3e} (tol {KERNEL_TOL:g}) bitwise "
              f"{r['bitwise_equal']} | kernel {r['ms']:.3f} ms plain "
              f"{r['plain_ms']:.1f} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {r['bound_bytes']:.0f} B, "
              f"{r['bound_ops']} ops) {wheres[key]}; {job_s:.1f} s")
        meta = metas[key]
        if meta["group"] in MODE_GROUPS:
            d = meta["design_bytes"]
            print(f"[kernel] {key[1]}: one thread per (candidate, lane) "
                  f"moves ~{d / 1e6:.1f} MB (~{d / PEAK_BYTES * 1e3:.4f} ms "
                  f"at the peak rate); the bound counts "
                  f"{r['bound_bytes'] / 1e6:.1f} MB")
        # the rollout modes and the team kernel are held bit for bit, the
        # rest to KERNEL_TOL
        if not (r["max_err"] <= KERNEL_TOL and (
                r["bitwise_equal"] or (meta["group"] not in MODE_GROUPS
                                       and not meta.get("bitwise")))):
            failed.append(key[1])
        if meta["group"] == "edge":
            edges.setdefault(meta["row"], {})[meta["edge"]] = {
                k: r[k] for k in ("bitwise_equal", "max_abs_err", "ms",
                                  "plain_ms")}
            continue
        if meta["group"] == "fd_of":
            rows[meta["row"]].update({f"fd_{k}": v for k, v in r.items()})
            continue
        row = dict(r, **{k: v for k, v in meta.items()
                         if k not in ("row", "group", "effort", "bitwise")})
        if meta["group"] == "row":
            rows[meta["row"]] = row
        else:   # "rk4"; "rk4_fd", the RK4 reading of the row's fd mode;
            #     "lanes", the per-lane params reading
            rk4[meta["row"] + READING_SUFFIX[meta["group"]]] = row
    for row, readings in edges.items():
        rows[row]["edge_cases"] = readings
    print(design_traffic_line())
    busy = sum(results[key]["job_s"] for key in order)
    peak = max(results[key].get("peak_reserved", 0) for key in order)
    print(f"[compare] {len(order)} plain comparisons, {in_workers} in "
          f"{COMPARE_WORKERS} processes beside phases 5-16 (one job per "
          f"builder, {len(pending.jobs)} jobs), the rest in this one: "
          f"{wall:.1f} s wall for {busy:.1f} s of comparisons "
          f"(plain ms: one call, with the other processes sharing the card "
          f"and the host's {os.cpu_count()} cores); a worker's peak "
          f"{peak / 2**30:.1f} GiB reserved on the card")
    if failed:
        raise AssertionError(f"disagree with their plain versions beyond "
                             f"{KERNEL_TOL} (the rollout modes and the team "
                             f"kernel: not bit for bit): {failed}")
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


def profile_solve(label, solve_fn, wall_s, x0=None, u0=None, host=True):
    """Where one solve's time goes: device time by kernel from
    torch.profiler (CUPTI), and the device's busy share of the unprofiled
    median wall time ``wall_s``. ``solve_fn(x0, u0)`` runs it; x0 and u0
    default to a flagship-size acrobot draw. ``host=False`` traces the
    device alone (a solve of tens of thousands of small ops, whose host
    events would cost the trace seconds)."""
    from torch.profiler import ProfilerActivity, profile

    if x0 is None:
        rng = np.random.default_rng(2)
        x0 = (0.05 * rng.normal(size=(B_MAIN, N))).astype(np.float32)
        u0 = np.zeros((T, M), np.float32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
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
    # one timed solve (three before; PERF.md §7), on phase 4's last draw,
    # whose fused solve gave fused_out's mean cost
    draw(), draw()
    runs = []
    for rep in range(1):
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
    reset_launch_counts()
    prof = out["profile"] = profile_solve(
        "composable", lambda x0, u0: solve_batch(model, params, cfg, DT, x0,
                                                 u0),
        float(np.median(walls)))
    bl = launch_counts()["backward_sweep_packed"]
    if prof is not None:
        bms = sum(prof["device_ms_by_kernel"].get(k, 0.0) for k in (
            "backward_team_kernel", "backward_kernel"))
        out["backward_ms_per_launch"] = bms / max(1, bl)
        print(f"[composable] profiled solve: the backward kernel "
              f"{out['backward_ms_per_launch']:.3f} ms a launch ({bl} "
              f"launches, {bms:.1f} ms), device busy share "
              f"{prof['device_busy_share']:.3f} ({nvidia_smi()})")
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
# Phase 3's plain versions run in this many worker processes, beside the
# phases after phase 4 (STREAMS): they are host-bound, one PyTorch op per
# operation, so each takes a host core.
COMPARE_WORKERS = max(1, min(5, (os.cpu_count() or 1) - 3))
STREAM_THREADS = 2    # torch's CPU threads in each stream's process
DEVICE = "cuda"
RING24_ITERS = 34     # thruster_ring24's path: a fixed cut depth (cut from
#                       WIDE_ITERS), so that every tree runs the same
#                       iterations and reaches the same mean cost
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
# the B = 8192 acrobot RK4 paths of phases 11-12 (fd and analytic) at a cut
# depth, to keep the script inside its time limit on slow hosts
RK4_HEADLINE_ITERS = 20
# the quadrotor's fd + RK4 path at a cut depth (PERF.md §7)
FD_WIDE_ITERS = 20
# phase 11d's m ≥ 5 fd paths and phase 12c's m ≥ 5 analytic + RK4 paths
# (omni_thruster, free_flyer, thruster_ring; with and without limits) at a
# cut depth, to keep the script inside its time limit on slow hosts
M5_FD_ITERS, M5_JVP_ITERS = 10, 20
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

        kernel = launched_kernel(kind, model)
        out[key] = Case(op, plain, args, ops, f"at B={B} T={Tc} A={A}",
                        unread, dict(row=key, group="row", kernel=kernel,
                                     model=name, limits=limits, T=Tc,
                                     effort=effort(kind, Tc, n, m),
                                     bitwise=held_bitwise(kernel)))
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


def launcher_occupancy():
    """(kernel, model, limits) → (blocks an SM holds, threads per block,
    dynamic shared memory bytes per block) of the kernel that each model's
    sweep and whole-iteration launchers (in their three forms, limits None
    for the line search) and line-search launcher launch
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor through the launchers'
    ilqr_<model>_{sweep,iteration}[_fd|_jvp]_blocks_per_sm and
    ilqr_<model>_linesearch_blocks_per_sm), the backward kernel of each
    m = 1 package model (ilqr_backward_n<n>_blocks_per_sm), and the
    derivative kernel of every model, custom ones too, in both modes
    (ilqr_<model>_derivs_blocks_per_sm, the stencil mode keyed with _fd).
    Raises where a launcher's kernel is not the one launched_kernel names
    (a team or warp block is 128 threads, a one-thread block 64; only the
    warp kernels have dynamic shared memory; a sweep or whole-iteration
    launcher's ilqr_<model>_{sweep,iteration}[_fd|_jvp]_lane_threads is
    team_width's for a team, 32 for the warp, 1 for the one-thread
    kernel; every custom library's line search and stencil and
    dual-number sweep and iteration launchers (it has no closed forms) are
    held the same way; the backward kernel's block, at the lanes of the
    model's row, is a whole number of warps with its stage ring in dynamic
    shared memory; the derivative kernel's block is 256 threads, 32 lanes
    by 8 entries, with none), where an SM holds no block of it, or where a
    CUDA call failed (-1)."""
    lib, out = _build.library(), {}
    ptr = ctypes.POINTER(ctypes.c_int)
    m1 = [(name, get_model(name), lib, B_MAIN if name == "acrobot" else B_M)
          for name in kernel_rollout.FUSED_KERNEL_MODELS
          if get_model(name).m == 1]
    m1 += [(name, model, _build.lib_for(model), CUSTOM_B)
           for name, model in custom_models().items() if model.m == 1]
    for name, model, mlib, B in m1:
        # at the lanes of the model's backward row (the block's warps and
        # the copies' width follow B)
        fname = f"ilqr_backward_n{model.n}_blocks_per_sm"
        fn = getattr(mlib, fname)
        fn.argtypes, fn.restype = [ctypes.c_int] + [ptr] * 3, ctypes.c_int
        threads, smem, copy = (ctypes.c_int(0) for _ in range(3))
        blocks = fn(B, ctypes.byref(threads), ctypes.byref(smem),
                    ctypes.byref(copy))
        if (blocks <= 0 or threads.value not in (32, 64) or smem.value <= 0
                or copy.value not in (4, 16)):
            raise RuntimeError(f"{fname}({B}): {blocks} blocks of "
                               f"{threads.value} threads, {smem.value} B "
                               f"shared, {copy.value}-byte copies")
        out[("backward_team_kernel", name, backward_geometry(
            copy.value, threads.value // 32))] = (blocks, threads.value,
                                                  smem.value)
    fused_libs = [(name, get_model(name), lib, ("", "_fd", "_jvp"))
                  for name in kernel_rollout.FUSED_KERNEL_MODELS]
    fused_libs += [(name, model, _build.lib_for(model), ("_fd", "_jvp"))
                   for name, model in custom_models().items()]
    for name, model, mlib, all_forms in fused_libs:
        for kind in ("sweep", "iteration", "linesearch"):
            forms = ("",) if kind == "linesearch" else all_forms
            for suffix in forms:
                kernel = launched_kernel(kind, model,
                                         suffix.lstrip("_") or "analytic")
                warp = kernel in ("sweep_team_kernel",
                                  "iteration_warp_kernel")
                fname = f"ilqr_{name}_{kind}{suffix}_blocks_per_sm"
                fn = getattr(mlib, fname)
                fn.argtypes = ([ptr] * 2 if kind == "linesearch"
                               else [ctypes.c_int, ptr, ptr])
                fn.restype = ctypes.c_int
                for limits in ((None,) if kind == "linesearch"
                               else (True, False)):
                    threads, smem = ctypes.c_int(0), ctypes.c_int(0)
                    blocks = fn(*([] if limits is None else [int(limits)]),
                                ctypes.byref(threads), ctypes.byref(smem))
                    if (blocks <= 0 or (threads.value == 128)
                            != is_team(kernel) or (smem.value > 0) != warp):
                        raise RuntimeError(
                            f"{fname}({limits}): {blocks} blocks of "
                            f"{threads.value} threads, {smem.value} B shared "
                            f"(expected {kernel})")
                    out[(kernel + suffix, name, limits)] = (
                        blocks, threads.value, smem.value)
                if kind != "linesearch":
                    width = getattr(mlib, f"ilqr_{name}_{kind}{suffix}"
                                          "_lane_threads")
                    width.restype = ctypes.c_int
                    want = (team_width(model) if is_team(kernel)
                            and not warp else 32 if warp else 1)
                    if width() != want:
                        raise RuntimeError(
                            f"ilqr_{name}_{kind}{suffix}: {width()} "
                            f"threads a lane (expected {kernel}, {want})")
    derivs = [(name, lib, None) for name in kernel_derivs.DERIVS_KERNEL_MODELS]
    derivs += [(name, _build.lib_for(model), model)
               for name, model in custom_models().items()]
    for name, mlib, model in derivs:
        kernel = launched_kernel("derivs", model or get_model(name))
        fn = getattr(mlib, f"ilqr_{name}_derivs_blocks_per_sm")
        fn.argtypes, fn.restype = [ctypes.c_int, ptr, ptr], ctypes.c_int
        for fd in (0, 1):
            threads, smem = ctypes.c_int(0), ctypes.c_int(0)
            blocks = fn(fd, ctypes.byref(threads), ctypes.byref(smem))
            if blocks <= 0 or threads.value != 256 or smem.value:
                raise RuntimeError(
                    f"ilqr_{name}_derivs_blocks_per_sm({fd}): {blocks} "
                    f"blocks of {threads.value} threads, {smem.value} B "
                    f"shared (expected {kernel}: 256 threads, none)")
            out[(kernel + ("_fd" if fd else ""), name, None)] = (
                blocks, threads.value, smem.value)
    return out


def backward_geometry(copy_bytes: int, warps: int) -> str:
    """The third key of a backward kernel instantiation in ptxas_table and
    launcher_occupancy: its copies' width and its warps a block."""
    return f"{copy_bytes}-byte copies, {warps} warp{'s' * (warps > 1)}"


def ptxas_table(log: str):
    """(kernel, model, limits) → registers, spills and source file, from
    ptxas -v. The build log heads each source's report with "ptxas log of
    <file>": each csrc/kernels_<model>.cu (and kernels_<model>_iteration.cu,
    where a model's iteration kernels compile apart, and the stencil and
    dual-number instantiations' kernels_<model>[_iteration]_fd.cu and
    kernels_<model>[_iteration]_jvp.cu) instantiates one model, and
    kernels.cu is acrobot's. derivs_<model>.cu instantiates the derivative
    kernel for its model, and backward.cu the backward kernel's
    instantiations for each n (n = 2 filed under pendulum, n = 4 under
    acrobot and cartpole), each keyed by backward_geometry of its template
    arguments <N, VEC, WARPS> in place of the limits flag. The
    stencil and dual-number sweep, iteration and derivative kernels are
    filed as <kernel>_fd and <kernel>_jvp (the derivative kernel's jvp mode
    as derivs_entry_kernel, and a tree's before it as derivs_kernel)."""
    table, entry, model, source = {}, None, "acrobot", None
    for line in log.splitlines():
        if line.startswith("ptxas log of "):
            source = line[len("ptxas log of "):].strip()
            stem = source.removesuffix(".cu")
            model = (stem[len("kernels_"):].removesuffix("_fd")
                     .removesuffix("_jvp").removesuffix("_iteration")
                     if stem.startswith("kernels_") else
                     stem[len("derivs_"):] if stem.startswith("derivs_")
                     else "acrobot")
        elif "Compiling entry function" in line:
            name = line.split("'")[1]
            kernel = next((k for k in KERNEL_NAMES if k in name), name)
            limits = None   # the sweep and iteration kernels' template flag
            models = [model]
            if kernel in LIMITS_KERNELS:
                limits = "Lb1E" in name
            backward = kernel in ("backward_team_kernel", "backward_kernel")
            if not backward:
                if "FiniteDiff" in name:   # the stencil instantiations
                    kernel += "_fd"
                elif "Jvp" in name and not kernel.startswith("derivs_"):
                    kernel += "_jvp"
            if backward:
                models = (["pendulum"] if "ILi2E" in name
                          else ["acrobot", "cartpole"])
                targs = re.search(r"backward_team_kernelILi(\d+)ELi(\d+)"
                                  r"ELi(\d+)E", name)
                if targs:
                    limits = backward_geometry(4 * int(targs[2]),
                                               int(targs[3]))
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
        dev, "thruster_ring", "thruster_ring (m = 12, full width)", reps=1)
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
    cap_iters = RING24_ITERS
    print(f"[wide] thruster_ring24: one sweep launch {sweep_ms:.1f} ms at "
          f"B={B_M} T={T}; max_iter {cap_iters} (cut from {WIDE_ITERS})")
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

            kernel = launched_kernel(kind, model, mode)
            meta = dict(row=key, group=group,
                        kernel=kernel + ("_fd" if mode == "fd" else ""),
                        model=name, limits=limits, T=Tc,
                        effort=effort(kind, Tc, n, m) * (
                            4 if integ == "rk4" else 1),
                        bitwise=held_bitwise(kernel))
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
        # the RK4 twin at a cut depth (PERF.md §7)
        depth = {} if integ == "euler" else dict(max_iter=RK4_HEADLINE_ITERS)
        out, _c = run_fd_path(
            dev, "acrobot", f"acrobot {integ} (the CLI's batch solve"
            + (")" if integ == "euler" else
               f", max_iter {RK4_HEADLINE_ITERS}, cut from {CLI_ITERS})"),
            B=B_MAIN, profile=integ == "euler", integrator=integ, **depth)
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
    quad, qcost = run_fd_path(
        dev, "quadrotor", f"quadrotor fd + rk4 (max_iter {FD_WIDE_ITERS}, "
        f"cut from {CLI_ITERS})", integrator="rk4", max_iter=FD_WIDE_ITERS)
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
            # at most M5_FD_ITERS of secondary_bench.py's 40 iterations
            cap = min(M5_FD_ITERS, max(SHORT_ITERS, int(
                FD_CAP_S * 1e3 / (1.5 * sweep_ms))))
            print(f"[fd] {name}: one stencil sweep {sweep_ms:.1f} ms "
                  f"at B={B} T={T}; max_iter {cap} (cut from {CLI_ITERS}: "
                  f"at most {M5_FD_ITERS}, and one solve under "
                  f"{FD_CAP_S:g} s)")
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
            depth = ({} if merged_auto else dict(max_iter=M5_FD_ITERS))
            free, _c = run_fd_path(dev, name, f"{name} fd without limits",
                                   use_control_limits=False, **depth)
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
        kernel = launched_kernel(kind, model, "jvp")
        meta = dict(row=key, group="row", kernel=kernel + "_jvp",
                    model=name, limits=limits, T=Tb,
                    effort=8 * effort(kind, Tb, n, m),
                    source=f"ilqr_tpu_torch/csrc/{stem}",
                    bitwise=held_bitwise(kernel))
        out[f"{key} (rk4)"] = Case(op, plain, args, ops,
                                   f"at B={B} T={Tb} A={A}", unread, meta)
    return out


# The team kernel's edge cases (csrc/iteration_team.cuh): a partial last
# block, A = 1 and A = 7 candidates, every lane dead, NaN in one lane's x0
TEAM_EDGES = ("partial_block", "one_alpha", "seven_alphas", "all_dead",
              "nan_lane")
TEAM_PARTIAL_B = B_MAIN - 3   # the last block of 8 lanes holds 5
TEAM_EDGE_B, TEAM_EDGE_T = 1024, 100   # the other edge cases' lanes, steps


def team_cases(dev):
    """Acrobot's whole-iteration kernel, a team of 16 threads per lane, on
    its edge cases (TEAM_EDGES), each derived from a row's inputs: the
    flagship's analytic Euler (acrobot_cases), the CLI's stencils with
    Euler (fd_cases) and analytic + RK4 (jvp_cases): the partial block on
    the first 8189 lanes at T = 499, the others on the first TEAM_EDGE_B
    lanes and TEAM_EDGE_T steps (x_T the state there). Held bit for bit;
    their readings go into the row's edge_cases. Their plain versions run
    in the main process after the others (compare_edges): the dense ones
    hold every step's derivatives at once, several GB at B = 8189, too
    many beside the workers' own, and each takes seconds of host time per
    hundred steps."""
    bases = {
        "iteration_packed/acrobot": acrobot_cases(dev)["iteration_packed"],
        "iteration_packed/acrobot/fd": fd_cases(dev, "acrobot")[
            "iteration_packed/acrobot/fd (euler)"],
        "iteration_packed/acrobot/jvp": jvp_cases(dev, "acrobot")[
            "iteration_packed/acrobot/jvp (rk4)"]}
    out = {}
    for row, base in bases.items():
        a = list(base.args)   # x0 4, xs 5 … live 12, alphas 13
        for edge in TEAM_EDGES:
            args = list(a)
            if edge == "partial_block":
                B, Te = TEAM_PARTIAL_B, a[5].shape[0]
            else:
                B, Te = TEAM_EDGE_B, TEAM_EDGE_T
                args[6] = a[5][Te]   # x_T: the state after Te steps
                for i in (5, 7, 8, 9):   # xs, us, kold, Kold
                    args[i] = a[i][:Te]
            for i in range(4, 13):
                args[i] = args[i][..., :B].contiguous()
            if edge == "one_alpha":
                args[13] = a[13][:1].contiguous()
            elif edge == "seven_alphas":
                args[13] = a[13][:7].contiguous()
            elif edge == "all_dead":
                args[12] = torch.zeros_like(args[12])
            elif edge == "nan_lane":
                args[4][1, 5] = float("nan")
            meta = dict(base.meta, group="edge", edge=edge)
            # the row's operations, in proportion to the lane-steps
            share = B * Te / (a[4].shape[-1] * a[5].shape[0])
            out[f"{row} ({edge})"] = base._replace(
                args=tuple(args),
                ops=lambda f=base.ops, k=share: round(f() * k),
                where=f"at B={B} T={Te} A={args[13].shape[0]}", unread=None,
                meta=meta)
    return out


# The team sweeps' edge cases, on the first SWEEP_EDGE_T steps of a row's
# inputs at the row's lanes: a partial last block (3 lanes fewer: B = 1021
# leaves 1 lane in the last block of 4 of the warp sweep, 5 in the last of
# 8 of the 16-thread team, 1 in the last of 4 of the 32-thread one; acrobot
# B = 8189), NaN in one lane's x0, λ mixed so that some lanes latch div (a
# non-positive pivot), per-lane params (each lane's goal moved) and T = 1.
# By builder: the warp per lane (csrc/sweep_team.cuh) and the team of the
# model's whole iteration (csrc/iteration_team.cuh sweep_small_team_kernel,
# the stencil and dual-number forms: 16 threads a lane for acrobot,
# cartpole and the custom unicycle, 32 for point_mass_3d).
SWEEP_EDGES = ("partial_block", "nan_lane", "div_lanes", "per_lane", "T1")
SWEEP_EDGE_T = 4
SWEEP_EDGE_ROWS = {   # builder: row → (case builder, the case's label)
    "sweep_team": {
        "sweep_packed/thruster_ring": ("model", "sweep_packed/thruster_ring"),
        "sweep_packed/thruster_ring/fd": (
            "fd", "sweep_packed/thruster_ring/fd (euler)"),
        "sweep_packed/thruster_ring/jvp": (
            "jvp", "sweep_packed/thruster_ring/jvp (rk4)"),
        "sweep_packed/quadrotor": ("model", "sweep_packed/quadrotor"),
        "sweep_packed/quadrotor/fd": (
            "fd", "sweep_packed/quadrotor/fd (rk4)"),
        "sweep_packed/quadrotor/jvp": (
            "jvp", "sweep_packed/quadrotor/jvp (rk4)")},
    "sweep_small_team": {
        "sweep_packed/acrobot/fd": ("fd", "sweep_packed/acrobot/fd (euler)"),
        "sweep_packed/cartpole/fd": (
            "fd", "sweep_packed/cartpole/fd (euler)"),
        "sweep_packed/cartpole/jvp": (
            "jvp", "sweep_packed/cartpole/jvp (rk4)"),
        "sweep_packed/point_mass_3d/fd": (
            "fd", "sweep_packed/point_mass_3d/fd (euler)"),
        "sweep_packed/unicycle": (
            "custom", "sweep_packed/unicycle (jvp, euler)")},
}


def team_sweep(model) -> bool:
    """Whether ``model``'s merged sweep is the team kernel of
    csrc/sweep_team.cuh: the models whose iter_kernel="auto" takes the
    split iteration, m·n ≥ 32, the rule csrc/sweep_team.cuh's TeamSweep
    applies at compile time (launcher_occupancy checks the launchers' pick on
    the card)."""
    return not fused._use_iter_kernel(model, SolverConfig())


# The models whose whole iteration is csrc/iteration_team.cuh's team
# (Model::kTeamIteration in their headers), by its threads a lane
# (team::kTeamWidth: half a warp where the team's limits allow, else a warp)
TEAM_ITERATION = {"acrobot": 16, "cartpole": 16, "pendulum": 16,
                  "double_integrator": 32, "bicycle": 32, "power_mass": 32,
                  "point_mass_3d": 32}


def team_width(model) -> int:
    """Threads a lane of ``model``'s whole iteration on the team of
    csrc/iteration_team.cuh, 0 where it has none: TEAM_ITERATION's for the
    package's models, and for a custom model the (n, m) rule of its
    generated header (ops/codegen.team_width; 1 there is the one-thread
    kernel)."""
    if kernel_rollout.kernel_owner(model) is None:
        return TEAM_ITERATION.get(model.name, 0)
    width = codegen.team_width(model.n, model.m)
    return width if width > 1 else 0


def launched_kernel(kind, model, form="analytic") -> str:
    """The kernel that ``model``'s ``kind`` launcher launches, by the
    compile-time picks of csrc/kernels.cuh (launcher_occupancy checks them
    on the card): the backward kernel's team (csrc/backward.cuh), the
    derivative kernel's thread per (t, lane) (csrc/derivs.cuh) and the line
    search's team (csrc/linesearch_team.cuh) for every model, custom ones
    too; the whole iteration's team (csrc/iteration_team.cuh) where
    team_width is not 0 (TEAM_ITERATION, and the custom models inside the
    rule of csrc/custom.cuh team_iteration), and its merged sweep's in the
    stencil and dual-number forms (``form`` "fd" or "jvp"; the closed
    forms, "analytic", keep one thread a lane: csrc/sweep_team.cuh
    kSweepKind); for the package's models where team_sweep the sweep's and
    the whole iteration's warp (csrc/sweep_team.cuh,
    csrc/iteration_warp.cuh); otherwise, as for a custom model outside the
    team's rule, the one-thread kernel."""
    if kind == "backward":
        return "backward_team_kernel"
    if kind == "derivs":
        return "derivs_entry_kernel"
    if kind == "linesearch":
        return "linesearch_team_kernel"
    if kind == "iteration" and team_width(model):
        return "iteration_team_kernel"
    if kind == "sweep" and team_width(model) and form != "analytic":
        return "sweep_small_team_kernel"
    if (kind in ("sweep", "iteration")
            and kernel_rollout.kernel_owner(model) is None
            and team_sweep(model)):
        return {"sweep": "sweep_team_kernel",
                "iteration": "iteration_warp_kernel"}[kind]
    return f"{kind}_kernel"


def is_team(kernel) -> bool:
    """Whether ``kernel`` is one of the team or warp kernels (blocks of 128
    threads, several threads a lane)."""
    return "_team_kernel" in kernel or "_warp_kernel" in kernel


def held_bitwise(kernel) -> bool:
    """Whether phase 3 holds ``kernel`` bit for bit: the team and warp
    kernels, and the derivative kernel (csrc/derivs.cuh), whose threads
    store each entry as it is made."""
    return is_team(kernel) or kernel.startswith("derivs_entry_kernel")


def sweep_team_cases(dev, which):
    """The team sweeps of builder ``which`` (SWEEP_EDGE_ROWS): the warp
    sweep of thruster_ring (projected Newton, m = 12) and the quadrotor (the
    enumeration, m = 4) in its three forms; the split sweep on the team of
    the model's whole iteration (acrobot's stencils at B = 8192, cartpole's
    stencils and dual numbers, point_mass_3d's stencils on the 32-thread
    team). On their edge cases (SWEEP_EDGES), each derived from a
    phase-3 row's inputs. Held bit for bit; their readings go into the
    row's edge_cases. Their plain versions (a few steps each) run in a
    worker like the rows' (meta main False), not in the main process after
    the workers as the team iteration's do."""
    builders, out = {}, {}
    for row, (builder, label) in SWEEP_EDGE_ROWS[which].items():
        name = row.split("/")[1]
        if (builder, name) not in builders:
            builders[(builder, name)] = build_cases(dev, (builder, name))
        base = builders[(builder, name)][label]
        a = list(base.args)   # model 0, integrator 1, pp 2, xs 3, xT 4,
        #                       us 5, λ 6 (then mode, limits)
        B0 = a[5].shape[-1]
        for edge in SWEEP_EDGES:
            Te = 1 if edge == "T1" else SWEEP_EDGE_T
            B = B0 - 3 if edge == "partial_block" else B0
            args = list(a)
            args[3] = a[3][:Te, :, :B].contiguous()
            args[4] = a[3][Te, :, :B].contiguous()   # x_T: the state there
            args[5] = a[5][:Te, :, :B].contiguous()
            args[6] = a[6][:B].contiguous()
            rng = np.random.default_rng(SWEEP_EDGES.index(edge))
            if edge == "nan_lane":   # a copy: the slice may share storage
                args[3] = args[3].clone()
                args[3][0, :, 5] = float("nan")
            elif edge == "div_lanes":
                args[6] = torch.as_tensor(
                    rng.choice([1e-6, 1.0, 10.0, -50.0], size=B),
                    dtype=torch.float32, device=dev)
            elif edge == "per_lane":
                pp, n = a[2], a[0].n
                rows = pp.vec[None].repeat(B, 1)
                rows[:, :n] += torch.as_tensor(
                    0.1 * rng.normal(size=(B, n)), dtype=torch.float32,
                    device=dev)
                args[2] = kernel_rollout.PackedParams(rows.contiguous(),
                                                      pp.cls, pp.shapes)
            share = B * Te / (a[5].shape[-1] * a[5].shape[0])
            out[f"{row} ({edge})"] = base._replace(
                args=tuple(args),
                ops=lambda f=base.ops, k=share: round(f() * k),
                where=f"at B={B} T={Te}", unread=None,
                meta=dict(base.meta, row=row, group="edge", edge=edge,
                          effort=round(base.meta["effort"] * share),
                          main=False))
        del base
    return out


# The edge cases of the line search's team (csrc/linesearch_team.cuh), the
# 16-thread whole iteration of cartpole and pendulum and the 32-thread one of
# the m = 2-3 models (csrc/iteration_team.cuh), the warp iteration
# (csrc/iteration_warp.cuh), the custom models' line search and whole
# iteration on those teams (16 threads a lane for the unicycle and
# unicycle_heading: generated Params, arrays where the package's models hold
# scalars) and the backward kernel's team
# (csrc/backward.cuh), each derived from a phase-3 row's inputs (row →
# (case builder, the case's label)): a partial last block (B = 1021: 5
# lanes in the last block of 8, 1 in the last of 4), A = 1 and A = 7
# candidates (the row's A = 11), every lane dead (no step taken, no gain
# kept), NaN in one lane's x0, and for the line search the row's clamp
# flipped (the pendulum's and ring24's rollouts unclamped; the iteration
# rows' unconstrained twins are rows of their own). The iteration edges run
# on the first EDGE_T[builder] steps. The backward kernel's (BACKWARD_EDGES)
# are its own: a partial last block, T = 1, NaN in one lane's fx, λ = −50
# on every third lane (QuuF ≤ 0 latches div), limits a hundredth as wide
# (clamped controls) and λ mixed over {0, 1e-6, 1, 10, 1e3}.
LINESEARCH_EDGES = ("partial_block", "one_alpha", "seven_alphas", "all_dead",
                    "nan_lane", "clamp_flipped")
ITERATION_EDGES = LINESEARCH_EDGES[:-1]
EDGE_ROWS = {
    "linesearch_team": {
        "linesearch_packed/pendulum": ("model", "linesearch_packed/pendulum"),
        "linesearch_packed/quadrotor": (   # its RK4 reading's inputs
            "fd", "linesearch_packed/quadrotor (rk4)"),
        "linesearch_packed/thruster_ring24": (
            "model", "linesearch_packed/thruster_ring24")},
    "iteration_team": {
        "iteration_packed/cartpole": ("model", "iteration_packed/cartpole"),
        "iteration_packed/cartpole/fd": (
            "fd", "iteration_packed/cartpole/fd (euler)"),
        "iteration_packed/cartpole/jvp": (
            "jvp", "iteration_packed/cartpole/jvp (rk4)"),
        "iteration_packed/pendulum": ("model", "iteration_packed/pendulum")},
    "iteration_warp": {
        "iteration_packed/thruster_ring": (
            "model", "iteration_packed/thruster_ring"),
        "iteration_packed/thruster_ring/fd": (
            "fd", "iteration_packed/thruster_ring/fd (euler)"),
        "iteration_packed/thruster_ring/jvp": (
            "jvp", "iteration_packed/thruster_ring/jvp (rk4)"),
        "iteration_packed/quadrotor/fd": (
            "fd", "iteration_packed/quadrotor/fd (euler)")},
    "iteration_team32": {
        "iteration_packed/point_mass_3d": (
            "model", "iteration_packed/point_mass_3d"),
        "iteration_packed/power_mass/fd": (
            "fd", "iteration_packed/power_mass/fd (euler)"),
        "iteration_packed/bicycle/jvp": (
            "jvp", "iteration_packed/bicycle/jvp (rk4)")},
    "custom_team": {
        "linesearch_packed/unicycle": (
            "custom", "linesearch_packed/unicycle (euler)"),
        "linesearch_packed/unicycle_heading": (
            "custom", "linesearch_packed/unicycle_heading (euler)"),
        "iteration_packed/unicycle": (
            "custom", "iteration_packed/unicycle (jvp, euler)"),
        "iteration_packed/unicycle_heading": (
            "custom", "iteration_packed/unicycle_heading (jvp, euler)")},
    "backward_team": {
        "backward_sweep_packed/cartpole": (
            "split", "backward_sweep_packed/cartpole"),
        "backward_sweep_packed/pendulum": (
            "split", "backward_sweep_packed/pendulum")}}
EDGE_T = {"linesearch_team": None, "iteration_team": 40, "iteration_warp": 4,
          "iteration_team32": 40, "custom_team": 40}
BACKWARD_EDGES = ("partial_block", "T1", "nan_lane", "div_lanes", "clamped",
                  "mixed_lam")
# argument positions by kernel: x0, the state trajectory, x_T, the other
# per-step tensors, the other per-lane tensors, α, the gates
EDGE_ARGS = {"iteration": (4, 5, 6, (7, 8, 9), (10, 11, 12), 13, (12,)),
             "linesearch": (4, 6, 7, (5, 8, 9, 10, 11), (13, 14, 15, 16), 12,
                            (15, 16))}


def edge_cases(dev, which):
    """The edge cases of builder ``which`` (EDGE_ROWS), each derived from a
    phase-3 row's inputs. Held bit for bit; their readings go into the
    row's edge_cases. Their plain versions run in a worker like the rows'
    (meta main False)."""
    builders, out = {}, {}
    for row, (builder, label) in EDGE_ROWS[which].items():
        name = row.split("/")[1]
        if (builder, name) not in builders:
            builders[(builder, name)] = build_cases(dev, (builder, name))
        base = builders[(builder, name)][label]
        kind = row.split("_")[0]
        if kind == "backward":
            out.update(backward_edges(row, base))
            continue
        x0_i, xs_i, xT_i, steps, lanes, al_i, gates = EDGE_ARGS[kind]
        a = list(base.args)
        T0 = a[xs_i].shape[0]
        Te = min(T0, EDGE_T[which] or T0)
        edges = LINESEARCH_EDGES if kind == "linesearch" else ITERATION_EDGES
        for edge in edges:
            B = B_M - 3 if edge == "partial_block" else B_M
            args = list(a)
            if Te < T0:   # x_T: the state after Te steps
                args[xT_i] = a[xs_i][Te]
            for i in (xs_i, *steps):
                args[i] = a[i][:Te]
            for i in (x0_i, xs_i, xT_i, *steps, *lanes):
                args[i] = args[i][..., :B].contiguous().clone()
            if edge == "one_alpha":
                args[al_i] = a[al_i][:1].contiguous()
            elif edge == "seven_alphas":
                args[al_i] = a[al_i][:7].contiguous()
            elif edge == "all_dead":
                for i in gates:
                    args[i] = torch.zeros_like(args[i])
            elif edge == "nan_lane":
                args[x0_i][:, 5] = float("nan")
            elif edge == "clamp_flipped":
                args[2] = not a[2]
            share = B * Te / (a[x0_i].shape[-1] * T0)
            out[f"{row} ({edge})"] = base._replace(
                args=tuple(args),
                ops=lambda f=base.ops, k=share: round(f() * k),
                where=f"at B={B} T={Te} A={args[al_i].shape[0]}", unread=None,
                meta=dict(base.meta, row=row, group="edge", edge=edge,
                          effort=round(base.meta["effort"] * share),
                          main=False))
        del base
    return out


# The derivative kernel's edge cases (csrc/derivs.cuh), on the first
# DERIVS_EDGE_T steps of a row's inputs, in jvp mode and fd mode (the
# latter's as fd_<edge>): 3 lanes short of the row's (B not a multiple of a
# block's 32 lanes), T = 1, NaN in one lane's x0, and per-lane params (each
# lane's goal moved). Rows: acrobot at B = 8192, point_mass_3d, the largest
# stack before this design (thruster_ring24) and the custom unicycle
# (row → (case builder, model, the jvp and fd cases' labels)).
DERIVS_EDGES = ("partial_block", "T1", "nan_lane", "per_lane")
DERIVS_EDGE_T = 20
DERIVS_EDGE_ROWS = {
    "derivs_packed/acrobot": ("acrobot", "acrobot", (
        "derivs_packed (jvp)", "derivs_packed (fd)")),
    "derivs_packed/point_mass_3d": ("derivs", "point_mass_3d", (
        "derivs_packed/point_mass_3d (jvp, euler)",
        "derivs_packed/point_mass_3d (fd, euler)")),
    "derivs_packed/thruster_ring24": ("derivs", "thruster_ring24", (
        "derivs_packed/thruster_ring24 (jvp, euler)",
        "derivs_packed/thruster_ring24 (fd, euler)")),
    "derivs_packed/unicycle": ("custom", "unicycle", (
        "derivs_packed/unicycle (jvp)", "derivs_packed/unicycle (fd)"))}


def derivs_edge_cases(dev):
    """DERIVS_EDGES of DERIVS_EDGE_ROWS, each derived from a phase-3 case's
    inputs (args: model, integrator, pp, xs (T+1, n, B), us (T, m, B),
    mode[, eps]). Held bit for bit; their readings go into the row's
    edge_cases. Their plain versions run in a worker (meta main False)."""
    builders, out = {}, {}
    for row, (builder, name, labels) in DERIVS_EDGE_ROWS.items():
        if (builder, name) not in builders:
            builders[(builder, name)] = build_cases(dev, (builder, name))
        for label in labels:
            base = builders[(builder, name)][label]
            a = list(base.args)
            T0, B0 = a[4].shape[0], a[4].shape[-1]
            for i, edge in enumerate(DERIVS_EDGES):
                Te = 1 if edge == "T1" else min(T0, DERIVS_EDGE_T)
                B = B0 - 3 if edge == "partial_block" else B0
                args = list(a)
                args[3] = a[3][:Te + 1, :, :B].contiguous().clone()
                args[4] = a[4][:Te, :, :B].contiguous()
                rng = np.random.default_rng(i)
                if edge == "nan_lane":
                    args[3][0, :, 5] = float("nan")
                elif edge == "per_lane":
                    pp, n = a[2], a[0].n
                    rows = pp.vec[None].repeat(B, 1)
                    rows[:, :n] += torch.as_tensor(
                        0.1 * rng.normal(size=(B, n)), dtype=torch.float32,
                        device=dev)
                    args[2] = kernel_rollout.PackedParams(
                        rows.contiguous(), pp.cls, pp.shapes)
                share = B * Te / (B0 * T0)
                mode = a[5]
                out[f"{row} ({mode}, {edge})"] = base._replace(
                    args=tuple(args),
                    ops=lambda f=base.ops, k=share: round(f() * k),
                    where=f"at B={B} T={Te}", unread=None,
                    meta=dict(base.meta, row=row, group="edge",
                              edge=edge if mode == "jvp" else f"fd_{edge}",
                              effort=round(base.meta["effort"] * share),
                              main=False))
            del base
    return out


def backward_edges(row, base):
    """BACKWARD_EDGES of the backward kernel's phase-3 row ``row``, from its
    case ``base`` (args: fx, fu, cx, cu, cxx, cxu, cuu, lo, hi, λ, cxT,
    cxxT, lane last, time first)."""
    a = list(base.args)
    T0, B0 = a[1].shape[0], a[1].shape[-1]
    out = {}
    for i, edge in enumerate(BACKWARD_EDGES):
        B = B_M - 3 if edge == "partial_block" else B_M
        Te = 1 if edge == "T1" else T0
        rng = np.random.default_rng(i)
        args = [t[:Te] if j < 9 else t for j, t in enumerate(a)]
        args = [t[..., :B].contiguous().clone() for t in args]
        if edge == "nan_lane":
            args[0][Te // 2, 0, 0, 5] = float("nan")
        elif edge == "div_lanes":
            args[9][::3] = -50.0
        elif edge == "clamped":
            args[7] *= 0.01
            args[8] *= 0.01
        elif edge == "mixed_lam":
            args[9] = torch.as_tensor(
                rng.choice([0.0, 1e-6, 1.0, 10.0, 1e3], size=B),
                dtype=torch.float32, device=args[9].device)
        share = B * Te / (B0 * T0)
        out[f"{row} ({edge})"] = base._replace(
            args=tuple(args), ops=lambda f=base.ops, k=share: round(f() * k),
            where=f"at B={B} T={Te}", unread=None,
            meta=dict(base.meta, row=row, group="edge", edge=edge,
                      effort=round(base.meta["effort"] * share), main=False))
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
    src = f"ilqr_tpu_torch/csrc/derivs_{name}.cu"
    readings = [("jvp", "rk4", "rk4"), ("fd", "rk4", "rk4_fd")]
    if name != "acrobot":
        readings = [("jvp", "euler", "row"), ("fd", "euler", "fd_of")] + (
            readings)
    for mode, integ, group in readings:
        meta = dict(row=f"derivs_packed/{name}", group=group,
                    kernel=launched_kernel("derivs", model), model=name,
                    limits=True, T=T, effort=effort("derivs", T, n, m)
                    * (4 if integ == "rk4" else 1), source=src,
                    bitwise=True)
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
             kernel=launched_kernel("backward", model), model=name,
             limits=True, T=T, effort=effort("backward", T, n, m),
             source="ilqr_tpu_torch/csrc/backward.cu", bitwise=True))
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
                          f"acrobot analytic + rk4 (the CLI's batch solve, "
                          f"max_iter {RK4_HEADLINE_ITERS}, cut from "
                          f"{CLI_ITERS})", B=B_MAIN, profile=True,
                          max_iter=RK4_HEADLINE_ITERS, **jvp)
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
            cap = CLI_ITERS if merged_auto else M5_JVP_ITERS
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
                cap = min(cap, max(SHORT_ITERS, int(
                    FD_CAP_S * 1e3 / (1.5 * sweep_ms))))
                print(f"[jvp] {name}: one JVP sweep {sweep_ms:.1f} ms at "
                      f"B={B} T={T}; max_iter {cap} (cut from {CLI_ITERS}: "
                      f"at most {M5_JVP_ITERS}, and one solve under "
                      f"{FD_CAP_S:g} s)")
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
                                   "without limits", max_iter=cap,
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
            dict(row=row, group="lanes", kernel=launched_kernel(kind, model),
                 model=name, limits=True, T=T, effort=effort(kind, T, n, m),
                 bitwise=held_bitwise(launched_kernel(kind, model))))
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


# ---------------------------------------------------------------------------
# Phase 14: the composable solver at m ≥ 2 (solve, solve_verbose,
# solve_batch, the single-controller MPC) on the derivative kernel of every
# model. Its backward pass at m ≥ 2 is the JAX package's scan with its QPs
# (ops/boxqp.py) in plain PyTorch on the card, as the JAX package runs them
# in XLA: no Pallas kernel computes them.

COMP_MODELS = ("double_integrator", "point_mass_3d", "quadrotor", "bicycle",
               "power_mass", "omni_thruster", "free_flyer", "thruster_ring",
               "thruster_ring16", "thruster_ring20", "thruster_ring24")
# (c) the short composable batch solves of each model's widths: B lanes,
# T steps, a few iterations, each with the QP mode or option it covers
COMP_B, COMP_T, COMP_ITERS, COMP_DT = 64, 20, 3, 0.05
COMP_EXTRA = {"double_integrator": dict(integrator="rk4"),
              "omni_thruster": dict(boxqp_mode="pn_fixed")}
COMP_PER_LANE = ("power_mass",)
# (b) examples/quadrotor_waypoints.py --vmap: B, T, dt, and max_iter cut
# from the example's 40 (PERF.md §7: ~0.9 s per host iteration)
WP_B, WP_T, WP_ITERS, WP_DT = 256, 80, 10, 0.02
WP_FUSED_TOL = 0.02      # mean cost against the fused solver's
WP_CPU = (4, 20, 5)      # card against the CPU: lanes, T, iterations
# (c)'s card solves against the CPU on their first CPU_LANES lanes (each
# lane's iterates do not depend on the others)
CPU_LANES = 8
# (a) the CLI's integrator problem, run_ilqr integrator
# (ilqr_tpu/__main__.py:232-236): the reference converges in 14
# iterations (golden/README.md)
INTEG_T, INTEG_DT, REF_ITERS = 99, 0.02, 14
# (a)'s iterations on the card against the CPU's (ROADMAP §C1): the reason
# must match and the count lie within this band, which the witness below
# measured (18 on the card, 15 on the CPU: PERF.md §6, ROADMAP §C1)
C1_ITER_BAND = 3
# (d) tests/test_mpc.py:14-31's controller
MPC_T, MPC_DT, MPC_STEPS, MPC_REL = 40, 0.05, 20, 1e-4


def comp_problem(name):
    """(model, params, cfg, dt, x0 (B, n), u0 (T_c, m), params_batched) of
    phase 14 (c)'s short solve of ``name``: 0.3·normal x0 from
    default_rng(5), hover or zero u0, analytic, clamped; power_mass with
    one row of params per lane (every leaf × U(0.8, 1.2))."""
    model = get_model(name)
    params = model.default_params()
    B, T_c = COMP_B, COMP_T
    rng = np.random.default_rng(5)
    x0 = (0.3 * rng.normal(size=(B, model.n))).astype(np.float32)
    hover = {"quadrotor": quadrotor, "omni_thruster": omni_thruster}
    u0 = (np.tile(hover[name].hover_control(params).numpy()[None], (T_c, 1))
          if name in hover else np.zeros((T_c, model.m))).astype(np.float32)
    batched = name in COMP_PER_LANE
    if batched:
        params = type(params)(*[
            (np.asarray(v, np.float32)[None] * rng.uniform(
                0.8, 1.2, size=(B,) + tuple(np.shape(v)))).astype(np.float32)
            for v in params])
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=COMP_ITERS, **COMP_EXTRA.get(name, {}))
    return model, params, cfg, COMP_DT, x0, u0, batched


def derivs_cases(dev, name):
    """derivs_packed of ``name`` at the shapes of its phase-14 paths, on
    each path's open-loop rollout: jvp mode with the Euler step (the row)
    and fd mode (its fd_* fields) at (c)'s B = 64, T = 20, the quadrotor at
    (b)'s B = 256, T = 80, the double integrator at (d)'s B = 1, T = 40
    (its fd mode at (a)'s T = 99 and its RK4 reading at (c)'s); power_mass
    also with one row of params per lane (the lanes_* reading)."""
    model, params, cfg, dt, x0, u0, batched = comp_problem(name)
    shapes = {"row": (COMP_B, COMP_T, "euler"), "fd_of": (COMP_B, COMP_T,
                                                          "euler")}
    if name == "quadrotor":
        shapes = {"row": (WP_B, WP_T, "euler"), "fd_of": (WP_B, WP_T,
                                                          "euler")}
    elif name == "double_integrator":
        shapes = {"row": (1, MPC_T, "euler"), "fd_of": (1, INTEG_T, "euler"),
                  "rk4": (COMP_B, COMP_T, "rk4")}
    elif batched:
        shapes["lanes"] = (COMP_B, COMP_T, "euler")
    shared = model.default_params()
    n, m = model.n, model.m
    pp_cpu = kernel_rollout.pack_params(shared, dt)
    lane_rng = np.random.default_rng(3)

    def lane_inputs(t):
        xs = torch.as_tensor(0.3 * lane_rng.normal(size=(t + 1, n, 1)),
                             dtype=torch.float32)
        us = torch.as_tensor(lane_rng.normal(size=(t, m, 1)),
                             dtype=torch.float32)
        return xs, us

    out = {}
    for group, (B, Tc, integ) in shapes.items():
        mode = "fd" if group == "fd_of" else "jvp"
        pp = (kernel_rollout.pack_params_batched(params, dt, dev)
              if group == "lanes" else kernel_rollout.pack_params(shared, dt,
                                                                  dev))
        xb = torch.as_tensor(np.resize(x0, (B, n)), device=dev)
        ub = torch.as_tensor(np.resize(u0, (Tc, m)), device=dev)
        z = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=dev)
        xs, us, xT, _c = kernel_rollout.rollout_packed(
            model, integ, True, pp, xb.t().contiguous(),
            ub[:, :, None].expand(Tc, m, B).contiguous(), z(Tc, n, B),
            z(Tc, m, n, B))
        xs_full = torch.cat([xs, xT[None]]).contiguous()

        def ops(mode=mode, integ=integ, Tc=Tc, B=B):
            step, rest = ops_per_step(lambda t: kernel_derivs.derivs_plain(
                model, integ, pp_cpu, *lane_inputs(t), mode=mode))
            return step * Tc * B + rest * B

        meta = dict(row=f"derivs_packed/{name}", group=group,
                    kernel=launched_kernel("derivs", model), model=name,
                    limits=True, T=Tc,
                    effort=effort("derivs", Tc, n, m) * B // 64 * (n + m),
                    source=f"ilqr_tpu_torch/csrc/derivs_{name}.cu",
                    bitwise=True)
        label = f"derivs_packed/{name} ({mode}, {integ}" + (
            ", per-lane params)" if group == "lanes" else ")")
        out[label] = Case(kernel_derivs.derivs_packed,
                          kernel_derivs.derivs_plain,
                          (model, integ, pp, xs_full, us, mode),
                          ops, f"at B={B} T={Tc}", None, meta)
    return out


def _comp_counters():
    """Sets the composable path's launch and host counters to 0."""
    reset_launch_counts()
    solver._host_any.syncs = 0
    solver.ilqr_iteration.calls = 0
    solver.ilqr_iteration.retried = 0
    boxqp.boxqp.iterations = 0


def _comp_stats(wall):
    """The counters since _comp_counters, per host iteration."""
    iters = max(1, solver.ilqr_iteration.calls)
    c = launch_counts()
    return dict(wall_s=wall, launches=c, host_iterations=iters,
                host_syncs=solver._host_any.syncs,
                syncs_per_iteration=solver._host_any.syncs / iters,
                qp_loop_passes=boxqp.boxqp.iterations,
                launches_per_iteration=sum(c.values()) / iters,
                retried_share=solver.ilqr_iteration.retried / iters,
                ms_per_iteration=wall * 1e3 / iters)


def _read_golden():
    rows = [[float(v) for v in line.replace(",", " ").split()]
            for line in open(GOLDEN_CSV).read().splitlines()[1:]]
    return np.asarray([r[4:6] for r in rows[:-1]])


def _recorded_verbose(model, params, cfg, dt, x0, u0, device=None):
    """solve_verbose with each iteration's row recorded: its input state
    (on the CPU), cost, λ, dcost, expected, the line search's α, and
    whether the step was taken. Returns (Solution, rows)."""
    rows = []
    it_fn, ls_fn = solver.ilqr_iteration, solver.line_search

    def line_search(*a, **k):
        out = ls_fn(*a, **k)
        rows[-1]["alpha"] = float(out.alpha[0])
        return out

    def iteration(model_, pp, cfg_, state, live):
        rows.append(dict(state=[t.cpu() for t in state]))
        out = it_fn(model_, pp, cfg_, state, live)
        rows[-1].update(cost=float(out.cost[0]), lam=float(out.lam[0]),
                        dcost=float(out.dcost[0]),
                        expected=float(out.expected[0]),
                        taken=bool(out.step_accepted[0]))
        return out

    iteration.calls, iteration.retried = it_fn.calls, it_fn.retried
    solver.ilqr_iteration, solver.line_search = iteration, line_search
    try:
        sol = solver.solve_verbose(model, params, cfg, dt, x0, u0,
                                   device=device)
    finally:
        solver.ilqr_iteration, solver.line_search = it_fn, ls_fn
        it_fn.calls, it_fn.retried = iteration.calls, iteration.retried
    return sol, rows


def _integrator_problem():
    model = get_model("double_integrator")
    params = double_integrator.default_params(goal=(1.0, 0.5, 0.0, 0.0))
    cfg = SolverConfig(deriv_mode="fd", clamp_forward=False)
    x0 = np.asarray([-1.0, 0.0, 0.0, -0.2], np.float32)
    return model, params, cfg, x0, np.zeros((INTEG_T, 2), np.float32)


def _integrator_cpu_job(_arg):
    """In a worker process: (a)'s solve_verbose on the CPU, recorded (its
    table printed to a buffer)."""
    import io

    torch.set_num_threads(1)
    model, params, cfg, x0, u0 = _integrator_problem()
    with contextlib.redirect_stdout(io.StringIO()):
        sol, rows = _recorded_verbose(model, params, cfg, INTEG_DT, x0, u0,
                                      device="cpu")
    return dict(rows=rows, iterations=int(sol.iterations),
                reason=TerminationReason(int(sol.reason)).name)


def _stage_witness(dev, model, params, cfg, state):
    """One iteration's stages from the same input ``state`` (the CPU's) on
    the card and the CPU: each stage's max |a − b| / (1 + |b|) between the
    devices, every later stage fed the CPU's outputs of the ones before."""
    from ilqr_tpu_torch.ops import backward as bw
    from ilqr_tpu_torch.ops import derivatives as dv
    from ilqr_tpu_torch.ops import rollout as ro
    from ilqr_tpu_torch.types import Derivs, SolverState

    def rel(a, b):
        a, b = a.double().cpu(), b.double().cpu()
        return float(((a - b).abs() / (1.0 + b.abs())).max())

    sc = SolverState(*state)
    sd = SolverState(*(t.to(dev) for t in state))
    pc = kernel_rollout.pack_params(params, INTEG_DT)
    pd = kernel_rollout.pack_params(params, INTEG_DT, dev)
    out = {}
    d_c = dv.compute_derivs(model, pc, cfg, sc.xs, sc.us)
    d_d = dv.compute_derivs(model, pd, cfg, sd.xs, sd.us)
    out["derivatives"] = max(rel(a, b) for a, b in zip(d_d, d_c))
    b_c = bw.backward_pass(d_c, sc.us, sc.lam, *solver.limits(pc), cfg,
                           prev_k_last=sc.k[:, -1])
    b_d = bw.backward_pass(Derivs(*(a.to(dev) for a in d_c)), sd.us, sd.lam,
                           *solver.limits(pd), cfg, prev_k_last=sd.k[:, -1])
    out["backward pass"] = max(rel(getattr(b_d, f), getattr(b_c, f))
                               for f in ("k", "K", "dV"))
    l_c = ro.line_search(model, pc, cfg, sc.xs[:, 0], sc.xs, sc.us, b_c.k,
                         b_c.K, b_c.dV, sc.cost)
    l_d = ro.line_search(model, pd, cfg, sd.xs[:, 0], sd.xs, sd.us,
                         b_c.k.to(dev), b_c.K.to(dev), b_c.dV.to(dev),
                         sd.cost)
    out["line search"] = max(rel(getattr(l_d, f), getattr(l_c, f))
                             for f in ("cost", "dcost", "expected", "alpha"))
    return out


def c1_witness(dev, card_rows, cpu):
    """ROADMAP §C1: the card's and the CPU's (a) rows side by side up to the
    first iteration where they part (a step taken on one side only, or λ or
    the cost apart by more than 1e-6 relative), and the stages of the first
    iteration whose row differs at all, run from the CPU's input state on
    both devices."""
    model, params, cfg, _x0, _u0 = _integrator_problem()
    keys = ("cost", "lam", "dcost", "expected", "alpha", "taken")
    first_diff = parted = None
    print("[composable] (a) C1 witness: iteration | card: cost λ dcost "
          "expected α taken | CPU: the same")
    for i, (rc, rh) in enumerate(zip(card_rows, cpu["rows"])):
        print(f"[composable] (a)   {i:3d} | "
              + " ".join(f"{rc.get(k)!r}" for k in keys) + " | "
              + " ".join(f"{rh.get(k)!r}" for k in keys))
        if first_diff is None and any(rc.get(k) != rh.get(k) for k in keys):
            first_diff = i
        close = lambda a, b: abs(a - b) <= 1e-6 * max(abs(a), abs(b), 1e-30)
        if parted is None and (rc["taken"] != rh["taken"]
                               or not close(rc["lam"], rh["lam"])
                               or not close(rc["cost"], rh["cost"])):
            parted = i
            break
    out = dict(card_iterations=len(card_rows),
               cpu_iterations=cpu["iterations"], cpu_reason=cpu["reason"],
               first_differing_iteration=first_diff,
               parting_iteration=parted)
    if first_diff is not None:
        stages = _stage_witness(dev, model, params, cfg,
                                cpu["rows"][first_diff]["state"])
        first = next((k for k, v in stages.items() if v > 0.0), None)
        cost = cpu["rows"][first_diff]["cost"]
        eps = cfg.fd_eps
        noise = float(np.spacing(np.float32(cost))) / (4.0 * eps * eps)
        out.update(stages=stages, first_stage=first,
                   stencil_noise=noise)
        print(f"[composable] (a) C1 witness: rows first differ at iteration "
              f"{first_diff}, part at {parted}; from the CPU's input state "
              f"of iteration {first_diff}, card against CPU, max |a−b|/"
              f"(1+|b|) by stage: "
              + ", ".join(f"{k} {v:.3e}" for k, v in stages.items())
              + f"; first stage apart: {first}; the stencils' f32 noise "
              f"ulp(cost)/(4·eps²) = {noise:.3g} (cost {cost:.6g}, eps "
              f"{eps:g})")
    return out


def run_integrator_path(dev, cpu_job):
    """(a): the CLI's integrator problem through solve_verbose on the card,
    against golden/integrator_golden.csv, and against the same solve on
    the CPU (``cpu_job``, an async result of _integrator_cpu_job) by the
    C1 witness: the reason equal, the iterations within C1_ITER_BAND."""
    model, params, cfg, x0, u0 = _integrator_problem()
    _comp_counters()
    t0 = time.perf_counter()
    sol, card_rows = _recorded_verbose(model, params, cfg, INTEG_DT, x0, u0)
    cost, us = float(sol.cost.item()), sol.us.cpu().numpy()
    wall = time.perf_counter() - t0
    out = _comp_stats(wall)
    us_err = float(np.abs(us - _read_golden()).max())
    reason = TerminationReason(int(sol.reason.item())).name
    out.update(cost=cost, golden_cost=GOLDEN_COST, max_us_err=us_err,
               reason=reason, iterations=int(sol.iterations.item()),
               reference_iterations=REF_ITERS)
    print(f"[composable] (a) run_ilqr integrator on the card (fd, iterative "
          f"QP, unclamped, Euler, T={INTEG_T}): cost {cost:.4f} (reference "
          f"{GOLDEN_COST}, ≤ {GOLDEN_COST_TOL}), max |u − u_ref| {us_err:.2e}"
          f" (≤ {GOLDEN_US_TOL:g}), {out['iterations']} iterations (the "
          f"reference's f64 solve: {REF_ITERS}, FUN_TOL), reason {reason}; "
          f"{wall:.2f} s, {out['ms_per_iteration']:.1f} ms/iteration, "
          f"{out['syncs_per_iteration']:.1f} host syncs/iteration, "
          f"{out['launches_per_iteration']:.2f} kernel launches/iteration "
          f"({out['launches']})")
    if not (abs(cost - GOLDEN_COST) <= GOLDEN_COST_TOL
            and us_err <= GOLDEN_US_TOL):
        raise AssertionError("the integrator left the reference's solution")
    if out["launches"]["derivs_packed"] < 1:
        raise AssertionError("(a) never launched derivs_packed")
    cpu = cpu_job.get()[0]
    out["c1"] = c1_witness(dev, card_rows, cpu)
    print(f"[composable] (a) iterations: card {out['iterations']} "
          f"({reason}), CPU {cpu['iterations']} ({cpu['reason']}); band "
          f"±{C1_ITER_BAND}")
    if (reason != cpu["reason"] or abs(out["iterations"] - cpu["iterations"])
            > C1_ITER_BAND):
        raise AssertionError("(a) the card's iterations or reason left the "
                             "CPU's band")
    return out


def run_waypoints_path(dev):
    """(b): examples/quadrotor_waypoints.py --vmap on the card."""
    model = get_model("quadrotor")
    params = model.default_params()
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=WP_ITERS)
    rng = np.random.default_rng(0)
    x0 = (0.1 * rng.normal(size=(WP_B, 12))).astype(np.float32)
    u0 = np.tile(quadrotor.hover_control(params).numpy()[None],
                 (WP_T, 1)).astype(np.float32)
    _comp_counters()
    t0 = time.perf_counter()
    sol = solve_batch(model, params, cfg, WP_DT, x0, u0)
    host = {k: v.cpu().numpy() for k, v in sol._asdict().items()}
    wall = time.perf_counter() - t0
    out = _comp_stats(wall)
    cost = host["cost"]
    init = _initial_costs(dev, model, kernel_rollout.pack_params(
        params, WP_DT, dev), WP_T, u0, x0)
    fsol = solve_batch_fused(model, params, cfg, WP_DT, x0, u0)
    fcost = fsol.cost.cpu().numpy()
    rel = abs(float(cost.mean()) - float(fcost.mean())) / float(fcost.mean())
    out.update(B=WP_B, T=WP_T, solves_per_s=WP_B / wall,
               mean_cost=float(cost.mean()), init_mean_cost=float(init.mean()),
               fused_mean_cost=float(fcost.mean()), rel_to_fused=rel,
               mean_iters=float(host["iterations"].mean()),
               worse_than_initial=int((cost > init).sum()))
    print(f"[composable] (b) quadrotor waypoints, solve_batch B={WP_B} "
          f"T={WP_T} max_iter={WP_ITERS} (analytic, clamped, iterative QP): "
          f"{out['solves_per_s']:.1f} solves/s ({wall:.2f} s; "
          f"{nvidia_smi()}), {out['ms_per_iteration']:.1f} ms/iteration, "
          f"{out['syncs_per_iteration']:.1f} host syncs/iteration "
          f"({out['qp_loop_passes']} QP loop passes), "
          f"{out['launches_per_iteration']:.2f} kernel launches/iteration, "
          f"λ retries in {out['retried_share']:.3f} of iterations; mean cost "
          f"{out['mean_cost']:.4f} (initial {out['init_mean_cost']:.4f}), "
          f"the fused solver's (enumeration QP) {out['fused_mean_cost']:.4f} "
          f"(rel. diff {rel:.2e}, ≤ {WP_FUSED_TOL}); mean iterations "
          f"{out['mean_iters']:.2f}; lanes above their initial cost "
          f"{out['worse_than_initial']}")
    if not np.isfinite(cost).all() or out["worse_than_initial"]:
        raise AssertionError("(b) a lane is non-finite or above its initial "
                             "rollout's cost")
    if not rel <= WP_FUSED_TOL:
        raise AssertionError(f"(b) mean cost {cost.mean()} parts from the "
                             f"fused solver's {fcost.mean()}")
    # the busy share of one profiled iteration against its unprofiled wall
    short = cfg.replace(max_iter=1)
    t0 = time.perf_counter()
    solve_batch(model, params, short, WP_DT, x0, u0).cost.cpu()
    out["profile"] = profile_solve(
        "composable quadrotor, one iteration",
        lambda x, u: solve_batch(model, params, short, WP_DT, x, u).cost
        .cpu(), time.perf_counter() - t0, x0, u0, host=False)
    lanes, T_c, iters = WP_CPU
    out["card_vs_cpu"] = comp_card_vs_cpu(
        "quadrotor", model, params, cfg.replace(max_iter=iters), WP_DT,
        x0[:lanes], u0[:T_c], False, CPU_RTOL["quadrotor"])
    return out


def comp_card_vs_cpu(name, model, params, cfg, dt, x0, u0, batched, tol,
                     card=None):
    """The composable solve on the card (``card``, a Solution of all of
    x0's lanes, or solved here) against the same problems' first
    CPU_LANES lanes on the CPU: max relative cost difference ≤ ``tol``
    (the iteration counts printed: the QPs' matrix products round
    otherwise in cuBLAS, which can move a knife-edge stopping test)."""
    if card is None:
        card = solve_batch(model, params, cfg, dt, x0, u0,
                           params_batched=batched)
    k = min(CPU_LANES, len(x0))
    lanes = (type(params)(*[np.asarray(v)[:k] for v in params]) if batched
             else params)
    cpu = solve_batch(model, lanes, cfg, dt, x0[:k], u0, device="cpu",
                      params_batched=batched)
    c_card, c_cpu = card.cost[:k].cpu().numpy(), cpu.cost.numpy()
    rel = float(np.max(np.abs(c_card - c_cpu) / np.abs(c_cpu)))
    same_iters = bool((card.iterations[:k].cpu() == cpu.iterations).all())
    print(f"[composable] {name}, {k} lanes, T={len(u0)}, max_iter="
          f"{cfg.max_iter}: card vs the CPU, max relative cost difference "
          f"{rel:.2e} (≤ {tol:g}), iterations equal {same_iters}")
    if not np.isfinite(c_card).all() or rel > tol:
        raise AssertionError(f"{name}: the composable card solve left the "
                             "CPU's")
    return dict(max_rel_cost_diff=rel, lanes=k, T=len(u0),
                same_iterations=same_iters)


def run_mpc_path(dev):
    """(d): the single-controller MPC on the card against the CPU, step by
    step."""
    model = get_model("double_integrator")
    params = double_integrator.default_params(goal=(1.0, 0.5, 0.0, 0.0))
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=30)
    x0 = np.asarray([-1.0, 0.0, 0.0, 0.0], np.float32)
    u0 = np.zeros((MPC_T, 2), np.float32)
    states = {}
    _comp_counters()
    for device in ("cuda", "cpu"):
        state = mpc.mpc_init(model, params, cfg, MPC_DT, x0, u0,
                             device=device)
        xs, iters = [], []
        if device == "cuda":
            torch.cuda.synchronize()
            _comp_counters()
            t0 = time.perf_counter()
        for _ in range(MPC_STEPS):
            state = mpc.mpc_step(model, params, cfg, MPC_DT, state)
            xs.append(state.x.cpu().numpy())
            iters.append(int(state.plan.iterations.item()))
        if device == "cuda":
            wall = time.perf_counter() - t0
            out = _comp_stats(wall)
        states[device] = (np.asarray(xs), iters)
    (xc, ic), (xp, ip) = states["cuda"], states["cpu"]
    rel = float((np.abs(xc - xp) / (1.0 + np.abs(xp))).max())
    out.update(steps=MPC_STEPS, replans_per_s=MPC_STEPS / out["wall_s"],
               iterations_per_replan=float(np.mean(ic)),
               max_rel_state_diff=rel, final_x=xc[-1].tolist())
    print(f"[composable] (d) MPC (double integrator, T={MPC_T}, "
          f"dt={MPC_DT}, max_iter 30): {MPC_STEPS} replans on the card, "
          f"{out['replans_per_s']:.1f} replans/s, "
          f"{out['iterations_per_replan']:.2f} iterations per replan "
          f"({ic}), {out['syncs_per_iteration']:.1f} host syncs/iteration; "
          f"states against the CPU's, step by step: max relative "
          f"difference {rel:.2e} (≤ {MPC_REL:g}); iterations equal "
          f"{ic == ip}")
    out["same_iterations"] = ic == ip
    if not rel <= MPC_REL:
        raise AssertionError("(d) the card's MPC left the CPU's")
    return out


def run_composable_slice(dev, rows, readings):
    """Phase 14; fills in the launches of the derivs_packed rows and
    readings of COMP_MODELS from the runs that launched them (counts set to
    0 just before each run and read just after)."""
    res = {}
    launches = {name: {} for name in COMP_MODELS}

    def note(name, group, n):
        launches[name][group] = launches[name].get(group, 0) + n

    t0 = time.perf_counter()
    cpu_pool = multiprocessing.get_context("spawn").Pool(1)
    cpu_job = cpu_pool.map_async(_integrator_cpu_job, [None])
    res["integrator"] = run_integrator_path(dev, cpu_job)
    cpu_pool.close()
    cpu_pool.join()
    note("double_integrator", "fd_of",
         res["integrator"]["launches"]["derivs_packed"])
    print(f"[time] phase 14a (integrator) {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    res["waypoints"] = run_waypoints_path(dev)
    note("quadrotor", "row", res["waypoints"]["launches"]["derivs_packed"])
    print(f"[time] phase 14b (quadrotor waypoints) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    res["short"] = {}
    for name in COMP_MODELS:
        if name == "quadrotor":
            continue
        model, params, cfg, dt, x0, u0, batched = comp_problem(name)
        _comp_counters()
        t1 = time.perf_counter()
        sol = solve_batch(model, params, cfg, dt, x0, u0,
                          params_batched=batched)
        cost = sol.cost.cpu().numpy()
        stats = _comp_stats(time.perf_counter() - t1)
        stats["card_vs_cpu"] = comp_card_vs_cpu(
            name, model, params, cfg, dt, x0, u0, batched,
            CPU_RTOL.get(name, 1e-4), card=sol)
        group = ("rk4" if cfg.integrator == "rk4" else
                 "lanes" if batched else "row")
        note(name, group, stats["launches"]["derivs_packed"])
        if not np.isfinite(cost).all():
            raise AssertionError(f"{name}: non-finite composable costs")
        stats.update(mean_cost=float(cost.mean()),
                     qp_mode=cfg.boxqp_mode, integrator=cfg.integrator,
                     params_batched=batched)
        if batched:   # and the same problems with shared params (the row)
            _comp_counters()
            stats["card_vs_cpu_shared"] = comp_card_vs_cpu(
                name, model, model.default_params(), cfg, dt, x0, u0, False,
                CPU_RTOL.get(name, 1e-4))
            note(name, "row", launch_counts()["derivs_packed"])
        print(f"[composable] (c) {name} (n={model.n}, m={model.m}, "
              f"{cfg.boxqp_mode} QP, {cfg.integrator}"
              + (", per-lane params" if batched else "")
              + f"): B={COMP_B} T={COMP_T}, {stats['wall_s']:.2f} s, "
              f"{stats['ms_per_iteration']:.1f} ms/iteration, "
              f"{stats['syncs_per_iteration']:.1f} syncs/iteration, "
              f"launches {stats['launches']}")
        res["short"][name] = stats
    print(f"[time] phase 14c (short solves) {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    res["mpc"] = run_mpc_path(dev)
    note("double_integrator", "row", res["mpc"]["launches"]["derivs_packed"])
    print(f"[time] phase 14d (MPC) {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, by_group in launches.items():
        for group, n in by_group.items():
            if group == "row":
                rows[f"derivs_packed/{name}"]["launches"] = n
            elif group == "fd_of":
                rows[f"derivs_packed/{name}"]["fd_launches"] = n
            else:
                key = f"derivs_packed/{name}" + READING_SUFFIX[group]
                readings[key]["launches"] = n
    return res


# ---------------------------------------------------------------------------
# Phase 15: custom models (models.register): the user's torch SoA functions
# recorded, emitted as device functions (ops/codegen.py) and built with the
# hand-written kernel templates into a library of the model's own
# (_build.build_model), on ilqr_tpu_torch/examples/custom_model.py's
# unicycle (n = 3, m = 2) and its m = 1 companion unicycle_heading.

CUSTOM_MODELS = ("unicycle", "unicycle_heading")
# the fleet (b), the composable batch (c) and the companion's paths (d):
# B lanes, T steps of dt, x0 = 0.2·normal(B, 3) from default_rng(0), u0 0
CUSTOM_B, CUSTOM_T, CUSTOM_DT, CUSTOM_ITERS = 1024, 80, 0.05, 40
CUSTOM_COMP_ITERS = 5          # (c) and (d)'s composable batch
CUSTOM_GOALS = ((2.0, 1.0, 0.0), (1.5, -0.5, 0.0))   # (a): the example's,
#                                  tests/test_custom_model.py:32-38's
CUSTOM_GOAL_TOL, CUSTOM_SOLVE_RTOL = 0.1, 1e-3
CUSTOM_CPU = (4, 8)            # (b) card against the CPU: lanes, iterations
CUSTOM_XLA = (20, 5)           # (e) the model without SoA functions: T, iters
CUSTOM_VARIANTS = {            # (b)'s four fused solves
    "analytic_euler": dict(),
    "analytic_rk4": dict(integrator="rk4"),
    "fd_euler": dict(deriv_mode="fd", fd_eps=0.05),
    "analytic_euler_split": dict(iter_kernel="split")}
HEADING_VARIANTS = {"split": dict(sweep_kernel="split"), "merged": dict()}
CUSTOM_SOURCES = {"derivs": "ilqr_tpu_torch/csrc/derivs.cuh",
                  "backward": "ilqr_tpu_torch/csrc/backward.cuh"}


def custom_models():
    """The example's two models, registered (idempotent)."""
    from ilqr_tpu_torch.examples import custom_model as tcm

    return dict(zip(CUSTOM_MODELS, tcm.register_models()))


def custom_problem(name, B=CUSTOM_B):
    """(model, params, cfg, T, dt, u0 (T, m), x0 (B, 3)) of (b)/(d)."""
    model = custom_models()[name]
    rng = np.random.default_rng(0)
    x0 = (0.2 * rng.normal(size=(B, 3))).astype(np.float32)
    u0 = np.zeros((CUSTOM_T, model.m), np.float32)
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=CUSTOM_ITERS)
    return (model, model.default_params(), cfg, CUSTOM_T, CUSTOM_DT, u0, x0)


def custom_cases(dev, name):
    """``name``'s kernels at phase 15's shapes (B = 1024, T = 80, A = 11),
    on (b)'s x0, its open-loop rollout and first gains; masks mixed. The
    unicycle: the rollout and line search with the Euler step (rows) and
    RK4 (readings); the sweep and iteration with the dual numbers and Euler
    (rows: the closed forms do not exist for a custom model), RK4
    (readings) and the stencils (fd_* fields); the derivative kernel in jvp
    mode (row) and fd mode. unicycle_heading: its rollout, line search,
    iteration and derivative kernels and the backward kernel at n = 3 (the
    split sweep's)."""
    model, params, cfg, T, dt, u0, x0_np = custom_problem(name)
    B, A, n, m = CUSTOM_B, len(cfg.alphas), model.n, model.m
    rng = np.random.default_rng(7)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pp = kernel_rollout.pack_params(params, dt, dev)
    x0 = f(x0_np).t().contiguous()
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    xs0, us0, xT0, c0 = kernel_rollout.rollout_packed(
        model, "euler", True, pp, x0, f(u0)[:, :, None].expand(
            T, m, B).contiguous(), zeros(T, n, B), zeros(T, m, n, B))
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
    xs_full = torch.cat([xs0, xT0[None]]).contiguous()
    cases = {}   # key → (op, plain, args, kind, mode, integrator, group)
    integrators = ("euler", "rk4") if name == "unicycle" else ("euler",)
    for integ in integrators:
        group = "row" if integ == "euler" else "rk4"
        cases[f"rollout_packed/{name} ({integ})"] = (
            kernel_rollout.rollout_packed, kernel_rollout.rollout_plain,
            (model, integ, True, pp, x0, uff, xsr, Kr), "rollout", "jvp",
            integ, group, None)
        cases[f"linesearch_packed/{name} ({integ})"] = (
            kernel_rollout.linesearch_packed, kernel_rollout.linesearch_plain,
            (model, integ, True, pp, x0, us0, xs0, xT0, K1, k1, Kold, kold,
             alphas, dv1, c0, gate, keep, cfg.z_min), "linesearch", "jvp",
            integ, group,
            lambda got: old * (keep > 0.5).float().mean().item())
    derivs = [("jvp", "euler", "row"), ("jvp", "rk4", "rk4"),
              ("fd", "euler", "fd_of")]
    if name != "unicycle":
        derivs = derivs[:1]
    for mode, integ, group in derivs:
        if name == "unicycle":
            cases[f"sweep_packed/{name} ({mode}, {integ})"] = (
                kernel_sweep.sweep_packed, kernel_sweep.sweep_plain,
                (model, integ, pp, xs0, xT0, us0, lam, mode, True, 0.05),
                "sweep", mode, integ, group, None)
        cases[f"iteration_packed/{name} ({mode}, {integ})"] = (
            kernel_iter.iteration_packed, kernel_iter.iteration_plain,
            (model, integ, True, pp, x0, xs0, xT0, us0, kold, Kold, lam, c0,
             live, alphas, mode, True, cfg.z_min, cfg.tol_grad,
             cfg.lambda_grad_term, 0.05), "iteration", mode, integ, group,
            lambda got: old * ((got[10] < 0.5) & (live > 0.5)).float()
            .mean().item())
    for mode, group in (("jvp", "row"), ("fd", "fd_of"))[
            :2 if name == "unicycle" else 1]:
        cases[f"derivs_packed/{name} ({mode})"] = (
            kernel_derivs.derivs_packed, kernel_derivs.derivs_plain,
            (model, "euler", pp, xs_full, us0, mode, 0.05), "derivs", mode,
            "euler", group, None)
    out = {}
    for label, (op, plain, args, kind, mode, integ, group,
                unread) in cases.items():
        row = label.split(" ")[0]

        def ops(kind=kind, mode=mode, integ=integ):
            if kind == "derivs":
                step, rest = ops_per_step(lambda t: _custom_derivs_at(
                    model, params, dt, t, mode))
            else:
                step, rest = lane_ops(model, params, kind, True, A, dt, mode,
                                      integ)
            return step * T * B + rest * B

        suffix = f"_{mode}" if kind in ("sweep", "iteration") else ""
        kernel = launched_kernel(kind, model, mode)
        out[label] = Case(op, plain, args, ops, f"at B={B} T={T} A={A}",
                          unread, dict(
                              row=row, group=group, kernel=kernel + suffix,
                              model=name, limits=True, T=T,
                              bitwise=held_bitwise(kernel),
                              effort=effort(kind, T, n, m)
                              * (8 if mode == "jvp" and kind in (
                                  "sweep", "iteration") else 1),
                              source=CUSTOM_SOURCES.get(
                                  kind, "ilqr_tpu_torch/csrc/kernels.cuh")))
    if name == "unicycle_heading":
        fx, fu, cx, cu, cxx, cxu, cuu = kernel_derivs.derivs_packed(
            model, "euler", pp, xs_full, us0)
        p, _dt = kernel_rollout.unpack_params(pp)
        args = tuple(a.contiguous() for a in (
            fx, fu[:, :, 0], cx[:-1], cu[:, 0], cxx[:-1], cxu[:, :, 0],
            cuu[:, 0, 0], p.u_min[0] - us0[:, 0], p.u_max[0] - us0[:, 0],
            torch.ones(B, device=dev), cx[-1], cxx[-1]))
        out[f"backward_sweep_packed/{name}"] = Case(
            kernel_backward.backward_sweep_packed,
            kernel_backward.backward_plain, args,
            lambda: _custom_backward_ops(model, params, dt) * B,
            f"at B={B} T={T} n={n}", None,
            dict(row=f"backward_sweep_packed/{name}", group="row",
                 kernel=launched_kernel("backward", model), model=name,
                 limits=True, T=T, effort=effort("backward", T, n, m),
                 source=CUSTOM_SOURCES["backward"], bitwise=True))
    return out


def _custom_lane(model, t, seed=3):
    rng = np.random.default_rng(seed)
    xs = torch.as_tensor(0.3 * rng.normal(size=(t + 1, model.n, 1)),
                         dtype=torch.float32)
    us = torch.as_tensor(rng.normal(size=(t, model.m, 1)),
                         dtype=torch.float32)
    return xs, us


def _custom_derivs_at(model, params, dt, t, mode):
    return kernel_derivs.derivs_plain(
        model, "euler", kernel_rollout.pack_params(params, dt),
        *_custom_lane(model, t), mode=mode, eps=0.05)


def _custom_backward_ops(model, params, dt):
    """The backward recursion's operations per lane over T = CUSTOM_T:
    its count minus the derivative op that builds its inputs."""
    lo, hi = float(params.u_min[0]), float(params.u_max[0])

    def at(t):
        xs, us = _custom_lane(model, t)
        d = _custom_derivs_at(model, params, dt, t, "jvp")
        return kernel_backward.backward_plain(
            d[0], d[1][:, :, 0], d[2][:-1], d[3][:, 0], d[4][:-1],
            d[5][:, :, 0], d[6][:, 0, 0], lo - us[:, 0], hi - us[:, 0],
            torch.ones(1), d[2][-1], d[4][-1])

    step_all, rest_all = ops_per_step(at)
    step_d, rest_d = ops_per_step(
        lambda t: _custom_derivs_at(model, params, dt, t, "jvp"))
    return (step_all - step_d) * CUSTOM_T + (rest_all - rest_d)


def custom_ptxas():
    """ptxas's report of the custom libraries, keyed as ptxas_table keys
    the main library's (the kernel, the model, the limits flag); without
    the source file, which is the generated one under build/."""
    table = {}
    for name, model in custom_models().items():
        for (kernel, _m, limits), e in ptxas_table(
                _build.model_build_log(model)).items():
            table[(kernel, name, limits)] = {k: v for k, v in e.items()
                                             if k != "source"}
    return table


def _cpu_custom_job(job):
    """In a worker process: one of phase 15's CPU references, the plain
    versions on the CPU. ``job`` = (kind, args); returns (job, result)."""
    torch.set_num_threads(1)
    kind, args = job
    models = custom_models()
    if kind == "goal":     # (a): the example's problem for one goal
        from ilqr_tpu_torch.examples import custom_model as tcm

        sol = solver.solve(models["unicycle"], tcm.default_params(args),
                           _custom_goal_cfg(), CUSTOM_DT,
                           np.zeros(3, np.float32),
                           np.zeros((CUSTOM_T, 2), np.float32), device="cpu")
        return job, dict(cost=float(sol.cost), iterations=int(
            sol.iterations), reason=int(sol.reason),
            xf=sol.xs[-1].numpy().tolist())
    if kind == "fleet":    # (b): the first lanes of one variant
        model, params, cfg, T, dt, u0, x0 = custom_problem("unicycle")
        lanes, iters = CUSTOM_CPU
        cfg = cfg.replace(max_iter=iters, **CUSTOM_VARIANTS[args])
        sol = solve_batch_fused(model, params, cfg, dt, x0[:lanes], u0,
                                device="cpu")
        return job, sol.cost.numpy().tolist()
    # (e): the unicycle without SoA functions on the "xla" routes
    model, params, cfg, x0, u0 = _custom_no_soa()
    sol = solver.solve(model, params, cfg, CUSTOM_DT, x0, u0, device="cpu")
    return job, float(sol.cost)


def _custom_goal_cfg():
    return SolverConfig(deriv_mode="analytic", clamp_forward=True)


def _custom_no_soa():
    """(model, params, cfg, x0, u0) of (e): the unicycle with its *_soa
    fields None, solved from 0.1·normal(3) (default_rng(4)) for a short
    horizon."""
    import dataclasses

    from ilqr_tpu_torch.examples import custom_model as tcm

    model = dataclasses.replace(tcm.UNICYCLE, name="unicycle_aos",
                                dynamics_soa=None, cost_soa=None,
                                final_cost_soa=None)
    T_x, iters = CUSTOM_XLA
    x0 = (0.1 * np.random.default_rng(4).normal(size=3)).astype(np.float32)
    return (model, tcm.default_params(), _custom_goal_cfg().replace(
        max_iter=iters), x0, np.zeros((T_x, 2), np.float32))


def _custom_fleet(dev, name, variant, x0, u0, init):
    """One timed fused solve of (b) or (d) (after a warm-up solve), with
    its launches (counts set to 0 just before, read just after)."""
    model, params, cfg, T, dt, _u0, _x0 = custom_problem(name)
    cfg = cfg.replace(**(CUSTOM_VARIANTS if name == "unicycle"
                         else HEADING_VARIANTS)[variant])
    solve_batch_fused(model, params, cfg, dt, x0, u0).cost.cpu()
    reset_launch_counts()
    fused._iteration.calls = 0
    t0 = time.perf_counter()
    sol = solve_batch_fused(model, params, cfg, dt, x0, u0)
    host = {k: v.cpu() for k, v in sol._asdict().items()}   # full D2H
    wall = time.perf_counter() - t0
    counts = launch_counts()
    cost = host["cost"].numpy()
    its = max(1, fused._iteration.calls)
    worse = int((cost > init * (1.0 + 1e-6)).sum())
    out = dict(B=len(x0), T=T, max_iter=cfg.max_iter, solves_per_s=len(x0)
               / wall, wall_s=wall, ms_per_iteration=wall * 1e3 / its,
               host_iterations=its, launches=counts,
               mean_cost=float(cost.mean()), init_mean_cost=float(
                   init.mean()), mean_iters=float(
                       host["iterations"].float().mean()),
               worse_than_initial=worse)
    print(f"[custom] (b) {name} {variant}: B={len(x0)} T={T} max_iter="
          f"{cfg.max_iter}: {out['solves_per_s']:.1f} solves/s ({wall:.3f} "
          f"s; {nvidia_smi()}), {out['ms_per_iteration']:.3f} ms/iteration "
          f"({its} host iterations), mean cost {out['mean_cost']:.4f} "
          f"(initial {out['init_mean_cost']:.4f}), mean iterations "
          f"{out['mean_iters']:.2f}, lanes above their initial cost {worse}, "
          f"launches {counts}")
    if not np.isfinite(cost).all() or worse:
        raise AssertionError(f"(b) {variant}: a lane is non-finite or above "
                             "its initial rollout's cost")
    return out, cost


def run_custom_slice(dev, rows, readings):
    """Phase 15; fills in the launches of phase 3's custom-model rows and
    readings from the paths that launched them. The CPU references run in
    worker processes while the card runs the paths."""
    from ilqr_tpu_torch.examples import custom_model as tcm

    models = custom_models()
    uni, head = models["unicycle"], models["unicycle_heading"]
    jobs = ([("goal", g) for g in CUSTOM_GOALS]
            + [("fleet", v) for v in ("analytic_euler", "analytic_rk4",
                                      "fd_euler")] + [("no_soa", None)])
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(len(jobs))
    pending = pool.map_async(_cpu_custom_job, jobs)
    res = {}
    launches = {}

    def note(key, n):
        launches[key] = launches.get(key, 0) + n

    # (a) the example's problem through solve, for both goals
    t0 = time.perf_counter()
    res["goals"] = []
    for goal in CUSTOM_GOALS:
        reset_launch_counts()
        t1 = time.perf_counter()
        sol = solver.solve(uni, tcm.default_params(goal), _custom_goal_cfg(),
                           CUSTOM_DT, np.zeros(3, np.float32),
                           np.zeros((CUSTOM_T, 2), np.float32))
        xf = sol.xs[-1].cpu().numpy()
        wall = time.perf_counter() - t1
        c = launch_counts()
        note("derivs_packed/unicycle", c["derivs_packed"])
        reason = TerminationReason(int(sol.reason.item())).name
        res["goals"].append(dict(goal=goal, cost=float(sol.cost.item()),
                                 iterations=int(sol.iterations.item()),
                                 reason=reason, final_pose=xf.tolist(),
                                 wall_s=wall, launches=c))
        print(f"[custom] (a) unicycle solve to {goal} (analytic, clamped, "
              f"T={CUSTOM_T}): cost {float(sol.cost.item()):.4f}, "
              f"{int(sol.iterations.item())} iterations, reason {reason}, "
              f"final pose ({xf[0]:.3f}, {xf[1]:.3f}, {xf[2]:.3f}); "
              f"{wall:.2f} s, launches {c}")
        if not (abs(xf[0] - goal[0]) < CUSTOM_GOAL_TOL
                and abs(xf[1] - goal[1]) < CUSTOM_GOAL_TOL):
            raise AssertionError(f"(a) the unicycle missed the goal {goal}")
    print(f"[time] phase 15a (the example's problem) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (b) the fleet, four fused variants
    t0 = time.perf_counter()
    model, params, cfg, T, dt, u0, x0 = custom_problem("unicycle")
    init = _initial_costs(dev, uni, kernel_rollout.pack_params(
        params, dt, dev), T, u0, x0)
    res["fleet"] = {}
    for variant in CUSTOM_VARIANTS:
        out, _cost = _custom_fleet(dev, "unicycle", variant, x0, u0, init)
        res["fleet"][variant] = out
        c = out["launches"]
        if variant == "analytic_euler":
            note("rollout_packed/unicycle", c["rollout_packed"])
            note("iteration_packed/unicycle", c["iteration_packed"])
        elif variant == "analytic_rk4":
            note("rollout_packed/unicycle#rk4", c["rollout_packed"])
            note("iteration_packed/unicycle#rk4", c["iteration_packed"])
        elif variant == "fd_euler":
            note("iteration_packed/unicycle#fd", c["iteration_packed"])
        else:
            note("sweep_packed/unicycle", c["sweep_packed"])
            note("linesearch_packed/unicycle", c["linesearch_packed"])
        if (c["rollout_packed"] != 1 or c["iteration_packed"]
                + c["sweep_packed"] < 1):
            raise AssertionError(f"(b) {variant} launched {c}")
    print(f"[time] phase 15b (the fleet) {time.perf_counter() - t0:.1f} s",
          flush=True)

    # (c) tests/test_custom_model.py:41-53's configuration at full width
    t0 = time.perf_counter()
    ccfg = cfg.replace(max_iter=CUSTOM_COMP_ITERS, rollout_kernel="pallas",
                       deriv_kernel="pallas")
    _comp_counters()
    t1 = time.perf_counter()
    sol = solve_batch(uni, params, ccfg, dt, x0, u0)
    cost = sol.cost.cpu().numpy()
    out = _comp_stats(time.perf_counter() - t1)
    out.update(B=len(x0), T=T, mean_cost=float(cost.mean()),
               worse_than_initial=int((cost > init * (1.0 + 1e-6)).sum()))
    res["composable"] = out
    c = out["launches"]
    note("derivs_packed/unicycle", c["derivs_packed"])
    print(f"[custom] (c) unicycle composable solve_batch (kernel routes "
          f"forced) B={len(x0)} T={T} max_iter={CUSTOM_COMP_ITERS}: "
          f"{out['wall_s']:.2f} s, {out['ms_per_iteration']:.1f} "
          f"ms/iteration, {out['syncs_per_iteration']:.1f} host "
          f"syncs/iteration, mean cost {out['mean_cost']:.4f}, lanes above "
          f"their initial cost {out['worse_than_initial']}, launches {c}")
    if (not np.isfinite(cost).all() or c["rollout_packed"] < 1
            or c["derivs_packed"] < 1 or out["worse_than_initial"]):
        raise AssertionError("(c) the composable batch failed its checks")
    print(f"[time] phase 15c (the composable batch) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (d) unicycle_heading: the split sweep (derivs + backward at n = 3)
    # against the merged route, and the composable m = 1 route
    t0 = time.perf_counter()
    hmodel, hparams, hcfg, T, dt, hu0, hx0 = custom_problem(
        "unicycle_heading")
    hinit = _initial_costs(dev, head, kernel_rollout.pack_params(
        hparams, dt, dev), T, hu0, hx0)
    split, split_cost = _custom_fleet(dev, "unicycle_heading", "split",
                                      hx0, hu0, hinit)
    c = split["launches"]
    for kind in ("rollout", "linesearch", "derivs", "backward_sweep"):
        note(f"{kind}_packed/unicycle_heading", c[f"{kind}_packed"])
    if c["derivs_packed"] < 1 or c["backward_sweep_packed"] < 1:
        raise AssertionError(f"(d) the split sweep launched {c}")
    merged, merged_cost = _custom_fleet(dev, "unicycle_heading", "merged",
                                        hx0, hu0, hinit)
    note("iteration_packed/unicycle_heading",
         merged["launches"]["iteration_packed"])
    p99, mx = gauge(split_cost, merged_cost)
    res["heading"] = dict(split=split, merged=merged, gauge_p99=p99,
                          gauge_max=mx)
    print(f"[custom] (d) unicycle_heading split sweep against the merged "
          f"route, B={len(hx0)} T={T} max_iter={hcfg.max_iter}: per-lane "
          f"|c1-c2|/(1+|c2|) p99 {p99:.3e} (≤ {GAUGE_P99:g}), max {mx:.3e} "
          f"(≤ {GAUGE_MAX:g})")
    if not (p99 <= GAUGE_P99 and mx <= GAUGE_MAX):
        raise AssertionError("(d) the split sweep left the gauge")
    hc = hcfg.replace(max_iter=CUSTOM_COMP_ITERS)
    _comp_counters()
    t1 = time.perf_counter()
    comp = solve_batch(head, hparams, hc, dt, hx0, hu0).cost.cpu().numpy()
    cstats = _comp_stats(time.perf_counter() - t1)
    c = cstats["launches"]
    note("backward_sweep_packed/unicycle_heading", c["backward_sweep_packed"])
    note("derivs_packed/unicycle_heading", c["derivs_packed"])
    fz = solve_batch_fused(head, hparams, hc, dt, hx0, hu0).cost.cpu().numpy()
    p99c, mxc = gauge(comp, fz)
    cstats.update(gauge_p99=p99c, gauge_max=mxc)
    res["heading"]["composable"] = cstats
    print(f"[custom] (d) unicycle_heading composable m = 1 route (derivative "
          f"and backward kernels) B={len(hx0)} max_iter={CUSTOM_COMP_ITERS}: "
          f"{cstats['wall_s']:.2f} s, {cstats['ms_per_iteration']:.1f} "
          f"ms/iteration, launches {c}; against the fused merged route: "
          f"p99 {p99c:.3e}, max {mxc:.3e}")
    if (c["backward_sweep_packed"] < 1 or not (p99c <= GAUGE_P99
                                               and mxc <= GAUGE_MAX)):
        raise AssertionError("(d) the composable m = 1 route failed")
    print(f"[time] phase 15d (unicycle_heading) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (e) the unicycle without SoA functions: the "xla" routes on the card
    t0 = time.perf_counter()
    nmodel, nparams, ncfg, nx0, nu0 = _custom_no_soa()
    reset_launch_counts()
    nsol = solver.solve(nmodel, nparams, ncfg, CUSTOM_DT, nx0, nu0)
    ncost = float(nsol.cost.item())
    nc = launch_counts()
    if any(nc.values()):
        raise AssertionError(f"(e) the xla routes launched {nc}")

    # the CPU references
    cpu = dict(pending.get())
    pool.close()
    pool.join()
    for g, r in zip(CUSTOM_GOALS, res["goals"]):
        ref = cpu[("goal", g)]
        rel = abs(r["cost"] - ref["cost"]) / abs(ref["cost"])
        r.update(cpu_cost=ref["cost"], cpu_iterations=ref["iterations"],
                 rel_to_cpu=rel)
        print(f"[custom] (a) goal {g}: card cost {r['cost']:.6f} "
              f"({r['iterations']} iterations), CPU {ref['cost']:.6f} "
              f"({ref['iterations']} iterations): rel {rel:.2e} (≤ "
              f"{CUSTOM_SOLVE_RTOL:g})")
        if not rel <= CUSTOM_SOLVE_RTOL:
            raise AssertionError(f"(a) goal {g}: the card left the CPU")
    lanes, iters = CUSTOM_CPU
    for variant in ("analytic_euler", "analytic_rk4", "fd_euler"):
        ref = np.asarray(cpu[("fleet", variant)])
        vcfg = cfg.replace(max_iter=iters, **CUSTOM_VARIANTS[variant])
        card = solve_batch_fused(uni, params, vcfg, dt, x0[:lanes],
                                 u0).cost.cpu().numpy()
        rel = float(np.max(np.abs(card - ref) / np.abs(ref)))
        res["fleet"][variant]["card_vs_cpu"] = dict(
            lanes=lanes, max_iter=iters, max_rel_cost_diff=rel)
        print(f"[custom] (b) {variant}, {lanes} lanes, max_iter={iters}: "
              f"card vs the plain path on the CPU, max relative cost "
              f"difference {rel:.2e} (≤ {CUSTOM_SOLVE_RTOL:g})")
        if not rel <= CUSTOM_SOLVE_RTOL:
            raise AssertionError(f"(b) {variant}: the card left the CPU")
    nref = cpu[("no_soa", None)]
    nrel = abs(ncost - nref) / abs(nref)
    res["no_soa"] = dict(cost=ncost, cpu_cost=nref, rel_to_cpu=nrel,
                         iterations=int(nsol.iterations.item()),
                         wall_s=time.perf_counter() - t0)
    print(f"[custom] (e) the unicycle without SoA functions on the 'xla' "
          f"routes (T={len(nu0)}, max_iter={ncfg.max_iter}): card cost "
          f"{ncost:.6f}, CPU {nref:.6f}, rel {nrel:.2e} (≤ "
          f"{CUSTOM_SOLVE_RTOL:g}); no kernel launched")
    if not nrel <= CUSTOM_SOLVE_RTOL:
        raise AssertionError("(e) the xla routes left the CPU")
    print(f"[time] phase 15e (no SoA functions) and the CPU references "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    for key, n in launches.items():
        row, _sep, mode = key.partition("#")
        if mode == "rk4":
            readings[row]["launches"] = n
        elif mode == "fd":
            rows[row]["fd_launches"] = n
        else:
            rows[row]["launches"] = n
    return res


def check_custom_bitwise(rows, readings):
    """Every custom-model row and reading of phase 3 bit for bit."""
    for key, r in list(rows.items()) + list(readings.items()):
        if r.get("model") in CUSTOM_MODELS and not (
                r["bitwise_equal"] and r.get("fd_bitwise_equal", True)):
            raise AssertionError(f"{key} is not bitwise equal to its plain "
                                 "version")


# ---------------------------------------------------------------------------
# The other modes of rollout_packed (its second kernel,
# ilqr_<model>_rollout_modes: costs_only, materialized candidates, the step
# α per candidate or per lane): phase 3's readings of the rollout_packed
# rows, and phase 16(f)'s path, the JAX kernel's two-pass line search
# (experiments/kernel_probe.py's pass-1 sweep shape) built from them.

MODES_MODELS = ("acrobot", "quadrotor", "thruster_ring", "pendulum",
                "unicycle")
MODE_GROUPS = ("costs_only", "candidates", "alphas", "alpha_lanes",
               "alphas_rk4")
MODE_READINGS = {   # the readings of each model's row
    "acrobot": MODE_GROUPS,
    "quadrotor": ("alphas", "alpha_lanes"),
    "thruster_ring": ("alphas", "alpha_lanes"),
    "pendulum": ("alphas",),     # with per-lane params
    "unicycle": ("alphas",),     # a custom model's own library
}
READING_SUFFIX.update({g: f"#{g}" for g in MODE_GROUPS})
READING_PREFIX.update({f"{g}": f"{g}_" for g in MODE_GROUPS})


def _outputs(r):
    """An op's outputs as a tuple (costs_only returns one tensor)."""
    return r if isinstance(r, tuple) else (r,)


def modes_problem(dev, name):
    """``name``'s line search at its path's shapes, as the rollout modes
    take it: the path's x0, its clamped open-loop rollout (the current
    trajectory x̄, controls and cost) and that rollout's first gains
    (k, K, dV). acrobot: the flagship (B = 8192, T = 499); the quadrotor
    and thruster_ring: phases 8-9's workloads (B = 1024, T = 80);
    pendulum: phase 13(b)'s per-lane goals and limits (B = 1024, T = 199,
    one params row per lane); unicycle: phase 15's fleet (B = 1024,
    T = 80)."""
    if name == "acrobot":
        model, params, cfg = flagship()
        Tm, dt = T, DT
        x0_np = (0.05 * np.random.default_rng(0).normal(size=(B_MAIN, N))
                 ).astype(np.float32)
        u0 = np.zeros((T, M), np.float32)
        pp = kernel_rollout.pack_params(params, dt, dev)
    elif name == "pendulum":
        model, lanes, cfg, Tm, dt, u0, x0_np = pendulum_goals_workload()
        params = model.default_params()
        pp = kernel_rollout.pack_params_batched(lanes, dt, dev)
    elif name == "unicycle":
        model, params, cfg, Tm, dt, u0, x0_np = custom_problem(name)
        pp = kernel_rollout.pack_params(params, dt, dev)
    else:
        model, params, cfg, Tm, dt, u0, draw = workload(name)
        x0_np = draw(np.random.default_rng(0))
        pp = kernel_rollout.pack_params(params, dt, dev)
    B, n, m = len(x0_np), model.n, model.m
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    x0 = f(x0_np).t().contiguous()
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    xs0, us0, xT0, c0 = kernel_rollout.rollout_packed(
        model, "euler", True, pp, x0,
        f(u0)[:, :, None].expand(Tm, m, B).contiguous(), zeros(Tm, n, B),
        zeros(Tm, m, n, B))
    k1, K1, dv1, _d, _g = kernel_sweep.sweep_packed(
        model, "euler", pp, xs0, xT0, us0, torch.ones(B, device=dev))
    return dict(model=model, params=params, cfg=cfg, T=Tm, dt=dt, B=B,
                pp=pp, x0=x0, us=us0, xs=xs0, xT=xT0, cost=c0, k=k1, K=K1,
                dv=dv1, alphas=f(cfg.alphas))


def mode_args(P, group):
    """rollout_packed's arguments, positional, for reading ``group`` on
    problem ``P``: the line search's pass 1 (the A candidates' costs: the
    step formed in the kernel, or u + α_a·k materialized per candidate),
    its pass 2 (a mix of the candidates' steps, one per lane, with full
    outputs), and a cost-only rollout of the current controls around the
    current trajectory with the new gains."""
    A, B = len(P["alphas"]), P["B"]
    integ = "rk4" if group == "alphas_rk4" else "euler"
    head = (P["model"], integ, True, P["pp"], P["x0"])
    ref = (P["xs"], P["K"])
    if group == "costs_only":
        return head + (P["us"],) + ref + (True, 1, None, None, None)
    if group == "candidates":
        al = P["alphas"][None, None, :, None]
        wide = (P["us"][:, :, None] + al * P["k"][:, :, None]).reshape(
            P["T"], P["model"].m, A * B)
        return head + (wide,) + ref + (True, A, None, None, None)
    if group == "alpha_lanes":
        pick = np.random.default_rng(8).integers(0, A, size=B)
        lanes = P["alphas"][torch.as_tensor(pick, device=P["x0"].device)]
        return head + (P["us"],) + ref + (False, 1, P["k"], None,
                                           lanes.contiguous())
    return head + (P["us"],) + ref + (True, A, P["k"], P["alphas"], None)


def mode_ops(model, params, dt, group, A, T_, B):
    """f32 operations of reading ``group`` (A candidates per lane), from
    the plain version on one CPU lane with T = 1 and 2."""
    pp = kernel_rollout.pack_params(params, dt)
    rng = np.random.default_rng(6)
    n, m = model.n, model.m
    f = lambda *s: torch.as_tensor(0.1 * rng.normal(size=s),
                                   dtype=torch.float32)
    al = torch.linspace(1.0, 0.001, A)

    def at(t):
        x0, xs, K, k = f(n, 1), f(t, n, 1), f(t, m, n, 1), f(t, m, 1)
        us = 1.0 + f(t, m, 1)
        integ = "rk4" if group == "alphas_rk4" else "euler"
        kw = {"costs_only": dict(costs_only=True),
              "candidates": dict(costs_only=True, candidates=A),
              "alpha_lanes": dict(k=k, alpha_lanes=al[:1])}.get(
            group, dict(costs_only=True, candidates=A, k=k, alphas=al))
        if group == "candidates":
            us = 1.0 + f(t, m, A)
        return kernel_rollout.rollout_plain(model, integ, True, pp, x0, us,
                                            xs, K, **kw)
    step, rest = ops_per_step(at)
    return step * T_ * B + rest * B


def design_bytes(P, group, A):
    """What the one-thread-per-(candidate, lane) design reads and writes:
    each thread reads x̄ (n), K (m·n), u_ff (m) and, with an α, k (m) at
    every step, its x0 and params row once, and writes its cost (and, with
    full outputs, x and u at every step and x_T)."""
    n, m, T_, B = P["model"].n, P["model"].m, P["T"], P["B"]
    alpha = group in ("alphas", "alphas_rk4", "alpha_lanes")
    per_step = n + m * n + m + (m if alpha else 0)
    full = group == "alpha_lanes"
    per_thread = (T_ * (per_step + (n + m if full else 0)) + n + 1
                  + (n if full else 0) + kernel_rollout.param_stride(P["pp"]))
    return 4 * A * B * per_thread


def modes_cases(dev, name):
    """Phase 3's readings of rollout_packed/<name>'s second kernel (see
    MODE_READINGS), each held bit for bit against its plain version."""
    P = modes_problem(dev, name)
    model, n, m = P["model"], P["model"].n, P["model"].m
    out = {}
    for group in MODE_READINGS[name]:
        A = 1 if group in ("costs_only", "alpha_lanes") else len(P["alphas"])
        row = f"rollout_packed/{name}"
        meta = dict(row=row, group=group, kernel="rollout_modes_kernel",
                    model=name, limits=True, T=P["T"],
                    effort=effort("rollout", P["T"], n, m) * A,
                    design_bytes=design_bytes(P, group, A))
        if name == "unicycle":
            meta["source"] = "ilqr_tpu_torch/csrc/kernels.cuh"
        out[f"{row} ({group})"] = Case(
            lambda *a: _outputs(kernel_rollout.rollout_packed(*a)),
            lambda *a: _outputs(kernel_rollout.rollout_plain(*a)),
            mode_args(P, group),
            lambda group=group, A=A: mode_ops(model, P["params"], P["dt"],
                                              group, A, P["T"], P["B"]),
            f"at B={P['B']} T={P['T']} A={A}"
            + (", one params row per lane" if name == "pendulum" else ""),
            None, meta)
    return out


def _two_pass(P, integ):
    """The two-pass line search on the rollout modes: pass 1 the A
    candidates' costs (the step formed in the kernel), the first accepted
    α per lane by the line search's own rule, pass 2 that α per lane with
    full outputs. Returns (costs (A, B), the selection, pass 2's
    outputs)."""
    model, pp, A = P["model"], P["pp"], len(P["alphas"])
    cand = kernel_rollout.rollout_packed(
        model, integ, True, pp, P["x0"], P["us"], P["xs"], P["K"],
        costs_only=True, candidates=A, k=P["k"],
        alphas=P["alphas"]).view(A, P["B"])
    sel = kernel_rollout.select_alpha(cand, P["alphas"], P["cost"],
                                      P["dv"][0], P["dv"][1], P["cfg"].z_min)
    full = kernel_rollout.rollout_packed(
        model, integ, True, pp, P["x0"], P["us"], P["xs"], P["K"],
        k=P["k"], alpha_lanes=sel[0].contiguous())
    return cand, sel, full


def _passes(P, integ, asel):
    """The two launches of :func:`_two_pass` alone, at a given α per
    lane."""
    model, pp, A = P["model"], P["pp"], len(P["alphas"])
    kernel_rollout.rollout_packed(
        model, integ, True, pp, P["x0"], P["us"], P["xs"], P["K"],
        costs_only=True, candidates=A, k=P["k"], alphas=P["alphas"])
    return kernel_rollout.rollout_packed(
        model, integ, True, pp, P["x0"], P["us"], P["xs"], P["K"],
        k=P["k"], alpha_lanes=asel.contiguous())


def _linesearch(P, integ):
    """linesearch_packed on ``P`` with gate and keep on every lane."""
    ones = torch.ones(P["B"], device=P["x0"].device)
    return kernel_rollout.linesearch_packed(
        P["model"], integ, True, P["pp"], P["x0"], P["us"], P["xs"],
        P["xT"], P["K"], P["k"], P["K"], P["k"], P["alphas"], P["dv"],
        P["cost"], ones, ones, P["cfg"].z_min)


def _check_two_pass(P, integ, sel, full):
    """The two passes against linesearch_packed (gate and keep on every
    lane), bit for bit: the selected α, its cost and the acceptance on
    every lane, the emitted trajectory on the accepted ones."""
    ls = _linesearch(P, integ)
    asel, lsc, _ldc, _lexp, accepted = sel
    take = accepted > 0.5
    same = (torch.equal(asel, ls[6]) and torch.equal(lsc, ls[5])
            and torch.equal(accepted, ls[7])
            and all(torch.equal(a[..., take], b[..., take])
                    for a, b in zip(full[:3], ls[:3])))
    return same, float(take.float().mean())


def run_modes_path(dev, readings):
    """Phase 16(f): for each model of MODES_MODELS, the two-pass line
    search on the rollout modes at phase 3's shapes, its counts set to 0
    just before and read just after (the launches of its readings), and
    held bit for bit against the one-kernel line search; acrobot also
    materializes the candidates (their costs equal pass 1's), rolls out
    the chosen controls around the chosen trajectory costs-only (the cost
    equals pass 2's), and runs the two passes with RK4. Then both line
    searches are timed (CUDA events, median of 3; the two passes with
    the α selection between them, and the selection and the two launches
    apart)."""
    out = {}
    for name in MODES_MODELS:
        P = modes_problem(dev, name)
        A = len(P["alphas"])
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        cand, sel, full = _two_pass(P, "euler")
        extra = {}
        if name == "acrobot":
            wide = mode_args(P, "candidates")
            cand_m = kernel_rollout.rollout_packed(*wide).view(A, P["B"])
            c_only = kernel_rollout.rollout_packed(
                P["model"], "euler", True, P["pp"], P["x0"], full[1],
                full[0], P["K"], costs_only=True)
            extra = dict(materialized_equal=torch.equal(cand_m, cand),
                         costs_only_equal=torch.equal(c_only, full[3]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernel_rollout.rollout_packed.mode_launches)
        same, accepted = _check_two_pass(P, "euler", sel, full)
        r = dict(wall_ms=wall * 1e3, launches=counts, equal_to_linesearch=same,
                 accepted_share=accepted, **extra)
        if name == "acrobot":
            reset_launch_counts()
            _c, sel_rk4, full_rk4 = _two_pass(P, "rk4")
            torch.cuda.synchronize()
            counts_rk4 = dict(kernel_rollout.rollout_packed.mode_launches)
            r["rk4_equal_to_linesearch"] = _check_two_pass(
                P, "rk4", sel_rk4, full_rk4)[0]
            readings[f"rollout_packed/{name}#alphas_rk4"]["launches"] = (
                counts_rk4["alphas"])
        for integ in ("euler", "rk4") if name == "acrobot" else ("euler",):
            r[f"{integ}_two_pass_ms"] = time_ms(
                lambda: _two_pass(P, integ), reps=3)
            r[f"{integ}_linesearch_ms"] = time_ms(
                lambda: _linesearch(P, integ), reps=3)
        # the two passes' parts: the selection between them is ~130 small
        # PyTorch ops, each dispatched by the host, during which the card
        # waits; the two launches alone with the selection made before
        r["select_ms"] = time_ms(lambda: kernel_rollout.select_alpha(
            cand, P["alphas"], P["cost"], P["dv"][0], P["dv"][1],
            P["cfg"].z_min), reps=3)
        r["passes_ms"] = time_ms(lambda: _passes(P, "euler", sel[0]), reps=3)
        for group in MODE_READINGS[name]:
            if group != "alphas_rk4":
                readings[f"rollout_packed/{name}#{group}"]["launches"] = (
                    counts[group])
        print(f"[modes] (f) {name}: the two-pass line search on the rollout "
              f"modes (B={P['B']} T={P['T']} A={A}): {wall * 1e3:.3f} ms on "
              f"the host's clock, launches {counts}, bit for bit against "
              f"linesearch_packed {same}, accepted on "
              f"{accepted:.3f} of the lanes"
              + "".join(f", {k} {v}" for k, v in r.items()
                        if k.endswith("_equal") or k.startswith("rk4_e"))
              + "".join(f"; {integ}: the two passes {r[f'{integ}_two_pass_ms']:.3f}"
                        f" ms, linesearch_packed "
                        f"{r[f'{integ}_linesearch_ms']:.3f} ms"
                        for integ in ("euler", "rk4")
                        if f"{integ}_two_pass_ms" in r)
              + f"; euler's parts: the selection {r['select_ms']:.3f} ms, "
              f"the two launches alone {r['passes_ms']:.3f} ms")
        if not (same and all(v for k, v in r.items() if k.endswith("equal")
                             or k.endswith("_linesearch"))):
            raise AssertionError(f"(f) {name}: the rollout modes' line search "
                                 f"left the one-kernel line search: {r}")
        out[name] = r
    return out


# ---------------------------------------------------------------------------
# Phase 16: the CLI (python -m ilqr_tpu_torch) and the examples on the card

CLI_BATCH_ARGV = ["acrobot", "--batch", "8192", "--max-iter", "20"]
CLI_SINGLE_ARGV = ["pendulum", "--quiet", "-T", "60", "--max-iter", "15",
                   "--deriv-mode", "analytic", "--profile"]
CLI_QUAD_ARGV = ["quadrotor", "--batch", "1024", "--deriv-mode", "analytic",
                 "--integrator-scheme", "rk4", "--max-iter", "20"]
# (d): each example's arguments (its defaults) and the lines that its JAX
# counterpart prints and that it must print
EXAMPLES = {
    "quadrotor_waypoints": ([], ("solves/s (fused path)",
                                 "median final position error")),
    "free_flyer_docking": ([], ("solves/s (fused path)",
                                "per-craft peak thrust within own ceiling: "
                                "100%")),
    "mpc_fleet": ([], ("replans/s",)),
}


def _captured(fn, *args):
    """fn(*args) with its standard output captured, then printed."""
    import io as _io

    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    text = buf.getvalue()
    print(text, end="" if text.endswith("\n") else "\n")
    return result, text


def _stat(text, key):
    return next(line.split()[1] for line in text.splitlines()
                if line.strip().startswith(key))


def cli_batch(tmp):
    """(a): the acrobot batch through the CLI in a process of its own (fd,
    Euler, limits, the reference's unclamped rollout: the CLI's
    defaults), against an in-process solve_batch_fused on the same draw
    and config: the printed mean cost and iterations as printed, the CSV's
    best lane to its six decimals, written by the native writer."""
    import ilqr_tpu_torch.__main__ as cli
    from ilqr_tpu_torch.utils import io

    t0 = time.perf_counter()
    csv = os.path.join(tmp, "acrobot.csv")
    proc = subprocess.run(
        [sys.executable, "-m", "ilqr_tpu_torch", *CLI_BATCH_ARGV,
         "--output", csv], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    print(proc.stdout, end="")
    if proc.returncode != 0:
        raise AssertionError(f"(a) the CLI failed:\n{proc.stderr[-4000:]}")
    args = cli.build_parser().parse_args(CLI_BATCH_ARGV)
    model, params, _T, dt, x0, u0 = cli.problem(args.problem, args.horizon)
    sol = solve_batch_fused(model, params, cli.config(args), dt,
                            cli.batch_x0(x0, args.batch), u0)
    stats = {k: f"{float(v):.6g}" for k, v in
             convergence_stats(sol).items()}
    best = int(torch.argmin(sol.cost))
    xs, us = io.read_trajectory_csv(csv, model.n, model.m)
    six = lambda a: np.asarray([[float(f"{v:f}") for v in row]
                                for row in a.cpu().numpy()])
    ok = (stats["mean_cost"] == _stat(proc.stdout, "mean_cost")
          and stats["mean_iterations"] == _stat(proc.stdout,
                                                "mean_iterations")
          and np.array_equal(xs, six(sol.xs[best]))
          and np.array_equal(us, six(sol.us[best]))
          and "native CSV writer" in proc.stderr)
    out = dict(stats=stats, best=best, s=time.perf_counter() - t0, ok=ok)
    print(f"[cli] (a) python -m ilqr_tpu_torch {' '.join(CLI_BATCH_ARGV)}: "
          f"mean_cost {stats['mean_cost']}, mean_iterations "
          f"{stats['mean_iterations']} as printed, CSV (best lane {best}) "
          f"and stats equal to an in-process solve_batch_fused: {ok} "
          f"({proc.stderr.strip().splitlines()[-1]}); {out['s']:.1f} s")
    if not ok:
        raise AssertionError("(a) the CLI's batch left solve_batch_fused's")
    return out


def cli_single(tmp):
    """(b): a single problem through the CLI's composable route (solve),
    its TIMESTUFF report (profile_phases) and, where matplotlib is
    installed, its plot (a plot needs matplotlib, as in the JAX package)."""
    import importlib.util

    import ilqr_tpu_torch.__main__ as cli

    t0 = time.perf_counter()
    png = os.path.join(tmp, "single.png")
    plot = importlib.util.find_spec("matplotlib") is not None
    reset_launch_counts()
    _rc, text = _captured(cli.main, [*CLI_SINGLE_ARGV,
                                     *(["--plot", png] if plot else []),
                                     "--output",
                                     os.path.join(tmp, "single.csv")])
    counts = launch_counts()
    ok = (all(p in text for p in ("phase breakdown", "derivatives",
                                  "backward_pass", "forward_pass", "other"))
          and (not plot or open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n")
          and counts["derivs_packed"] > 0 and counts["rollout_packed"] > 0)
    out = dict(launches=counts, s=time.perf_counter() - t0, ok=ok)
    shown = "and the PNG" if plot else "(no matplotlib: no --plot)"
    print(f"[cli] (b) {' '.join(CLI_SINGLE_ARGV)}: launches {counts},"
          f" the TIMESTUFF phases {shown} {ok}; {out['s']:.1f} s")
    if not ok:
        raise AssertionError("(b) the single solve, its report or its plot")
    return out


def cli_quadrotor(tmp):
    """(c): the quadrotor batch from its hover u0 on the fused solver's
    JVP route (analytic + RK4; the split iteration at m·n = 48), its
    Solution checkpointed and restored onto the card bit for bit."""
    import ilqr_tpu_torch.__main__ as cli
    from ilqr_tpu_torch.utils import checkpoint

    t0 = time.perf_counter()
    reset_launch_counts()
    sol, _text = _captured(cli.run, cli.build_parser().parse_args(
        [*CLI_QUAD_ARGV, "--output", os.path.join(tmp, "quadrotor.csv")]))
    counts = launch_counts()
    path = os.path.join(tmp, "quadrotor_solution.npz")
    checkpoint.save(path, sol)
    back = checkpoint.restore(path, sol)
    ok = (all(a.device == b.device and a.dtype == b.dtype
              and torch.equal(a, b) for a, b in zip(back, sol))
          and bool(torch.isfinite(sol.cost).all())
          and counts["sweep_packed"] > 0 and counts["linesearch_packed"] > 0)
    out = dict(launches=counts, mean_cost=float(sol.cost.mean()),
               s=time.perf_counter() - t0, ok=ok)
    print(f"[cli] (c) {' '.join(CLI_QUAD_ARGV)}: mean cost "
          f"{out['mean_cost']:.6g}, launches {counts}, the checkpoint "
          f"restored bit for bit on {back.cost.device}: {ok}; "
          f"{out['s']:.1f} s")
    if not ok:
        raise AssertionError("(c) the quadrotor batch or its checkpoint")
    return out


def cli_examples():
    """(d): the three examples at their default sizes: the lines they must
    print, and every cost finite."""
    import importlib

    t0 = time.perf_counter()
    for name, (argv, wanted) in EXAMPLES.items():
        mod = importlib.import_module(f"ilqr_tpu_torch.examples.{name}")
        result, text = _captured(mod.main, argv)
        cost = result.plan.cost if name == "mpc_fleet" else result.cost
        if not (all(w in text for w in wanted) and "nan" not in text
                and bool(torch.isfinite(cost).all())):
            raise AssertionError(f"(d) {name}: {text}")
    s = time.perf_counter() - t0
    print(f"[cli] (d) the three examples at their default sizes: their "
          f"checks hold, every cost finite; {s:.1f} s")
    return dict(s=s)


def cli_unported(tmp):
    """(e): the options the port does not carry raise before anything
    runs: no kernel launched, no CSV written."""
    import ilqr_tpu_torch.__main__ as cli

    reset_launch_counts()
    out = os.path.join(tmp, "none.csv")
    for flags in (["--x64"], ["--full-ddp"],
                  ["--backward-mode", "assoc", "--no-control-limits"]):
        try:
            cli.main(["integrator", *flags, "--output", out])
        except NotImplementedError as e:
            print(f"[cli] (e) {' '.join(flags)}: NotImplementedError: {e}")
        else:
            raise AssertionError(f"(e) {flags} did not raise")
    if (any(launch_counts().values())
            or any(kernel_rollout.rollout_packed.mode_launches.values())
            or os.path.exists(out)):
        raise AssertionError("(e) an unported option launched a kernel")
    return dict(ok=True)


def run_cli_phase(tmp):
    """Phase 16 (a)-(e): the CLI and the examples on the card, writing
    into ``tmp``."""
    return dict(a=cli_batch(tmp), b=cli_single(tmp), c=cli_quadrotor(tmp),
                d=cli_examples(), e=cli_unported(tmp))


# After phase 4 the phases run side by side, beside phase 3b's workers:
# each of STREAMS in a process of its own, MAIN_PHASES (whose CPU references
# run in pools of their own) in this one. The phases are host bound, one
# PyTorch op or launch at a time, so side by side they take about the time
# their work takes on the host's cores, not the sum of their times. Each
# process sets its launch counts to 0 and reads them around the paths it
# drives.
STREAMS = (("5", "6", "7", "8"), ("9", "10", "16"), ("11",), ("12", "13"))
MAIN_PHASES = ("14", "15")
PHASE_LABELS = {
    "5": "phase 5 (split route, plain path)",
    "6": "phase 6 (composable path)",
    "7": "phase 7 (equivalence)",
    "8": "phase 8 (the m = 2…4 slice)",
    "9": "phase 9 (the m ≥ 5 slice)",
    "10": "phase 10 (pendulum, cartpole, bicycle, power_mass)",
    "11": "phase 11 (the stencils in the fused kernels, RK4)",
    "12": "phase 12 (the dual-number slice: analytic + RK4, the split "
          "sweep)",
    "13": "phase 13 (per-problem params, the fleet warm start and MPC)",
    "14": "phase 14 (the composable solver at m ≥ 2, the single MPC)",
    "15": "phase 15 (custom models: the unicycle and unicycle_heading)",
    "16": "phase 16 (the CLI, the examples, the rollout modes' line search)",
}


class Launches(dict):
    """Launch counts by the key of a phase 3 row (or reading): ``key in``
    asks whether phase 3 compares ``key``; a compared key's dict is made at
    its first use, any other key raises KeyError."""

    def __init__(self, compared):
        super().__init__()
        self.compared = frozenset(compared)

    def __contains__(self, key):
        return key in self.compared

    def __missing__(self, key):
        if key not in self.compared:
            raise KeyError(key)
        value = self[key] = {}
        return value


def compared_keys(pending):
    """(row keys, reading keys) of phase 3, as collect_comparisons makes
    them."""
    rows, readings = set(), set()
    for key in pending.order:
        meta = pending.metas[key]
        if meta["group"] in ("row", "fd_of"):
            rows.add(meta["row"])
        elif meta["group"] != "edge":
            readings.add(meta["row"] + READING_SUFFIX[meta["group"]])
    return sorted(rows), sorted(readings)


def run_phase(phase, main_out, rows, readings, out):
    """Phase ``phase`` (its number); ``main_out`` is phase 4's result. Its
    results go into ``out`` by their keys in the summary line, the launches
    of its paths into ``rows`` and ``readings``."""
    dev = torch.device(DEVICE)
    model, params, cfg = flagship()
    if phase == "5":
        split_counts, out["split_path"] = run_split_path(dev, model, params,
                                                         cfg)
        for name in ("sweep_packed", "linesearch_packed"):
            rows[f"{name}/acrobot"]["launches"] = split_counts[name]
    elif phase == "6":
        comp_out = out["composable_path"] = run_composable_path(
            dev, model, params, cfg, main_out)
        for name in ("derivs_packed", "backward_sweep_packed"):
            rows[f"{name}/acrobot"]["launches"] = comp_out["launches"][name]
    elif phase == "7":
        out["equivalence"] = run_equivalence(dev, model, params, cfg)
    elif phase == "8":
        out["slice"] = run_slice(dev, rows)
    elif phase == "9":
        out["wide_slice"] = run_wide_slice(dev, rows)
    elif phase == "10":
        out["cli_slice"] = run_cli_slice(dev, rows)
    elif phase == "11":
        out["fd_slice"] = run_fd_slice(dev, rows, readings)
    elif phase == "12":
        out["jvp_slice"] = run_jvp_slice(dev, rows, readings)
    elif phase == "13":
        out["lanes_slice"] = run_lanes_slice(dev, readings)
    elif phase == "14":
        out["composable_slice"] = run_composable_slice(dev, rows, readings)
    elif phase == "15":
        out["custom_slice"] = run_custom_slice(dev, rows, readings)
    else:   # "16"
        with tempfile.TemporaryDirectory() as tmp:
            out["entry_point"] = run_cli_phase(tmp)
        out["entry_point"]["f"] = run_modes_path(dev, readings)


def run_phases(phases, main_out, keys):
    """``phases`` one after another, each's seconds printed; ``keys`` are
    phase 3's (compared_keys). Returns (their results by their keys in the
    summary line, each phase's launches: (by row, by reading))."""
    out, launches = {}, {}
    for phase in phases:
        rows, readings = Launches(keys[0]), Launches(keys[1])
        t0 = time.perf_counter()
        run_phase(phase, main_out, rows, readings, out)
        launches[phase] = (dict(rows), dict(readings))
        print(f"[time] {PHASE_LABELS[phase]} {time.perf_counter() - t0:.1f} "
              f"s", flush=True)
    return out, launches


def _stream_main(which, main_out, keys, log_path, conn):
    """A stream's process, phases ``which``: its prints go to
    ``log_path``; it sends ("ok", results, each phase's launches, its peak
    card memory) or ("error", the traceback)."""
    sys.stdout = open(log_path, "w", buffering=1)
    torch.set_num_threads(STREAM_THREADS)
    try:
        out, launches = run_phases(which, main_out, keys)
        msg = ("ok", out, launches, torch.cuda.max_memory_reserved())
    except BaseException:
        msg = ("error", traceback.format_exc())
    sys.stdout.flush()
    conn.send(msg)
    conn.close()


class Stream(NamedTuple):
    which: tuple       # its phases
    proc: multiprocessing.process.BaseProcess
    conn: object
    log: str


def start_stream(ctx, which, main_out, keys, tmp):
    log = os.path.join(tmp, f"phases_{'_'.join(which)}.log")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_stream_main,
                       args=(which, main_out, keys, log, send))
    proc.start()
    send.close()   # so that recv sees the end if the process dies
    return Stream(which, proc, recv, log)


def finish_stream(stream):
    """Waits for ``stream`` and prints its log. Returns (its results, each
    of its phases' launches); raises if it failed."""
    try:
        msg = stream.conn.recv()
    except EOFError:
        msg = None
    stream.proc.join()
    print(f"[stream] phases {', '.join(stream.which)}, in a process of "
          f"their own (exit code {stream.proc.exitcode}); their log:")
    with open(stream.log) as f:
        print(f.read(), end="", flush=True)
    if msg is None:
        raise AssertionError(f"phases {stream.which}: the process ended "
                             f"without a result")
    if msg[0] != "ok":
        raise AssertionError(f"phases {stream.which} failed:\n{msg[1]}")
    _ok, out, launches, peak = msg
    print(f"[stream] phases {', '.join(stream.which)}: peak "
          f"{peak / 2**30:.1f} GiB reserved on the card")
    return out, launches


def merge_launches(rows, readings, launches):
    """The launches the paths counted, into phase 3's rows and readings,
    phase by phase in their order (a later phase's count of a kernel
    replaces an earlier one's, as when the phases ran one after another)."""
    for phase in sorted(launches, key=int):
        for got, into, what in zip(launches[phase], (rows, readings),
                                   ("row", "reading")):
            for key, fields in got.items():
                if key not in into:
                    raise AssertionError(f"launches counted for {key}, a "
                                         f"{what} phase 3 did not compare")
                into[key].update(fields)


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
    # the main library and the custom models' libraries, all their nvcc
    # processes started together: the custom ones fill the cores the main
    # build leaves idle in its tail
    customs = custom_models()

    def timed(fn, *args):
        out = fn(*args)
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(1 + len(customs)) as pool:
        main_build = pool.submit(timed, _build.build)
        custom_builds = {name: pool.submit(timed, _build.build_model, model)
                         for name, model in customs.items()}
        lib, main_s = main_build.result()
        custom_s = {name: f.result()[1] for name, f in custom_builds.items()}
    _build.library()
    for model in customs.values():
        _build.model_library(model)
    print(f"[build] {lib.name} from {len(_build.sources())} sources in "
          f"{main_s:.1f} s (nvcc "
          f"{' '.join(_build.NVCC_FLAGS)}, one process per .cu); seconds "
          f"per source {json.dumps(_build.compile_seconds())}")
    for name, model in customs.items():
        print(f"[build] lib{name}.so (the custom model {name}: "
              f"{_build.model_dir(model)}) done {custom_s[name]:.1f} s after "
              f"the start; seconds per source "
              f"{json.dumps(_build.model_compile_seconds(model))}")
    print(f"[build] all libraries in {time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_table(_build.build_log())
    ptxas.update(custom_ptxas())
    for (kernel, model_name, limits), e in sorted(
            ptxas.items(), key=lambda kv: str(kv[0])):
        print(f"[build] {kernel}<{model_name}"
              + ("" if limits is None else f", {limits}"
                 if isinstance(limits, str) else f", limits={limits}")
              + f">: {e.get('registers')} registers, "
              f"{e.get('stack_bytes')} B stack, {e.get('spill_stores')} B "
              f"spill stores, {e.get('spill_loads')} B spill loads")
    occupancy = launcher_occupancy()
    widths = {name: team_width(model) for name, model in [
        (name, get_model(name)) for name in kernel_rollout.FUSED_KERNEL_MODELS]
        + list(customs.items())}
    for (kernel, model_name, limits), (blocks, threads, smem) in sorted(
            occupancy.items(), key=lambda kv: str(kv[0])):
        if not held_bitwise(kernel):
            continue
        e = ptxas.get((kernel, model_name, limits), {})
        what = ("a warp per lane, 4 lanes a block"
                if kernel.startswith(("sweep_team_kernel",
                                      "iteration_warp_kernel"))
                else "a team per lane, fed by a cp.async ring"
                if kernel == "backward_team_kernel"
                else "a thread per (t, lane) storing each entry as it is made, "
                "256 lanes of one step a block" if kernel.startswith("derivs_entry_kernel")
                else f"a team of {widths[model_name]} threads per "
                f"lane, {128 // widths[model_name]} lanes a block"
                if kernel.startswith(("iteration_team_kernel",
                                      "sweep_small_team_kernel"))
                else "a team of 16 threads per lane, 8 lanes a block")
        print(f"[build] {kernel}<{model_name}"
              + ("" if limits is None else f", {limits}"
                 if isinstance(limits, str) else f", limits={limits}")
              + f"> ({what}): {e.get('registers')} registers, "
              f"{e.get('stack_bytes')} B stack, {e.get('spill_stores')} / "
              f"{e.get('spill_loads')} B spill stores / loads; {blocks} "
              f"blocks of {threads} threads per SM, {smem} B of shared "
              f"memory per block")

    t_phase = t0

    def tick(label):
        nonlocal t_phase
        now = time.perf_counter()
        print(f"[time] {label} {now - t_phase:.1f} s", flush=True)
        t_phase = now

    tick("phases 1-2 (environment, build)")
    ctx = multiprocessing.get_context("spawn")
    # the workers start (and import) while phase 3a times the kernels; they
    # touch the card only when 3b hands them their cases
    pool = ctx.Pool(COMPARE_WORKERS, initializer=_worker_init)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    streams = []
    try:
        pending = time_kernels(dev)
        tick(f"phase 3a (kernel times, {len(pending.order)} cases)")
        keys = compared_keys(pending)
        model, params, cfg = flagship()
        main_out = run_main_path(dev, model, params, cfg)
        launches = {"4": ({f"{name}/acrobot": dict(
            launches=main_out["launches"][name])
            for name in ("rollout_packed", "iteration_packed")}, {})}
        main_out["profile"] = profile_solve(
            "fused", lambda x0, u0: solve_batch_fused(model, params, cfg, DT,
                                                      x0, u0),
            float(np.median(main_out["wall_s"])))
        tick("phase 4 (the flagship path, alone on the card)")
        # from here on the card is shared: phase 3b's workers, STREAMS in
        # processes of their own, MAIN_PHASES in this one
        t3b = time.perf_counter()
        plain = pool.map_async(_worker_job, pending.jobs, chunksize=1)
        streams = [start_stream(ctx, which, main_out, keys, tmp)
                   for which in STREAMS]
        stream_out, main_launches = run_phases(MAIN_PHASES, main_out, keys)
        launches.update(main_launches)
        print(f"[stream] this process: peak "
              f"{torch.cuda.max_memory_reserved() / 2**30:.1f} GiB reserved "
              f"on the card")
        results = {}
        for job_results in plain.get():
            results.update(job_results)
        pool.close()
        pool.join()
        tick(f"phase 3b (the rest of the workers' plain versions, "
             f"{COMPARE_WORKERS} processes)")
        # the edge cases' dense plain versions once the workers are done
        n_edges = len(pending.main_cases)
        results.update(compare_edges(pending))
        wall_3b = time.perf_counter() - t3b
        tick(f"phase 3b (the edge cases' plain versions, {n_edges} in this "
             f"process)")
        for stream in streams:
            out, stream_launches = finish_stream(stream)
            stream_out.update(out)
            launches.update(stream_launches)
        tick("the streams' phases (the rest of their processes' time)")
        rows, readings = collect_comparisons(pending, results, wall_3b)
    finally:
        pool.terminate()
        pool.join()
        for stream in streams:
            if stream.proc.is_alive():
                stream.proc.terminate()
            stream.proc.join()
        shutil.rmtree(tmp, ignore_errors=True)
    merge_launches(rows, readings, launches)
    check_custom_bitwise(rows, readings)
    print(f"[time] phases 2-16 {time.perf_counter() - t0:.1f} s", flush=True)
    missing = [key for key, r in readings.items()
               if r["kernel"] == "rollout_modes_kernel"
               and not r.get("launches")]
    if missing:
        raise AssertionError(f"a rollout mode was never launched on its "
                             f"path: {missing}")
    for key, r in readings.items():   # a mode of a row's kernel
        if r["kernel"] == "rollout_modes_kernel":
            r.update(ptxas.get((r["kernel"], r["model"], None), {}))
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
        limits = (r["limits"] if r["kernel"].startswith(LIMITS_KERNELS)
                  else next((k[2] for k in occupancy if k[0] == r["kernel"]
                             and k[1] == r["model"]), None)
                  if r["kernel"] == "backward_team_kernel" else None)
        r.update(ptxas.get((r["kernel"], r["model"], limits), {}))
        if (r["kernel"], r["model"], limits) in occupancy:
            (r["blocks_per_sm"], r["block_threads"],
             r["smem_per_block"]) = occupancy[(r["kernel"], r["model"],
                                               limits)]
    if not all(r.get("launches") for r in rows.values()):
        raise AssertionError(f"a kernel was never launched: {rows}")
    if not all(rows[f"{kind}_packed/{name}"].get("lanes_launches")
               for name, kinds in LANES_KERNELS.items() for kind in kinds):
        raise AssertionError("a per-lane params kernel was never launched on "
                             "its path")

    print(json.dumps({"main_path": main_out, **{
        key: stream_out[key] for key in (
            "split_path", "composable_path", "equivalence", "slice",
            "wide_slice", "cli_slice", "fd_slice", "jvp_slice",
            "lanes_slice", "composable_slice", "custom_slice",
            "entry_point")}}))
    print(json.dumps({"kernels": list(rows.values())}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
