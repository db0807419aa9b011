"""Per-phase timing, the reference's TIMESTUFF report (ref:
src/ilqr_core.cpp:2, 95-100, 290-298: total / derivatives / backward /
forward / other), counterpart of ``ilqr_tpu/utils/timing.py``.

Work on the card is asynchronous, so a phase is fenced by
``torch.cuda.synchronize()`` on the tensors it names (CUDA ones; CPU work
is synchronous and needs no fence). For kernel-level detail,
:func:`profile` records a ``torch.profiler`` trace and
:func:`summarize_trace` reduces it by (plane, event name).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from collections import defaultdict
from pathlib import Path

import torch

PROFILE_DIR = (Path(__file__).resolve().parents[2] / "build"
               / "ilqr_tpu_torch" / "profile")


def fence(*tensors) -> None:
    """Waits for the card's work on each CUDA tensor among ``tensors``;
    CPU tensors and None need no wait."""
    for x in tensors:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)


class PhaseTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, *fence_on):
        start = time.perf_counter()
        yield
        fence(*fence_on)
        dt = time.perf_counter() - start
        self.totals[name] += dt
        self.counts[name] += 1

    def report(self) -> str:
        lines = ["phase breakdown (seconds):"]
        total = sum(self.totals.values())
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name:<20s} {t:9.4f}  ({self.counts[name]} calls)")
        lines.append(f"  {'total':<20s} {total:9.4f}")
        return "\n".join(lines)


@contextlib.contextmanager
def profile(logdir=PROFILE_DIR):
    """Records a ``torch.profiler`` trace of the block (the host's
    operations and, with a card, its kernels and copies) and writes it to
    ``logdir/trace.json`` (Chrome trace format; :func:`summarize_trace`
    reads it)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# the trace's event categories that ran on the card
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation"}


def summarize_trace(logdir=PROFILE_DIR, top: int = 40):
    """Aggregates a :func:`profile` trace by (plane, event name): returns
    ``(planes, trace_path)`` where planes maps a plane name (``/host:CPU``,
    ``/device:GPU:<i>``) to ``{n_events, n_lines, span_ms, top_events:
    [{name, total_us, count, mean_us}, ...]}`` sorted by total time — the
    JAX package's shape, read from the torch profiler's Chrome trace
    instead of an xplane dump."""
    paths = glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no trace .json under {logdir}")
    path = max(paths, key=os.path.getsize)
    with open(path) as f:
        trace = json.load(f)
    events = (trace.get("traceEvents", []) if isinstance(trace, dict)
              else trace)
    by_plane = defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        if ev.get("cat") in _DEVICE_CATS:
            plane = f"/device:GPU:{ev.get('args', {}).get('device', 0)}"
        else:
            plane = "/host:CPU"
        by_plane[plane].append(ev)
    planes = {}
    for plane, evs in sorted(by_plane.items()):
        agg = {}
        lines = set()
        lo, hi = None, 0.0
        for ev in evs:
            a = agg.setdefault(ev.get("name", "?"), [0.0, 0])
            a[0] += float(ev["dur"])
            a[1] += 1
            lines.add((ev.get("pid"), ev.get("tid")))
            t0 = float(ev["ts"])
            lo = t0 if lo is None or t0 < lo else lo
            hi = max(hi, t0 + float(ev["dur"]))
        top_events = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
        planes[plane] = {
            "n_events": len(evs),
            "n_lines": len(lines),
            "span_ms": round((hi - lo) / 1e3, 3) if lo is not None else 0.0,
            "top_events": [
                {"name": k[:120], "total_us": round(v[0], 1), "count": v[1],
                 "mean_us": round(v[0] / max(v[1], 1), 2)}
                for k, v in top_events],
        }
    return planes, path


def profile_phases(model, params, cfg, dt, x0, u0, n_iters: int = 5,
                   batch: int = 0, device=None):
    """Per-phase breakdown of one solve — the reference's TIMESTUFF report
    (ref: src/ilqr_core.cpp:95-100, 290-298: total / derivatives / backward
    / forward / other) — over the composable solver's stages
    (``ops/derivatives.compute_derivs``, ``ops/backward.backward_pass``,
    ``ops/rollout.line_search``), each fenced. ``batch`` > 0 profiles a
    batch of that many copies of the problem instead of one. ``device``
    as the solvers take it (the card by default). Returns (PhaseTimer,
    report string)."""
    from ilqr_tpu_torch.ops.backward import backward_pass
    from ilqr_tpu_torch.ops.derivatives import compute_derivs
    from ilqr_tpu_torch.ops.kernel_rollout import pack_params
    from ilqr_tpu_torch.ops.rollout import line_search
    from ilqr_tpu_torch.solver import (
        as_f32,
        check_supported,
        init_state,
        limits,
        resolve_device,
    )

    check_supported(model, cfg)
    dev = resolve_device(device)
    pp = pack_params(params, dt, dev)
    x0, u0 = as_f32(x0, dev), as_f32(u0, dev)
    lanes = max(batch, 1)
    x0 = x0.expand((lanes,) + tuple(x0.shape)).contiguous()
    u0 = u0.expand((lanes,) + tuple(u0.shape)).contiguous()
    u_min, u_max = limits(pp)

    timer = PhaseTimer()
    state = init_state(model, pp, cfg, x0, u0)
    fence(state.cost)
    lam = state.lam
    k_last = state.k[:, -1]
    xs, us, cost = state.xs, state.us, state.cost

    def derivs():
        return compute_derivs(model, pp, cfg, xs, us)

    def backward(d):
        return backward_pass(d, us, lam, u_min, u_max, cfg, k_last)

    def forward(br):
        return line_search(model, pp, cfg, x0, xs, us, br.k, br.K, br.dV,
                           cost)

    # warm-up (the kernel library's first load) outside the timers
    fence(forward(backward(derivs())).cost)

    for _ in range(n_iters):
        with timer.phase("derivatives"):
            d = derivs()
            fence(d.fx)
        with timer.phase("backward_pass"):
            br = backward(d)
            fence(br.k)
        with timer.phase("forward_pass"):
            ls = forward(br)
            fence(ls.cost)
        with timer.phase("other"):
            acc = ls.accepted
            xs = torch.where(acc[:, None, None], ls.xs, xs)
            us = torch.where(acc[:, None, None], ls.us, us)
            cost = torch.where(acc, ls.cost, cost)
            k_last = br.k[:, -1]
            fence(cost)

    return timer, timer.report()
