#!/usr/bin/env python3
"""One lane of the CLI's acrobot fd + RK4 batch solve, alone on the card,
replayed iteration by iteration through the plain versions on the CPU.

    python3 tools/c2_replay.py card [--lane 36] [--out FILE]
    python3 tools/c2_replay.py replay FILE [--out JSON]

``card`` (one CUDA device) builds acrobot's two kernel sources
(csrc/kernels.cu, csrc/kernels_acrobot_fd.cu) with the package's nvcc
flags and solves lane LANE of ``chip_smoke.cli_workload("acrobot", 8192)``
with ``integrator="rk4"`` (the CLI's config: the stencils, limits on,
max_iter 100) through ``solve_batch_fused`` at B = 1. It records, on the
host, every call of the fused solver's iteration (``fused._iteration``:
its state in and out) and every ``iteration_packed`` launch in it (λ,
the live mask, and the selected α, acceptance, dcost, expected reduction,
line-search cost, divergence flag and gnorm), and writes them with the
final cost to FILE (default build/c2_card.pt). It also solves lanes
0-63 at B = 64 and prints lane LANE's cost there beside the B = 1 one:
each lane's result does not depend on its batch.

``replay`` (the CPU) carries the card's state at the start of each
iteration into one iteration of the port's plain versions
(``fused._iteration`` on CPU tensors, the same retries and bookkeeping;
one iteration a worker process, --workers of them) and sets its outputs
beside the card's: the largest relative gap |cpu − card| / (1 + |card|)
of each part of the state (trajectory, controls, gains, cost, λ, dλ),
beside the same gap between two CPU replays whose starting trajectories
differ by one ulp (the size of a rounding difference there), and whether
every launch selected the same α, acceptance and divergence flag. Where the line search
parts, its margin: each candidate's (dcost − z_min · expected) in ulps of
the previous cost on each side (the candidates' costs from the plain
rollout with that side's gains, dV from the plain sweep) and the first
candidate whose acceptance differs; and for every iteration gnorm's
distance from tol_grad in its ulps. Writes the iterations' records as
JSON (default beside FILE) and prints one line an iteration and a
summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

B_CLI = 8192       # the CLI batch whose draw the lane is taken from
BATCH_CHECK = 64   # the lanes solved together as the batch check
FIELDS = ("xs_body", "x_term", "us", "k", "K", "cost", "lam", "dlam")


def _problem(smoke, lane):
    model, params, cfg, T, dt, u0, x0 = smoke.cli_workload("acrobot", B_CLI)
    return model, params, cfg.replace(integrator="rk4"), dt, u0, x0


def _host(state):
    return {k: v.detach().cpu().clone() for k, v in state._asdict().items()}


def card(lane: int, out: Path) -> int:
    import _ab

    if not torch.cuda.is_available():
        print("c2_replay: no CUDA device", file=sys.stderr)
        return 2
    _build, _lib, smoke = _ab.load_tree(
        ROOT, "c2", ["kernels.cu", "kernels_acrobot_fd.cu"])
    from ilqr_tpu_torch import fused

    model, params, cfg, dt, u0, x0 = _problem(smoke, lane)
    iterations, launches = [], []
    run_iteration, run_launch = fused._iteration, fused.iteration_packed

    def iteration(*args):
        before = _host(args[-1])
        first = len(launches)
        after = run_iteration(*args)
        iterations.append(dict(state_in=before, state_out=_host(after),
                               launches=(first, len(launches))))
        return after

    def launch(*args, **kw):
        outs = run_launch(*args, **kw)
        launches.append(dict(
            lam=args[10].cpu().clone(), live=args[12].cpu().clone(),
            ls_cost=outs[5].cpu().clone(), alpha=outs[6].cpu().clone(),
            accepted=outs[7].cpu().clone(), dcost=outs[8].cpu().clone(),
            expected=outs[9].cpu().clone(), div=outs[10].cpu().clone(),
            gnorm=outs[11].cpu().clone()))
        return outs

    iteration.calls = iteration.retried = 0   # what the solver counts
    fused._iteration, fused.iteration_packed = iteration, launch
    t0 = time.perf_counter()
    try:
        sol = fused.solve_batch_fused(model, params, cfg, dt,
                                      x0[lane:lane + 1], u0)
        cost = float(sol.cost.cpu()[0])
    finally:
        fused._iteration, fused.iteration_packed = run_iteration, run_launch
    alone_s = time.perf_counter() - t0
    batch = fused.solve_batch_fused(model, params, cfg, dt,
                                    x0[:BATCH_CHECK], u0).cost.cpu()
    in_batch = float(batch[lane]) if lane < BATCH_CHECK else None
    print(f"[c2] lane {lane} alone (B = 1): cost {cost:.4f} after "
          f"{int(sol.iterations.cpu()[0])} iterations, reason "
          f"{int(sol.reason.cpu()[0])}, {len(iterations)} iteration calls, "
          f"{len(launches)} iteration_packed launches, {alone_s:.1f} s; in "
          f"the first {BATCH_CHECK} lanes (B = {BATCH_CHECK}): {in_batch}; "
          f"{smoke.nvidia_smi()}", flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(lane=lane, cost=cost, cost_in_batch=in_batch,
                    iterations_done=int(sol.iterations.cpu()[0]),
                    reason=int(sol.reason.cpu()[0]), iterations=iterations,
                    launches=launches, smi=smoke.nvidia_smi(),
                    device=torch.cuda.get_device_name(0)), out)
    print(f"[c2] wrote {out}")
    return 0


def _gap(a, b) -> float:
    """max |a − b| / (1 + |b|), NaN where only one side is NaN."""
    a, b = a.double(), b.double()
    both = torch.isnan(a) & torch.isnan(b)
    if bool((torch.isnan(a) ^ torch.isnan(b)).any()):
        return float("nan")
    d = ((a - b).abs() / (1 + b.abs()))[~both]
    return float(d.max()) if d.numel() else 0.0


def _ulps(x: float, ref: float) -> float:
    """x in ulps of the f32 value ref."""
    r = np.float32(abs(ref)) if ref else np.float32(1e-30)
    return float(x / float(np.spacing(r)))


def _candidate_margins(model, cfg, pp, x0, st, k, K, cprev, dv):
    """(dcost − z_min · expected) of each α candidate, in ulps of cprev, and
    whether it is accepted, for the gains k, K around the state st and the
    sweep's dV (the plain rollout on the CPU)."""
    from ilqr_tpu_torch.ops import kernel_rollout

    alphas = torch.tensor([float(a) for a in cfg.alphas])
    A, B = len(alphas), st["us"].shape[-1]
    costs = kernel_rollout.rollout_plain(
        model, cfg.integrator, cfg.clamp_forward, pp, x0, st["us"],
        st["xs_body"], K, costs_only=True, candidates=A, k=k,
        alphas=alphas).reshape(A, B)[:, 0]
    dcost = cprev - costs.double()
    expected = -alphas.double() * (dv[0] + alphas.double() * dv[1])
    margin = dcost - cfg.z_min * expected
    return [_ulps(float(v), float(cprev)) for v in margin], [
        bool(v) for v in (torch.where(expected > 0, dcost / expected,
                                      torch.sign(dcost)) > cfg.z_min)]


_REPLAY = {}   # what a worker process replays: set by _replay_init


def _replay_init(path: str):
    import chip_smoke as smoke
    from ilqr_tpu_torch.ops import kernel_rollout

    torch.set_num_threads(1)
    rec = torch.load(path, weights_only=False)
    lane = rec["lane"]
    model, params, cfg, dt, _u0, x0 = _problem(smoke, lane)
    _REPLAY.update(
        rec=rec, model=model, cfg=cfg,
        pp=kernel_rollout.pack_params(params, dt),
        x0=torch.as_tensor(x0[lane:lane + 1]).t().contiguous(),
        alphas=torch.tensor([float(a) for a in cfg.alphas]),
        factor=torch.tensor(cfg.lambda_factor))


def _plain_iteration(state_in: dict):
    """One iteration of the plain versions from ``state_in``: the new state
    and each iteration_packed call's selection and gains."""
    from ilqr_tpu_torch import fused

    r, launches = _REPLAY, []
    run_launch = fused.iteration_packed

    def launch(*args, **kw):
        outs = run_launch(*args, **kw)
        launches.append(dict(alpha=outs[6], accepted=outs[7], div=outs[10],
                             k=outs[3], K=outs[4], lam=args[10]))
        return outs

    state = fused.FusedState(**{k: v.clone() for k, v in state_in.items()})
    fused.iteration_packed = launch
    try:
        got = fused._iteration(r["model"], r["cfg"], r["pp"], r["x0"],
                               r["alphas"], r["factor"], state)._asdict()
    finally:
        fused.iteration_packed = run_launch
    return got, launches


def _decisions(launches):
    return [(float(c["alpha"][0]), float(c["accepted"][0]),
             float(c["div"][0])) for c in launches]


def _replay_one(i: int) -> dict:
    """Iteration i of the record, replayed from the card's state at its
    start; beside it the same replay from that state moved by one ulp
    (every entry of the trajectory to its next f32 up), the size of a
    rounding difference at that point."""
    from ilqr_tpu_torch.ops import kernel_sweep

    r = _REPLAY
    rec, model, cfg = r["rec"], r["model"], r["cfg"]
    it = rec["iterations"][i]
    got, cpu_l = _plain_iteration(it["state_in"])
    nudged = dict(it["state_in"])
    for f in ("xs_body", "x_term"):
        nudged[f] = torch.nextafter(nudged[f], torch.tensor(float("inf")))
    got_n, nudge_l = _plain_iteration(nudged)
    want = it["state_out"]
    card_l = rec["launches"][slice(*it["launches"])]
    card_d, cpu_d = _decisions(card_l), _decisions(cpu_l)
    row = dict(iteration=i,
               gap={f: _gap(got[f], want[f]) for f in FIELDS},
               nudge_gap={f: _gap(got_n[f], got[f]) for f in FIELDS},
               card_decisions=card_d, cpu_decisions=cpu_d,
               nudged_decisions=_decisions(nudge_l),
               same_decisions=card_d == cpu_d,
               card_cost=float(want["cost"][0]),
               cpu_cost=float(got["cost"][0]),
               card_reason=int(want["reason"][0]),
               cpu_reason=int(got["reason"][0]),
               # the stopping test's distance from its threshold
               gnorm_to_tol_ulps=_ulps(float(want["gnorm"][0])
                                       - cfg.tol_grad, cfg.tol_grad))
    st_in = it["state_in"]
    for j, (c, p) in enumerate(zip(card_l, cpu_l)):
        if card_d[j][:2] == cpu_d[j][:2]:
            continue
        # the launch where the selection parts: each side's candidates
        # around the same state with its own gains, and dV of the plain
        # sweep there
        dv = kernel_sweep.sweep_plain(
            model, cfg.integrator, r["pp"], st_in["xs_body"],
            st_in["x_term"], st_in["us"], p["lam"], mode="fd",
            use_limits=cfg.use_control_limits,
            eps=cfg.fd_eps)[2][:, 0].double()
        sides = {}
        for side, gains in (("cpu", (p["k"], p["K"])),
                            ("card", (want["k"], want["K"]))):
            margins, acc = _candidate_margins(
                model, cfg, r["pp"], r["x0"], st_in, gains[0], gains[1],
                float(st_in["cost"][0]), dv)
            sides[side] = dict(margin_ulps=margins, accepted=acc)
        row["parted_at_launch"] = j
        row["first_differing_candidate"] = next(
            (a for a in range(len(cfg.alphas))
             if sides["cpu"]["accepted"][a] != sides["card"]["accepted"][a]),
            None)
        row["margins"] = sides
        break
    return row


def replay(path: Path, out: Path, workers: int) -> int:
    import multiprocessing

    rec = torch.load(path, weights_only=False)
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers, initializer=_replay_init,
                  initargs=(str(path),)) as pool:
        rows = []
        for row in pool.imap(_replay_one, range(len(rec["iterations"]))):
            rows.append(row)
            _print_row(row)
    return _replay_summary(rec, rows, t0, workers, out)


def _print_row(row):
    g, ng = row["gap"], row["nudge_gap"]
    print(f"[replay] iteration {row['iteration']}: gap cost "
          f"{g['cost']:.2e} xs {g['xs_body']:.2e} K {g['K']:.2e} (one-ulp "
          f"nudge: cost {ng['cost']:.2e} xs {ng['xs_body']:.2e} K "
          f"{ng['K']:.2e}); (α, accepted, div) card {row['card_decisions']} "
          f"cpu {row['cpu_decisions']} nudged {row['nudged_decisions']}; "
          f"cost card {row['card_cost']:.6f} cpu {row['cpu_cost']:.6f}"
          + ("" if row["same_decisions"] else
             f"; first differing candidate "
             f"{row.get('first_differing_candidate')}, margins (ulps of the "
             f"cost) card {_short(row, 'card')} cpu {_short(row, 'cpu')}"),
          flush=True)


def _replay_summary(rec, rows, t0, workers, out):
    worst = lambda key, f: max(r[key][f] for r in rows)
    summary = dict(
        lane=rec["lane"], card_cost=rec["cost"],
        card_cost_in_batch=rec["cost_in_batch"], iterations=len(rows),
        differing_iterations=[r["iteration"] for r in rows
                              if not r["same_decisions"]],
        nudge_differing_iterations=[
            r["iteration"] for r in rows
            if r["nudged_decisions"] != r["cpu_decisions"]],
        max_gap={f: worst("gap", f) for f in FIELDS},
        max_nudge_gap={f: worst("nudge_gap", f) for f in FIELDS},
        iterations_gap_above_nudge={
            f: sum(r["gap"][f] > r["nudge_gap"][f] for r in rows)
            for f in FIELDS},
        replay_s=time.perf_counter() - t0, workers=workers,
        device=rec["device"], smi=rec["smi"])
    print("[replay] " + json.dumps(summary))
    out.write_text(json.dumps(dict(summary=summary, iterations=rows),
                              indent=1))
    print(f"[replay] wrote {out}")
    return 0


def _short(row, side):
    m = row.get("margins", {}).get(side)
    if not m:
        return None
    return [round(v, 1) for v in m["margin_ulps"]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("card")
    c.add_argument("--lane", type=int, default=36)
    c.add_argument("--out", default=str(ROOT / "build" / "c2_card.pt"))
    r = sub.add_parser("replay")
    r.add_argument("file")
    r.add_argument("--out", default=None)
    r.add_argument("--workers", type=int, default=4)
    args = ap.parse_args()
    if args.cmd == "card":
        return card(args.lane, Path(args.out))
    path = Path(args.file)
    return replay(path, Path(args.out) if args.out
                  else path.with_suffix(".json"), args.workers)


if __name__ == "__main__":
    sys.exit(main())
