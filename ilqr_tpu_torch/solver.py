"""The iLQR outer loop: derivatives → backward pass → line search → accept
(counterpart of ``ilqr_tpu/solver.py``; ref src/ilqr_core.cpp:79-302).

The JAX package writes one iteration as a pure function and vmaps the whole
solve; here the batch is a leading axis B of every state field and the
loops run on the host:

- the λ-escalation retry (ref :136-150) re-runs the backward pass for the
  live lanes whose last attempt diverged, with one host sync per attempt;
  every attempt warm-starts its first QP from the previous sweep's
  k[T-1];
- the outer loop runs while any lane is neither done nor at max_iter, with
  one host sync per iteration; lanes that are done or at max_iter are
  frozen (the vmapped ``while_loop`` and ``_masked_iteration``);
- the iterative box QP (ops/boxqp.py) loops on the host too, one sync per
  QP iteration (all syncs are counted in ``ops.boxqp.host_any.syncs``).

Every stage runs on the device of the problem data: on the card its CUDA
kernels (ops/kernel_*.py; the backward pass's QPs at m ≥ 2 in plain
PyTorch, as the JAX package runs them in XLA), on the CPU their plain
versions, unless ``cfg.{deriv,backward,rollout}_kernel="xla"`` asks for
the JAX package's non-kernel counterparts. The derivatives are recomputed
every iteration: the vmapped ``lax.cond`` on the trajectory-changed flag
computes both branches, and an unchanged trajectory linearizes to the
same values, so a frozen lane's linearization is the one JAX carries.

Semantics kept from the reference, each with its site: gradient-norm
termination before the forward pass with λ < 1e-5 (:153-159); the 11-α line
search (:184-226); accept: dλ = min(dλ/1.6, 1/1.6), λ ← λ·dλ·(λ > λmin), so
λ becomes exactly 0 below λmin (:248-250); reject: dλ = max(dλ·1.6, 1.6),
λ ← max(λ·dλ, λmin), stop above λmax (:266-281); dcost < tolFun after an
accepted step (:257-262); the iteration cap (:285).
"""

from __future__ import annotations

import numpy as np
import torch

from ilqr_tpu_torch.config import SolverConfig
from ilqr_tpu_torch.models.base import Model
from ilqr_tpu_torch.ops.backward import (
    backward_inputs,
    backward_pass,
    gradient_norm,
)
from ilqr_tpu_torch.ops.backward import check_supported as _check_backward
from ilqr_tpu_torch.ops.boxqp import host_any as _host_any
from ilqr_tpu_torch.ops.derivatives import compute_derivs, stage_route
from ilqr_tpu_torch.ops.kernel_rollout import (
    F32,
    PackedParams,
    is_batched,
    pack_params,
    scheme,
    unpack_params,
)
from ilqr_tpu_torch.ops.rollout import line_search, open_loop_rollout, rollout
from ilqr_tpu_torch.types import Solution, SolverState, TerminationReason

KERNEL_ROUTES = ("auto", "pallas", "xla")


def resolve_device(device) -> torch.device:
    """``device`` as a torch device: the card when None, which raises
    without one; ``"cpu"`` runs the plain PyTorch versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ilqr_tpu_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' for the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_f32(a, dev) -> torch.Tensor:
    """A numpy array or tensor as an f32 tensor on ``dev``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a))
    return a.to(device=dev, dtype=F32)


def check_supported(model: Model, cfg: SolverConfig,
                    params_batched: bool = False):
    """Raises for what the composable path does not carry yet; it never
    runs plain ops in place of a kernel it lacks. A model without SoA
    functions takes the "xla" derivative and rollout routes on "auto" (as
    the JAX package's ``_use_fused*`` do); "pallas" raises for it."""
    if cfg.deriv_mode not in ("analytic", "fd"):
        raise ValueError(f"unknown deriv_mode {cfg.deriv_mode!r}")
    for field in ("deriv_kernel", "backward_kernel", "rollout_kernel"):
        if getattr(cfg, field) not in KERNEL_ROUTES:
            raise ValueError(f"unknown {field} {getattr(cfg, field)!r}; "
                             f"have {KERNEL_ROUTES}")
    routes = [stage_route(model, getattr(cfg, field), field)
              for field in ("deriv_kernel", "rollout_kernel")]
    scheme(cfg.integrator)
    if params_batched and "xla" in routes:
        raise NotImplementedError(
            "params_batched=True runs the kernel routes; the 'xla' "
            "derivative and rollout routes (and a model without SoA "
            "functions) take shared params")
    _check_backward(cfg, model.m)


def limits(pp: PackedParams):
    """The control box (u_min, u_max): (m,) shared, or (B, m) per lane."""
    p, _dt = unpack_params(pp)
    if is_batched(pp):
        return p.u_min.t(), p.u_max.t()
    return p.u_min, p.u_max


def init_state(model: Model, pp: PackedParams, cfg: SolverConfig, x0, u0,
               lam=None, dlam=None, warm_xs=None,
               warm_K=None) -> SolverState:
    """Initial rollout and state (ref init_traj, ilqr_core.cpp:11-56):
    x0 (B, n), u0 (B, T, m). Cold: the open-loop rollout of u0. Warm
    (MPC): ``warm_xs`` (B, T+1, n) and ``warm_K`` (B, T, m, n) of a
    previous solution re-roll u0 with the old gains around the old
    trajectory (ref ilqr_core.cpp:65-76, 316), and ``lam``/``dlam`` (B,)
    carry its λ and dλ."""
    B, T, m = u0.shape
    n = x0.shape[-1]
    dev = x0.device
    if warm_K is None:
        xs, us, cost = open_loop_rollout(model, pp, cfg, x0, u0)
    else:
        xs, us, cost = rollout(model, pp, cfg, x0, u0, warm_xs, warm_K)
    full = lambda v: torch.full((B,), v, dtype=F32, device=dev)
    carried = lambda v, default: (full(default) if v is None
                                  else as_f32(v, dev).expand(B).clone())
    false = torch.zeros((B,), dtype=torch.bool, device=dev)
    return SolverState(
        xs=xs, us=us, cost=cost, lam=carried(lam, cfg.lambda_init),
        dlam=carried(dlam, cfg.dlambda_init),
        k=torch.zeros((B, T, m), dtype=F32, device=dev),
        K=torch.zeros((B, T, m, n), dtype=F32, device=dev),
        iteration=torch.zeros((B,), dtype=torch.int32, device=dev),
        done=false, reason=torch.zeros((B,), dtype=torch.int32, device=dev),
        gnorm=full(0.0), dcost=full(0.0), expected=full(0.0),
        step_accepted=false)


def ilqr_iteration(model: Model, pp: PackedParams, cfg: SolverConfig,
                   state: SolverState, live) -> SolverState:
    """One outer iteration (STEPs 1-4 of ref generate_trajectory) for every
    lane; ``live`` (B,) bool marks the lanes whose result is kept, and only
    they take part in the λ retries."""
    ilqr_iteration.calls += 1
    B = state.cost.shape[0]
    dev = state.cost.device
    u_min, u_max = limits(pp)
    factor = torch.tensor(cfg.lambda_factor, dtype=F32, device=dev)

    # ---- STEP 1: linearize (ref :115-120)
    derivs = compute_derivs(model, pp, cfg, state.xs, state.us)

    # ---- STEP 2: backward pass with λ escalation (ref :136-150); the
    # kernel's inputs laid out once for every attempt
    packed = backward_inputs(derivs, state.us, u_min, u_max, cfg)
    lam, dlam = state.lam, state.dlam
    k, K = state.k, state.K
    dV = torch.zeros((B, 2), dtype=F32, device=dev)
    ok = torch.zeros((B,), dtype=torch.bool, device=dev)
    attempt = live & (lam <= cfg.lambda_max)
    attempts = 0
    while True:
        attempts += 1
        br = backward_pass(derivs, state.us, lam, u_min, u_max, cfg,
                           prev_k_last=state.k[:, -1], packed=packed)
        k = torch.where(attempt[:, None, None], br.k, k)
        K = torch.where(attempt[:, None, None, None], br.K, K)
        dV = torch.where(attempt[:, None], br.dV, dV)
        failed = attempt & br.diverged
        dlam = torch.where(failed, torch.maximum(dlam * factor, factor), dlam)
        lam = torch.where(failed, torch.clamp(lam * dlam, min=cfg.lambda_min),
                          lam)
        ok = ok | (attempt & ~br.diverged)
        attempt = live & ~ok & (lam <= cfg.lambda_max)
        if not _host_any(attempt):
            break
    ilqr_iteration.retried += attempts > 1

    # ---- gradient-norm termination (ref :153-159), before the forward pass
    gnorm = gradient_norm(k, state.us)
    grad_term = ok & (gnorm < cfg.tol_grad) & (lam < cfg.lambda_grad_term)

    # ---- STEP 3: line search (ref :184-226)
    ls = line_search(model, pp, cfg, state.xs[:, 0], state.xs, state.us, k,
                     K, dV, state.cost)
    accepted = ok & ls.accepted
    take_step = accepted & ~grad_term

    # ---- STEP 4: accept/reject and the λ schedule (ref :242-282)
    dlam_acc = torch.minimum(dlam / factor, 1.0 / factor)
    lam_acc = lam * dlam_acc * (lam > cfg.lambda_min).to(F32)
    dlam_rej = torch.maximum(dlam * factor, factor)
    lam_rej = torch.clamp(lam * dlam_rej, min=cfg.lambda_min)
    sched = ~grad_term
    lam_new = torch.where(sched, torch.where(accepted, lam_acc, lam_rej), lam)
    dlam_new = torch.where(sched, torch.where(accepted, dlam_acc, dlam_rej),
                           dlam)

    fun_term = take_step & (ls.dcost < cfg.tol_fun)
    lam_term = ~grad_term & ~accepted & (lam_new > cfg.lambda_max)
    R = TerminationReason
    reason = torch.full_like(state.reason, int(R.RUNNING))
    reason = torch.where(lam_term, int(R.LAMBDA_MAX), reason)
    reason = torch.where(fun_term, int(R.FUN_TOL), reason)
    reason = torch.where(grad_term, int(R.GRAD_TOL), reason)

    step3 = take_step[:, None, None]
    return SolverState(
        xs=torch.where(step3, ls.xs, state.xs),
        us=torch.where(step3, ls.us, state.us),
        cost=torch.where(take_step, ls.cost, state.cost),
        lam=lam_new, dlam=dlam_new,
        # keep NaN out of the carried gains if no backward attempt succeeded
        k=torch.where(ok[:, None, None], k, state.k),
        K=torch.where(ok[:, None, None, None], K, state.K),
        iteration=state.iteration + 1,
        done=grad_term | fun_term | lam_term, reason=reason, gnorm=gnorm,
        dcost=ls.dcost, expected=ls.expected, step_accepted=take_step)


ilqr_iteration.calls = 0
ilqr_iteration.retried = 0   # iterations whose backward pass was re-run


def _masked_iteration(model, pp, cfg, state: SolverState) -> SolverState:
    """One iteration with the lanes that are done or at max_iter frozen."""
    frozen = state.done | (state.iteration >= cfg.max_iter)
    new = ilqr_iteration(model, pp, cfg, state, ~frozen)
    return SolverState(*(
        torch.where(frozen.reshape((-1,) + (1,) * (old.ndim - 1)), old, nw)
        for old, nw in zip(state, new)))


def solve_lanes(model: Model, pp: PackedParams, cfg: SolverConfig, x0,
                u0, **warm) -> Solution:
    """The batch solve on prepared tensors: x0 (B, n), u0 (B, T, m) f32 on
    the device of ``pp``; ``warm`` as :func:`init_state` takes it."""
    state = init_state(model, pp, cfg, x0, u0, **warm)
    while _host_any(~state.done & (state.iteration < cfg.max_iter)):
        state = _masked_iteration(model, pp, cfg, state)
    return _solution(state)


def _solution(state: SolverState) -> Solution:
    return Solution(
        xs=state.xs, us=state.us, k=state.k, K=state.K, cost=state.cost,
        lam=state.lam, dlam=state.dlam, iterations=state.iteration,
        reason=torch.where(state.done, state.reason,
                           int(TerminationReason.MAX_ITER)),
        gnorm=state.gnorm)


def solve(model: Model, params, cfg: SolverConfig, dt, x0, u0,
          device=None) -> Solution:
    """Solves one problem (ref generate_trajectory, ilqr_core.cpp:59-62):
    x0 (n,), u0 (T, m). It runs as one lane through the same kernels as
    :func:`ilqr_tpu_torch.batch.solve_batch`. ``device`` defaults to the
    card and raises without one; ``device="cpu"`` runs the plain versions.
    Returns a Solution without a batch axis."""
    check_supported(model, cfg)
    dev = resolve_device(device)
    sol = solve_lanes(model, pack_params(params, dt, dev), cfg,
                      as_f32(x0, dev)[None], as_f32(u0, dev)[None])
    return Solution(*(a[0] for a in sol))


def solve_warm(model: Model, params, cfg: SolverConfig, dt, x0, prev: Solution,
               device=None) -> Solution:
    """MPC warm start (ref generate_trajectory overload 2,
    ilqr_core.cpp:65-76) of one problem: re-rolls prev.us with prev.K
    around prev.xs from the new x0 (n,), and carries prev.lam/prev.dlam
    (the reference's statics, ilqr.h:17-18, made explicit). ``prev`` is a
    Solution without a batch axis (tensors or numpy arrays); ``device`` as
    in :func:`solve`."""
    check_supported(model, cfg)
    dev = resolve_device(device)
    one = Solution(*(as_f32(a, dev)[None] for a in prev))
    sol = solve_lanes(model, pack_params(params, dt, dev), cfg,
                      as_f32(x0, dev)[None], one.us, lam=one.lam,
                      dlam=one.dlam, warm_xs=one.xs, warm_K=one.K)
    return Solution(*(a[0] for a in sol))


REASON_MESSAGES = {
    TerminationReason.GRAD_TOL: "SUCCESS: gradient norm < tolGrad",
    TerminationReason.FUN_TOL: "SUCCESS: cost change < tolFun",
    TerminationReason.LAMBDA_MAX: "EXIT: lambda > lambdaMax",
    TerminationReason.MAX_ITER: "EXIT: Maximum iterations reached.",
}


def solve_verbose(model: Model, params, cfg: SolverConfig, dt, x0, u0,
                  device=None) -> Solution:
    """Host-driven solve of one problem printing the reference's
    per-iteration table (ref SHOWPROGRESS output, ilqr_core.cpp:237-246)
    in the JAX package's format, then its closing message. Used by the
    CLI, not the hot path; ``device`` as in :func:`solve`."""
    check_supported(model, cfg)
    dev = resolve_device(device)
    pp = pack_params(params, dt, dev)
    state = init_state(model, pp, cfg, as_f32(x0, dev)[None],
                       as_f32(u0, dev)[None])
    live = torch.ones((1,), dtype=torch.bool, device=dev)
    print(f"Initial cost: {float(state.cost[0]):.6g}")
    print("iteration\tcost\t\treduction\texpect\t\tgrad\t\tlog10(lambda)")
    it = 0
    while not bool(state.done[0]) and it < cfg.max_iter:
        state = ilqr_iteration(model, pp, cfg, state, live)
        it = int(state.iteration[0])
        lam = float(state.lam[0])
        loglam = np.log10(lam) if lam > 0 else -np.inf
        label = (f"{float(state.cost[0]):<12.6g}"
                 if bool(state.step_accepted[0]) else "NO STEP     ")
        print(f"{it - 1:<12d}\t{label}\t{float(state.dcost[0]):<12.3g}\t"
              f"{float(state.expected[0]):<12.3g}\t"
              f"{float(state.gnorm[0]):<12.3g}\t{loglam:<12.1f}")
    sol = Solution(*(a[0] for a in _solution(state)))
    reason = TerminationReason(int(sol.reason))
    print(f"\n{REASON_MESSAGES.get(reason, str(reason))}\n")
    return sol
