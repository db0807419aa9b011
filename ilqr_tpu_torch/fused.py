"""Fully-fused batch solver: the whole iLQR loop in kernel layout
(counterpart of ``ilqr_tpu/fused.py``).

All solver state stays lane-last ((T, n, B), (B,), …) from the initial
rollout to the end; the only relayouts are one transpose of the inputs and
one of the Solution. Per iteration the main path launches ONE kernel
(ops/kernel_iter.py); ``iter_kernel="split"`` (and ``"auto"`` for models
with m·n ≥ 32, such as the quadrotor) runs the same iteration as a sweep
kernel plus a line-search kernel; ``sweep_kernel="split"`` (m = 1 with
limits) replaces the sweep by the derivative kernel (once per iteration)
and the backward kernel (once per λ attempt). Inside the merged sweep the
derivatives are the models' closed forms (``deriv_mode="analytic"`` with
the Euler step), exact dual-number derivatives of the discrete step
(``deriv_mode="analytic"`` with RK4) or the reference's central stencils of
the discrete step (``deriv_mode="fd"``, Euler or RK4, eps ``cfg.fd_eps``);
the derivative kernel of the split sweep takes the dual numbers or the
stencils with either step, and the rollout and line-search kernels take
either integrator.

The JAX package's two ``lax.while_loop``s are host loops here:

- the λ-escalation retry loop (ref ilqr_core.cpp:136-150) checks once per
  attempt whether any live lane's backward pass failed — one host sync per
  iteration when none did;
- the outer loop checks ``any(~done & iteration < max_iter)`` once every
  ``cfg.fused_unroll`` iterations; lanes that finished, or ran past
  max_iter, are frozen by masking, so any unroll gives the same result.

The per-lane bookkeeping (λ schedule, termination) is plain tensor code.
Lanes never interact, so the TPU's padding to 1024-lane chunks is not
needed: per-lane results are the same for any batch size. Per-problem
params (``params_batched=True``) are packed once per solve as one row per
lane, which every op reads on its lane; the warm start
(:func:`solve_batch_fused_warm`) shares the cold solve's body and differs
only in its initial rollout and λ/dλ.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ilqr_tpu_torch.config import SolverConfig
from ilqr_tpu_torch.models.base import Model
from ilqr_tpu_torch.ops import qp
from ilqr_tpu_torch.ops.kernel_backward import (
    backward_ns,
    backward_sweep_packed,
)
from ilqr_tpu_torch.ops.kernel_derivs import (
    DERIVS_KERNEL_MODELS,
    derivs_packed,
)
from ilqr_tpu_torch.ops.kernel_iter import iteration_packed
from ilqr_tpu_torch.ops.kernel_rollout import (
    has_kernels,
    linesearch_packed,
    pack_params,
    pack_params_batched,
    rollout_packed,
    unpack_params,
)
from ilqr_tpu_torch.ops.kernel_sweep import sweep_packed
from ilqr_tpu_torch.solver import as_f32, resolve_device
from ilqr_tpu_torch.types import Solution, TerminationReason

F32 = torch.float32


class FusedState(NamedTuple):
    xs_body: torch.Tensor    # (T, n, B) — rows 0..T-1
    x_term: torch.Tensor     # (n, B)    — terminal state (row T)
    us: torch.Tensor         # (T, m, B)
    cost: torch.Tensor       # (B,)
    lam: torch.Tensor        # (B,)
    dlam: torch.Tensor       # (B,)
    k: torch.Tensor          # (T, m, B)
    K: torch.Tensor          # (T, m, n, B)
    iteration: torch.Tensor  # (B,) int32
    done: torch.Tensor       # (B,) bool
    reason: torch.Tensor     # (B,) int32
    gnorm: torch.Tensor      # (B,)
    dcost: torch.Tensor      # (B,)
    expected: torch.Tensor   # (B,)


def _host_any(flags: torch.Tensor) -> bool:
    """``flags.any()`` read on the host — the solver's only syncs."""
    _host_any.syncs += 1
    return bool(flags.any().item())


_host_any.syncs = 0


def _escalate(failed, lam, dlam, factor, cfg):
    """λ ← max(λ·dλ, λmin) with dλ ← max(dλ·f, f) on failed lanes
    (ref ilqr_core.cpp:136-150)."""
    dlam_n = torch.where(failed, torch.maximum(dlam * factor, factor), dlam)
    lam_n = torch.where(failed, torch.clamp(lam * dlam_n, min=cfg.lambda_min),
                        lam)
    return lam_n, dlam_n


def _merged_iteration(model, cfg, pp, x0, state, frozen, live, alphas,
                      factor):
    """STEPs 1-4 as ONE kernel per backward attempt (ops/kernel_iter.py).
    λ-escalation retries re-run the kernel with ``live`` restricted to the
    failed lanes still at λ ≤ λmax; passthrough lanes re-emit their state
    unchanged, so the retry loop is exact."""

    def run_iter(lam, live_f, xs_body, x_term, us, k_old, K_old):
        # cost_prev is per-lane invariant across retries (a retrying lane
        # never stepped), so state.cost is right for every attempt.
        return iteration_packed(
            model, cfg.integrator, cfg.clamp_forward, pp, x0, xs_body,
            x_term, us, k_old, K_old, lam, state.cost, live_f, alphas,
            mode=_kmode(cfg), use_limits=cfg.use_control_limits,
            z_min=cfg.z_min, tol_grad=cfg.tol_grad,
            lambda_grad_term=cfg.lambda_grad_term, eps=cfg.fd_eps)

    (xs, us, xf, k, K, lsc, _asel, accf, dc, ex, div,
     g) = run_iter(state.lam, live.to(F32), state.xs_body, state.x_term,
                   state.us, state.k, state.K)
    ok = frozen | (live & (div < 0.5))
    lam, dlam = _escalate(live & ~ok, state.lam, state.dlam, factor, cfg)

    retried = False
    retry = ~ok & (lam <= cfg.lambda_max)
    while _host_any(retry):
        retried = True
        (xs, us, xf, k, K, lsc_n, _asel, acc_n, dc_n, ex_n, div_n,
         g_n) = run_iter(lam, retry.to(F32), xs, xf, us, k, K)
        lsc = torch.where(retry, lsc_n, lsc)
        accf = torch.where(retry, acc_n, accf)
        dc = torch.where(retry, dc_n, dc)
        ex = torch.where(retry, ex_n, ex)
        g = torch.where(retry, g_n, g)
        new_ok = div_n < 0.5
        lam, dlam = _escalate(retry & ~new_ok, lam, dlam, factor, cfg)
        ok = ok | (retry & new_ok)
        retry = ~ok & (lam <= cfg.lambda_max)
    _iteration.retried += retried
    return lam, dlam, ok, g, xs, us, xf, k, K, lsc, accf, dc, ex


def _merged_sweep(model, cfg, pp, state):
    """The backward attempt of ``iter_kernel="split"``: the merged
    linearize + backward sweep kernel."""
    def run_backward(lam):
        return sweep_packed(model, cfg.integrator, pp, state.xs_body,
                            state.x_term, state.us, lam, mode=_kmode(cfg),
                            use_limits=cfg.use_control_limits,
                            eps=cfg.fd_eps)
    return run_backward


def _split_sweep(model, cfg, pp, state):
    """The backward attempt of ``sweep_kernel="split"``: the derivative
    kernel once per iteration (ref ilqr_core.cpp:115-120), then the
    backward kernel per λ attempt; gnorm from the packed k."""
    xs_full = torch.cat([state.xs_body, state.x_term[None]])
    fx, fu, cx, cu, cxx, cxu, cuu = derivs_packed(
        model, cfg.integrator, pp, xs_full, state.us, mode=_kmode(cfg),
        eps=cfg.fd_eps)
    p, _dt = unpack_params(pp)
    lo = p.u_min[0] - state.us[:, 0]
    hi = p.u_max[0] - state.us[:, 0]

    def run_backward(lam):
        k, K, dv, div = backward_sweep_packed(
            fx, fu[:, :, 0], cx[:-1], cu[:, 0], cxx[:-1], cxu[:, :, 0],
            cuu[:, 0, 0], lo, hi, lam, cx[-1], cxx[-1])
        k = k[:, None]
        gnorm = (k.abs() / (state.us.abs() + 1.0)).amax(dim=1).mean(dim=0)
        return k, K[:, None], dv, div, gnorm
    return run_backward


def _split_iteration(model, cfg, pp, x0, state, frozen, live, alphas,
                     factor):
    """The iteration as a backward attempt (re-run per λ attempt) and one
    line-search kernel."""
    make = _split_sweep if cfg.sweep_kernel == "split" else _merged_sweep
    run_backward = make(model, cfg, pp, state)

    k, K, dV, div, gnorm = run_backward(state.lam)
    ok = frozen | (live & (div < 0.5))
    lam, dlam = _escalate(live & ~ok, state.lam, state.dlam, factor, cfg)
    retried = False
    retry = ~ok & (lam <= cfg.lambda_max)
    while _host_any(retry):
        retried = True
        k_n, K_n, dV_n, div_n, g_n = run_backward(lam)
        new_ok = div_n < 0.5
        k = torch.where(retry, k_n, k)
        K = torch.where(retry, K_n, K)
        dV = torch.where(retry, dV_n, dV)
        gnorm = torch.where(retry, g_n, gnorm)
        lam, dlam = _escalate(retry & ~new_ok, lam, dlam, factor, cfg)
        ok = ok | (retry & new_ok)
        retry = ~ok & (lam <= cfg.lambda_max)
    _iteration.retried += retried

    grad_term = _grad_term(cfg, ok, gnorm, lam)
    gate = (ok & ~grad_term & live).to(F32)
    keep = (ok & live).to(F32)
    (xs, us, xf, k_new, K_new, lsc, _asel, accf, dc,
     ex) = linesearch_packed(
        model, cfg.integrator, cfg.clamp_forward, pp, x0, state.us,
        state.xs_body, state.x_term, K, k, state.K, state.k, alphas, dV,
        state.cost, gate, keep, cfg.z_min)
    return lam, dlam, ok, gnorm, xs, us, xf, k_new, K_new, lsc, accf, dc, ex


def _kmode(cfg):
    return "jvp" if cfg.deriv_mode == "analytic" else "fd"


def _grad_term(cfg, back_ok, gnorm, lam):
    """Gradient-norm termination (ref ilqr_core.cpp:153-159)."""
    return (back_ok & (gnorm < cfg.tol_grad)
            & (lam < cfg.lambda_grad_term))


def _use_iter_kernel(model: Model, cfg: SolverConfig) -> bool:
    """Whether the whole-iteration kernel runs (ilqr_tpu/fused.py:87-112).
    It embeds the merged sweep, so ``sweep_kernel="split"`` takes the split
    iteration and an explicit ``iter_kernel="merged"`` with it raises.
    ``"auto"`` takes the split iteration for large models (m·n ≥ 32, e.g.
    the quadrotor), as the JAX package does. The JAX package's VMEM fit
    check of the gain buffer has no counterpart: on the card the gains
    live in device memory."""
    if cfg.iter_kernel == "split":
        return False
    if cfg.sweep_kernel != "merged":
        if cfg.iter_kernel == "merged":
            raise ValueError(
                "iter_kernel='merged' requires sweep_kernel='merged' (the "
                "whole-iteration kernel embeds the merged linearize+backward "
                "sweep)")
        return False
    if cfg.iter_kernel == "merged":
        return True
    return model.m * model.n < 32


def _iteration(model: Model, cfg: SolverConfig, pp, x0, alphas, factor,
               state: FusedState) -> FusedState:
    _iteration.calls += 1
    # Lanes past their budget are frozen exactly like done lanes: the outer
    # loop runs in chunks of cfg.fused_unroll iterations (ref :285).
    frozen = state.done | (state.iteration >= cfg.max_iter)
    live = ~frozen
    # A lane makes backward attempts only while λ ≤ λmax, as in the
    # composable solver (ilqr_tpu/solver.py:151). The JAX fused solver
    # makes its first attempt unconditionally, which differs only for a
    # warm start that carries λ > λmax in: a fleet whose replans keep
    # ending LAMBDA_MAX multiplies λ by a growing dλ at each, and from
    # λ ≈ 1e37 the f32 sweep gives NaN gains without a divergence flag,
    # which the next warm rollout spreads. Such a lane ends LAMBDA_MAX
    # with its trajectory (ROADMAP.md §C3). The retries likewise re-run
    # only the lanes still at λ ≤ λmax, where the JAX fused solver re-runs
    # every failed lane while any lane retries.
    attempt = live & (state.lam <= cfg.lambda_max)
    run = (_merged_iteration if _use_iter_kernel(model, cfg)
           else _split_iteration)
    (lam, dlam, back_ok, gnorm, xs_body, us, x_term, k, K, ls_cost, acc_f,
     ls_dcost, ls_expected) = run(model, cfg, pp, x0, state, frozen,
                                  attempt, alphas, factor)
    gnorm = torch.where(attempt, gnorm, state.gnorm)
    grad_term = _grad_term(cfg, back_ok, gnorm, lam)
    accepted = back_ok & (acc_f > 0.5)
    take_step = accepted & ~grad_term & live
    return _finish_iteration(
        cfg, state, frozen, lam, dlam, gnorm, grad_term, accepted,
        take_step, xs_body, us, x_term, k, K, ls_cost, ls_dcost,
        ls_expected, factor)


_iteration.calls = 0
_iteration.retried = 0   # iterations whose backward attempt was re-run


def _finish_iteration(cfg, state, frozen, lam, dlam, gnorm, grad_term,
                      accepted, take_step, xs_body_new, us_new, xterm_new,
                      k_new, K_new, ls_cost, ls_dcost, ls_expected,
                      factor) -> FusedState:
    """Per-lane bookkeeping after the line search: cost/λ schedule,
    termination, and the lane-sized freeze selects (the kernels already
    froze xs/us via the take gate and k/K via keep)."""
    cost_new = torch.where(take_step, ls_cost, state.cost)

    # λ schedule (ref :242-282)
    dlam_acc = torch.minimum(dlam / factor, 1.0 / factor)
    lam_acc = lam * dlam_acc * (lam > cfg.lambda_min).to(F32)
    dlam_rej = torch.maximum(dlam * factor, factor)
    lam_rej = torch.clamp(lam * dlam_rej, min=cfg.lambda_min)

    sched = ~grad_term
    lam_new = torch.where(sched, torch.where(accepted, lam_acc, lam_rej), lam)
    dlam_new = torch.where(sched, torch.where(accepted, dlam_acc, dlam_rej),
                           dlam)

    # termination (refs :153-159, :257-262, :276-281)
    fun_term = take_step & (ls_dcost < cfg.tol_fun)
    lam_term = ~grad_term & ~accepted & (lam_new > cfg.lambda_max)
    done = grad_term | fun_term | lam_term
    R = TerminationReason
    reason = torch.full_like(state.reason, int(R.RUNNING))
    reason = torch.where(lam_term, int(R.LAMBDA_MAX), reason)
    reason = torch.where(fun_term, int(R.FUN_TOL), reason)
    reason = torch.where(grad_term, int(R.GRAD_TOL), reason)

    def lane_freeze(old, new):
        return torch.where(frozen, old, new)

    return FusedState(
        xs_body=xs_body_new, x_term=xterm_new, us=us_new,
        k=k_new, K=K_new,
        cost=lane_freeze(state.cost, cost_new),
        lam=lane_freeze(state.lam, lam_new),
        dlam=lane_freeze(state.dlam, dlam_new),
        iteration=lane_freeze(state.iteration, state.iteration + 1),
        done=lane_freeze(state.done, done),
        reason=lane_freeze(state.reason, reason),
        gnorm=lane_freeze(state.gnorm, gnorm),
        dcost=lane_freeze(state.dcost, ls_dcost),
        expected=lane_freeze(state.expected, ls_expected),
    )


# The widest control dimension of the in-kernel QPs
# (ilqr_tpu/ops/pallas_sweep.py MAX_FUSED_M).
MAX_FUSED_M = qp.MAX_FUSED_M


def _derivs_carried(model: Model, cfg: SolverConfig) -> bool:
    """Whether the sweep's derivatives are ported for (model, cfg), on the
    merged and the split sweep alike: ``deriv_mode="analytic"`` (the closed
    forms with the Euler step for a model with ``jac_soa``, the JAX
    kernels' use_analytic; dual numbers otherwise, their in-kernel JVPs)
    or ``deriv_mode="fd"`` (the reference's stencils), each with the Euler
    or the RK4 step."""
    return (cfg.integrator in ("euler", "rk4")
            and cfg.deriv_mode in ("analytic", "fd"))


def fused_applicable(model: Model, cfg: SolverConfig) -> bool:
    """True iff :func:`solve_batch_fused` accepts (model, cfg). Mirrors the
    guards of ilqr_tpu/fused.py:390-442 for what is ported: m ≤ 24 (the
    closed-form, enumeration and projected-Newton QPs, or the Newton step
    without limits), shared or per-problem params, and the sweep's
    derivatives of ``_derivs_carried``: analytic (closed forms with the
    Euler step, dual numbers with RK4) or the reference's stencils
    (``deriv_mode="fd"``, eps ``cfg.fd_eps``) with the Euler or RK4 step,
    in the whole-iteration and the split-iteration kernels;
    ``sweep_kernel="split"`` needs m = 1 and control limits (the backward
    kernel's closed-form QP). The rollout and line search take the
    configured integrator. On the card the kernels exist for the models of
    ``ops.kernel_rollout.FUSED_KERNEL_MODELS`` and the custom models
    registered with ``models.register`` (their own libraries); any other
    raises there."""
    split = cfg.sweep_kernel == "split"
    return (model.m <= MAX_FUSED_M and model.has_soa
            and not cfg.full_ddp and _derivs_carried(model, cfg)
            and not (split and (model.m >= 2
                                or not cfg.use_control_limits))
            and (not cfg.use_control_limits
                 or cfg.boxqp_mode in ("auto", "enum", "pn_fixed"))
            and cfg.sweep_kernel in ("merged", "split")
            and cfg.iter_kernel in ("auto", "merged", "split"))


def _check_config(model: Model, cfg: SolverConfig):
    if model.m > MAX_FUSED_M:
        raise ValueError(f"solve_batch_fused requires m <= {MAX_FUSED_M}")
    if cfg.full_ddp:
        raise ValueError(
            "solve_batch_fused does not support full_ddp (the kernel bodies "
            "are Gauss-Newton only)")
    if cfg.use_control_limits and cfg.boxqp_mode not in (
            "auto", "enum", "pn_fixed"):
        raise ValueError(
            "solve_batch_fused requires boxqp_mode='auto'/'enum'/'pn_fixed' "
            "(the in-kernel QP is chosen by m: exact enumeration for "
            "m <= 4, projected Newton above)")
    if cfg.iter_kernel not in ("auto", "merged", "split"):
        raise ValueError(f"unknown iter_kernel {cfg.iter_kernel!r}")
    if cfg.sweep_kernel not in ("merged", "split"):
        raise ValueError(f"unknown sweep_kernel {cfg.sweep_kernel!r}")
    if cfg.sweep_kernel == "split" and (model.m >= 2
                                        or not cfg.use_control_limits):
        raise ValueError(
            "sweep_kernel='split' needs m = 1 and control limits (the "
            "backward kernel's closed-form QP); m >= 2 and the "
            "unconstrained Newton step need sweep_kernel='merged'")
    _use_iter_kernel(model, cfg)
    if not model.has_soa:
        raise ValueError("solve_batch_fused requires SoA model functions")
    if not fused_applicable(model, cfg):
        raise NotImplementedError(
            f"solve_batch_fused does not carry model {model.name!r} with "
            f"deriv_mode={cfg.deriv_mode!r}, integrator={cfg.integrator!r}")


def _check_kernels(model: Model, cfg: SolverConfig, dev: torch.device):
    """On the card every op of the route must have its kernel. The split
    sweep's derivative kernel is instantiated for every model of the
    package (csrc/derivs_<model>.cu) and every registered custom model (its
    own library), the backward kernel for n = 2 and 4 (csrc/backward.cu)
    and each registered m = 1 custom model's n, so any other model raises
    there before anything runs (the registry is read at the call)."""
    if (dev.type == "cuda" and cfg.sweep_kernel == "split"
            and (not has_kernels(model, DERIVS_KERNEL_MODELS)
                 or model.n not in backward_ns())):
        raise NotImplementedError(
            f"sweep_kernel='split' on the card runs "
            f"{', '.join(DERIVS_KERNEL_MODELS)} and the registered custom "
            f"m = 1 models (backward kernel at n in {backward_ns()}); not "
            f"{model.name!r} (n = {model.n}), which sweep_kernel='merged' "
            "runs")


def solve_batch_fused(model: Model, params, cfg: SolverConfig, dt, x0, u0,
                      device=None, params_batched: bool = False) -> Solution:
    """Batched solve entirely in kernel layout (see module docstring).

    Args: x0 (B, n); u0 (T, m) shared or (B, T, m) — numpy arrays or
    tensors; params a params NamedTuple shared by every problem, or with
    ``params_batched=True`` one whose every leaf carries a leading batch
    axis B (per-problem goals, masses, limits: each kernel reads lane b's
    own row of the packed params; dt stays shared). ``device`` defaults to
    ``"cuda"`` and raises when no card is present; with ``device="cpu"``
    every op runs its plain PyTorch version. Returns a Solution with
    leading batch axis B, on ``device``.
    """
    _check_config(model, cfg)
    dev = resolve_device(device)
    _check_kernels(model, cfg, dev)
    x0 = as_f32(x0, dev)
    u0 = as_f32(u0, dev)
    B, n = x0.shape
    if u0.ndim == 2:
        u0 = u0.expand((B,) + tuple(u0.shape))
    _check_dims(model, n, u0.shape[2])
    if params_batched:
        pp = pack_params_batched(params, dt, dev)
        if pp.vec.shape[0] != B:
            raise ValueError(f"params_batched: params carry "
                             f"{pp.vec.shape[0]} problems, x0 {B}")
    else:
        pp = pack_params(params, dt, dev)
    return _solve(model, cfg, pp, x0.t().contiguous(),
                  u0.permute(1, 2, 0).contiguous())


def solve_batch_fused_warm(model: Model, params, cfg: SolverConfig, dt, x0,
                           prev: Solution, device=None) -> Solution:
    """Warm-started fused batch solve, the MPC re-plan of a whole fleet
    (counterpart of ``ilqr_tpu.fused.solve_batch_fused_warm``): re-rolls
    ``prev.us`` with the previous gains ``prev.K`` against ``prev.xs`` from
    the new x0 (ref generate_trajectory overload 2, ilqr_core.cpp:65-76)
    and carries λ/dλ per lane; k, K, the iteration count and the
    termination state start as in a cold solve. Shared params.

    Args: x0 (B, n); ``prev`` a Solution of B problems (this package's, or
    one whose fields are numpy arrays), xs (B, T+1, n), us (B, T, m),
    K (B, T, m, n), lam and dlam (B,). ``device`` as in
    :func:`solve_batch_fused`."""
    _check_config(model, cfg)
    dev = resolve_device(device)
    _check_kernels(model, cfg, dev)
    x0 = as_f32(x0, dev)
    B, n = x0.shape
    us = as_f32(prev.us, dev)
    T, m = us.shape[1], us.shape[2]
    _check_dims(model, n, m)
    xs, K = as_f32(prev.xs, dev), as_f32(prev.K, dev)
    lam, dlam = as_f32(prev.lam, dev), as_f32(prev.dlam, dev)
    for name, a, shape in (("us", us, (B, T, m)), ("xs", xs, (B, T + 1, n)),
                           ("K", K, (B, T, m, n)), ("lam", lam, (B,)),
                           ("dlam", dlam, (B,))):
        if tuple(a.shape) != shape:
            raise ValueError(f"prev.{name}: shape {tuple(a.shape)}, expected "
                             f"{shape}")
    return _solve(model, cfg, pack_params(params, dt, dev),
                  x0.t().contiguous(), us.permute(1, 2, 0).contiguous(),
                  warm=(xs[:, :T].permute(1, 2, 0).contiguous(),
                        K.permute(1, 2, 3, 0).contiguous(),
                        lam.contiguous(), dlam.contiguous()))


def _check_dims(model: Model, n: int, m: int):
    if n != model.n or m != model.m:
        raise ValueError(f"x0/u0 dims ({n}, {m}) do not match model "
                         f"{model.name!r} ({model.n}, {model.m})")


def _solve(model: Model, cfg: SolverConfig, pp, x0_p, us_p,
           warm=None) -> Solution:
    """The solve of :func:`solve_batch_fused` and
    :func:`solve_batch_fused_warm` from lane-last x0 (n, B) and controls
    (T, m, B). ``warm`` = (x̄ (T, n, B), K (T, m, n, B), λ (B,), dλ (B,)):
    the initial rollout closes the loop around x̄ with K, and λ/dλ start
    from the given ones; without it the rollout is open-loop (ref
    init_traj, ilqr_core.cpp:11-56) from λ/dλ's initial values."""
    dev = x0_p.device
    T, m, B = us_p.shape
    n = x0_p.shape[0]
    zeros = lambda *shape: torch.zeros(shape, dtype=F32, device=dev)
    if warm is None:
        xsr, K0 = zeros(T, n, B), zeros(T, m, n, B)
        lam = torch.full((B,), cfg.lambda_init, dtype=F32, device=dev)
        dlam = torch.full((B,), cfg.dlambda_init, dtype=F32, device=dev)
    else:
        xsr, K0, lam, dlam = warm
    xs_body, us_p, x_fin, cost = rollout_packed(
        model, cfg.integrator, cfg.clamp_forward, pp, x0_p, us_p, xsr, K0)

    state = FusedState(
        xs_body=xs_body, x_term=x_fin, us=us_p, cost=cost, lam=lam,
        dlam=dlam, k=zeros(T, m, B), K=zeros(T, m, n, B),
        iteration=torch.zeros((B,), dtype=torch.int32, device=dev),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        reason=torch.zeros((B,), dtype=torch.int32, device=dev),
        gnorm=zeros(B), dcost=zeros(B), expected=zeros(B))

    # Device constants made once: a host→device copy inside the loop would
    # synchronise. factor stays a tensor so that dλ/f is a true division.
    alphas = torch.tensor([float(a) for a in cfg.alphas], dtype=F32,
                          device=dev)
    factor = torch.tensor(cfg.lambda_factor, dtype=F32, device=dev)
    unroll = max(1, int(cfg.fused_unroll))
    while _host_any(~state.done & (state.iteration < cfg.max_iter)):
        for _ in range(unroll):
            state = _iteration(model, cfg, pp, x0_p, alphas, factor, state)

    reason = torch.where(state.done, state.reason,
                         int(TerminationReason.MAX_ITER))
    xs_full = torch.cat([state.xs_body, state.x_term[None]], dim=0)
    return Solution(
        xs=xs_full.permute(2, 0, 1),        # (B, T+1, n)
        us=state.us.permute(2, 0, 1),       # (B, T, m)
        k=state.k.permute(2, 0, 1),         # (B, T, m)
        K=state.K.permute(3, 0, 1, 2),      # (B, T, m, n)
        cost=state.cost,
        lam=state.lam,
        dlam=state.dlam,
        iterations=state.iteration,
        reason=reason,
        gnorm=state.gnorm,
    )
