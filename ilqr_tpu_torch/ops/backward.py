"""The backward Riccati/DDP recursion, batch-major (counterpart of
``ilqr_tpu/ops/backward.py``; ref src/ilqr_core.cpp:350-401).

Q-terms from the linearization and V_{t+1}; QuuF = Quu + λI; k_t from the
box QP warm-started with the next step's k (the first step with the
previous sweep's k[T-1], ``prev_k_last``); K_t = −Q_free⁻¹ Qux on the free
rows through the QP's subspace factor; dV += (kᵀQu, ½kᵀQuu k); V updated
and symmetrized. A lane whose QP fails latches ``diverged`` and the
caller escalates its λ.

The m = 1 control-limited case with the closed-form QP
(``boxqp_mode="auto"``) runs the backward op (ops/kernel_backward.py: its
CUDA kernel on the card, its plain version on the CPU) unless
``cfg.backward_kernel="xla"``; its inputs are laid out once per iteration
(:func:`backward_inputs`) and reused by every λ attempt. Every other case
runs :func:`_backward_scan`, the JAX package's scan step as a loop over T
with the batch written out, and its QPs (ops/boxqp.py), in plain PyTorch on
either device, as the JAX package runs them in XLA with no Pallas kernel:
the closed form at m = 1,
``enum`` (m ≤ 4), ``pn_fixed``, the iterative box QP (``"auto"`` at m ≥ 2,
``"iterative"``, ``"enum"`` above m = 4) and, without control limits, the
Cholesky step. Full DDP and the parallel-in-time ``assoc*`` modes raise
``NotImplementedError``.

Limits ``u_min``/``u_max`` are shared, (m,), or per lane, (B, m).
"""

from __future__ import annotations

import torch

from ilqr_tpu_torch.config import SolverConfig
from ilqr_tpu_torch.ops.boxqp import (
    _cho_solve_small,
    _chol_small,
    _use_unrolled,
    boxqp,
    boxqp_enum,
    boxqp_pn,
    cho_solve,
    cholesky,
    free_solve,
)
from ilqr_tpu_torch.ops.kernel_backward import (
    backward_sweep_lanes,
    pack_backward_inputs,
)
from ilqr_tpu_torch.ops.kernel_rollout import F32, clip, lane_last
from ilqr_tpu_torch.types import BackwardResult, Derivs


def check_supported(cfg: SolverConfig, m: int):
    """Raises for the backward-pass configurations not ported yet."""
    if cfg.backward_mode != "scan":
        raise NotImplementedError(
            f"backward_mode={cfg.backward_mode!r} (the parallel-in-time "
            "assoc scans) is not ported yet (ROADMAP.md §A6)")
    if cfg.full_ddp:
        raise NotImplementedError(
            "full_ddp is not ported yet (ROADMAP.md §A4)")
    if cfg.boxqp_mode not in ("auto", "iterative", "enum", "pn_fixed"):
        raise ValueError(f"unknown boxqp_mode {cfg.boxqp_mode!r}")


def _uses_kernel(cfg: SolverConfig, m: int) -> bool:
    return (m == 1 and cfg.use_control_limits and cfg.boxqp_mode == "auto"
            and cfg.backward_kernel != "xla")


def _closed_form(quuF, qu, qux, lo, hi):
    """The 1-D box QP min ½qx² + gx on [lo, hi] as clamp(−g/q), K zero on
    a clamped or non-positive q (ops/backward.py:115-138)."""
    q11, g1 = quuF[:, 0, 0], qu[:, 0]
    lo, hi = lo[:, 0], hi[:, 0]
    bad = q11 <= 0
    q_safe = torch.where(bad, torch.ones_like(q11), q11)
    x1 = clip(-g1 / q_safe, lo, hi)
    gk = q11 * x1 + g1
    clamped = ((x1 <= lo) & (gk > 0)) | ((x1 >= hi) & (gk < 0))
    k = torch.where(bad, torch.zeros_like(x1), x1)[:, None]
    K = torch.where((clamped | bad)[:, None, None], torch.zeros_like(qux),
                    -qux / q_safe[:, None, None])
    return k, K, bad


def _unconstrained(quuF, qu, qux):
    """The Newton step −QuuF⁻¹ [Qu Qux] by Cholesky (ops/backward.py:
    178-199): unrolled for f32 m ≤ 4, else LAPACK's; a failed factor
    (NaN) marks the lane diverged and its gains zero."""
    m = qu.shape[-1]
    rhs = torch.cat([qu[:, :, None], qux], dim=-1)          # (B, m, 1+n)
    if _use_unrolled(qu.dtype, m):
        chol = _chol_small(quuF)
        sol = _cho_solve_small(chol[:, None], rhs.mT).mT
    else:
        chol = cholesky(quuF)
        sol = cho_solve(chol[:, None], rhs.mT).mT
    bad = torch.isnan(chol).any(dim=(-2, -1))
    k, K = -sol[:, :, 0], -sol[:, :, 1:]
    k = torch.where(bad[:, None], torch.zeros_like(k), k)
    K = torch.where(bad[:, None, None], torch.zeros_like(K), K)
    return k, K, bad


def _qp_step(cfg: SolverConfig, quuF, qu, qux, lo, hi, k_next):
    """k (B, m), K (B, m, n) and the lanes whose QP failed, by the branch
    of the JAX scan step that ``cfg`` and m select."""
    m = qu.shape[-1]
    mode = cfg.boxqp_mode
    if not cfg.use_control_limits:
        return _unconstrained(quuF, qu, qux)
    if m == 1 and mode == "auto":
        return _closed_form(quuF, qu, qux, lo, hi)
    if m <= 4 and mode == "enum":
        res = boxqp_enum(quuF, qu, lo, hi)
    elif mode == "pn_fixed":
        res = boxqp_pn(quuF, qu, lo, hi)
    else:
        res = boxqp(quuF, qu, k_next, lo, hi, cfg.boxqp)
    # feedback gains on the free rows through the padded subspace factor
    K = -free_solve(res.chol_free[:, None], qux.mT, res.free[:, None]).mT
    return res.x, K, res.status < 1


def _backward_scan(d: Derivs, us, lam, u_min, u_max, cfg: SolverConfig,
                   prev_k_last):
    """The JAX package's scan step over a batch: matrix products per lane,
    the QP of ``cfg``, the symmetrized Vxx update."""
    B, T, m = us.shape
    vx, vxx = d.cx[:, -1], d.cxx[:, -1]
    dv = torch.zeros((B, 2), dtype=F32, device=us.device)
    diverged = torch.zeros((B,), dtype=torch.bool, device=us.device)
    lam_eye = lam[:, None, None] * torch.eye(m, dtype=F32, device=us.device)
    k_next = prev_k_last
    ks, Ks = [None] * T, [None] * T
    mv = lambda a, v: (a @ v[..., None])[..., 0]
    for t in reversed(range(T)):
        fx, fu = d.fx[:, t], d.fu[:, t]
        fuT = fu.mT
        qx = d.cx[:, t] + mv(fx.mT, vx)
        qu = d.cu[:, t] + mv(fuT, vx)
        fuT_vxx = fuT @ vxx
        qxx = d.cxx[:, t] + fx.mT @ (vxx @ fx)
        qux = d.cxu[:, t].mT + fuT_vxx @ fx            # (B, m, n)
        quu = d.cuu[:, t] + fuT_vxx @ fu               # (B, m, m)
        quuF = quu + lam_eye
        k, K, bad = _qp_step(cfg, quuF, qu, qux, u_min - us[:, t],
                             u_max - us[:, t], k_next)
        dv = dv + torch.stack([(k * qu).sum(-1),
                               ((0.5 * k) * mv(quu, k)).sum(-1)], dim=-1)
        kT_quu = K.mT @ quu
        vx = qx + mv(kT_quu, k) + mv(K.mT, qu) + mv(qux.mT, k)
        vxx = qxx + kT_quu @ K + K.mT @ qux + qux.mT @ K
        vxx = 0.5 * (vxx + vxx.mT)
        diverged = diverged | bad
        ks[t], Ks[t], k_next = k, K, k
    return BackwardResult(k=torch.stack(ks, 1), K=torch.stack(Ks, 1), dV=dv,
                          diverged=diverged)


def backward_inputs(derivs: Derivs, us, u_min, u_max, cfg: SolverConfig):
    """The backward kernel's inputs for one linearization, lane last (ops/
    kernel_backward.py pack_backward_inputs), where the kernel runs (m = 1,
    limits, the closed-form QP), else None: the derivatives and the limit
    offsets u_min − us, u_max − us, which no λ attempt changes. us
    (B, T, 1); u_min/u_max (1,) shared or (B, 1) per lane."""
    if not _uses_kernel(cfg, us.shape[-1]):
        return None
    us_t = lane_last(us[..., 0])                           # (T, B)
    lane = lambda a: a[:, 0] if a.ndim == 2 else a          # (B,) or (1,)
    d = derivs
    return pack_backward_inputs(d.fx, d.fu, d.cx, d.cu, d.cxx, d.cxu, d.cuu,
                                lane(u_min) - us_t, lane(u_max) - us_t)


def backward_pass(derivs: Derivs, us, lam, u_min, u_max, cfg: SolverConfig,
                  prev_k_last=None, packed=None) -> BackwardResult:
    """One backward sweep per problem: us (B, T, m), lam (B,), u_min/u_max
    (m,) shared or (B, m) per lane, prev_k_last (B, m) the previous
    sweep's k[T-1] that warm-starts the first iterative QP (ref
    ilqr_core.cpp:369; zeros when None). ``packed``: the kernel's inputs
    from :func:`backward_inputs` on the same arguments, laid out once for
    all λ attempts (laid out here when None)."""
    B, T, m = us.shape
    check_supported(cfg, m)
    if prev_k_last is None:
        prev_k_last = torch.zeros((B, m), dtype=F32, device=us.device)
    if not _uses_kernel(cfg, m):
        return _backward_scan(derivs, us, lam, u_min, u_max, cfg,
                              prev_k_last)
    if packed is None:
        packed = backward_inputs(derivs, us, u_min, u_max, cfg)
    k, K, dV, diverged = backward_sweep_lanes(packed, lam)
    return BackwardResult(k=k, K=K, dV=dV, diverged=diverged)


def gradient_norm(k, us):
    """mean over t of max_j |k_tj| / (|u_tj| + 1) per problem (ref
    ilqr_core.cpp:405-412): k, us (…, T, m) → (…)."""
    return (k.abs() / (us.abs() + 1.0)).amax(dim=-1).mean(dim=-1)
