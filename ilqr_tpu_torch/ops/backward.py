"""The backward Riccati/DDP recursion, batch-major (counterpart of
``ilqr_tpu/ops/backward.py``; ref src/ilqr_core.cpp:350-401).

Ported: the m = 1 control-limited case with the closed-form QP
(``boxqp_mode="auto"``). ``cfg.backward_kernel`` picks the route:
``"auto"``/``"pallas"`` run the backward op (ops/kernel_backward.py — its
CUDA kernel on the card, its plain version on the CPU); ``"xla"`` runs the
JAX package's scan step, with its ``0.5·(Vxx + Vxxᵀ)`` symmetrization, as a
loop over T with the batch written out. The iterative, ``enum`` and
``pn_fixed`` QPs, the unconstrained Newton step, full DDP and the
parallel-in-time ``assoc*`` modes raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ilqr_tpu_torch.config import SolverConfig
from ilqr_tpu_torch.ops.kernel_backward import backward_sweep_batched
from ilqr_tpu_torch.ops.kernel_rollout import F32, clip
from ilqr_tpu_torch.types import BackwardResult, Derivs


def check_supported(cfg: SolverConfig, m: int):
    """Raises for the backward-pass configurations not ported yet."""
    if cfg.backward_mode != "scan":
        raise NotImplementedError(
            f"backward_mode={cfg.backward_mode!r} (the parallel-in-time "
            "assoc scans) is not ported yet")
    if cfg.full_ddp:
        raise NotImplementedError("full_ddp is not ported yet")
    if not cfg.use_control_limits:
        raise NotImplementedError(
            "use_control_limits=False (the unconstrained Cholesky step) is "
            "not ported yet")
    if m != 1 or cfg.boxqp_mode != "auto":
        raise NotImplementedError(
            f"the backward pass is ported for m = 1 with the closed-form QP "
            f"(boxqp_mode='auto') only; got m = {m}, "
            f"boxqp_mode={cfg.boxqp_mode!r}")


def _backward_scan(d: Derivs, us, lam, u_min, u_max):
    """The JAX package's scan step for m = 1 with the closed-form QP, over
    a batch: matrix products per lane and the symmetrized Vxx update."""
    B, T, m = us.shape
    vx, vxx = d.cx[:, -1], d.cxx[:, -1]
    dv = torch.zeros((B, 2), dtype=F32, device=us.device)
    diverged = torch.zeros((B,), dtype=torch.bool, device=us.device)
    ks, Ks = [None] * T, [None] * T
    mv = lambda a, v: (a @ v[..., None])[..., 0]
    for t in reversed(range(T)):
        fx, fu = d.fx[:, t], d.fu[:, t]
        fuT = fu.mT
        qx = d.cx[:, t] + mv(fx.mT, vx)
        qu = d.cu[:, t] + mv(fuT, vx)
        fuT_vxx = fuT @ vxx
        qxx = d.cxx[:, t] + fx.mT @ (vxx @ fx)
        qux = d.cxu[:, t].mT + fuT_vxx @ fx            # (B, 1, n)
        quu = d.cuu[:, t] + fuT_vxx @ fu               # (B, 1, 1)
        quuF = quu + lam[:, None, None]
        lo = (u_min - us[:, t])[:, 0]
        hi = (u_max - us[:, t])[:, 0]
        q11, g1 = quuF[:, 0, 0], qu[:, 0]
        bad = q11 <= 0
        q_safe = torch.where(bad, torch.ones_like(q11), q11)
        x1 = clip(-g1 / q_safe, lo, hi)
        gk = q11 * x1 + g1
        clamped = ((x1 <= lo) & (gk > 0)) | ((x1 >= hi) & (gk < 0))
        k = torch.where(bad, torch.zeros_like(x1), x1)[:, None]      # (B, 1)
        K = torch.where((clamped | bad)[:, None, None],
                        torch.zeros_like(qux), -qux / q_safe[:, None, None])
        dv = dv + torch.stack([(k * qu).sum(-1),
                               ((0.5 * k) * mv(quu, k)).sum(-1)], dim=-1)
        kT_quu = K.mT @ quu
        vx = qx + mv(kT_quu, k) + mv(K.mT, qu) + mv(qux.mT, k)
        vxx = qxx + kT_quu @ K + K.mT @ qux + qux.mT @ K
        vxx = 0.5 * (vxx + vxx.mT)
        diverged = diverged | bad
        ks[t], Ks[t] = k, K
    return BackwardResult(k=torch.stack(ks, 1), K=torch.stack(Ks, 1), dV=dv,
                          diverged=diverged)


def backward_pass(derivs: Derivs, us, lam, u_min, u_max,
                  cfg: SolverConfig) -> BackwardResult:
    """One backward sweep per problem: us (B, T, m), lam (B,), u_min/u_max
    (m,) shared limits."""
    check_supported(cfg, us.shape[-1])
    if cfg.backward_kernel == "xla":
        return _backward_scan(derivs, us, lam, u_min, u_max)
    d = derivs
    k, K, dV, diverged = backward_sweep_batched(
        d.fx, d.fu, d.cx, d.cu, d.cxx, d.cxu, d.cuu, u_min - us, u_max - us,
        lam)
    return BackwardResult(k=k, K=K, dV=dV, diverged=diverged)


def gradient_norm(k, us):
    """mean over t of max_j |k_tj| / (|u_tj| + 1) per problem (ref
    ilqr_core.cpp:405-412): k, us (…, T, m) → (…)."""
    return (k.abs() / (us.abs() + 1.0)).amax(dim=-1).mean(dim=-1)
