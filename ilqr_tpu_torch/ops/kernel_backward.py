"""The m = 1 backward recursion from precomputed derivatives (counterpart of
``ilqr_tpu/ops/pallas_backward.py``).

Per lane, in reverse time: Q-terms, QuuF = Quu + λ, the closed-form box QP
clamp(−Qu/QuuF) on [lo, hi], K zeroed on a clamped control or a divergent
step, dV, the V update and a latched divergence flag (ref
src/ilqr_core.cpp:350-401). The plain version, :func:`backward_plain`,
follows the JAX kernel's arithmetic term by term (pallas_backward.py:72-153):
the dense fx, every n×n entry of Qxx and Vxx on its own (so Vxx is not
exactly symmetric), −Qu/q and −Qux_j/q as divisions, dV[1] = 0.5·k·Quu·k.
It is not the merged sweep's step (ops/kernel_sweep.py).

Layout (lane last, m = 1 squeezed): fx (T, n, n, B), fu/cx/cxu (T, n, B),
cu/cuu/lo/hi (T, B), lam (B,), cxT (n, B), cxxT (n, n, B). Dispatch as in
ops/kernel_rollout.py.
"""

from __future__ import annotations

import torch

from ilqr_tpu_torch import models
from ilqr_tpu_torch.ops import _build
from ilqr_tpu_torch.ops.kernel_rollout import (
    F32,
    batch_first,
    clip,
    lane_last,
    on_cuda,
)


def backward_plain(fx, fu, cx, cu, cxx, cxu, cuu, lo, hi, lam, cxT, cxxT):
    """Plain version of :func:`backward_sweep_packed`."""
    T, n, B = fu.shape
    dev = fu.device
    vx = [cxT[i] for i in range(n)]
    vxx = [[cxxT[i, j] for j in range(n)] for i in range(n)]
    zero = torch.zeros((B,), dtype=F32, device=dev)
    dv0, dv1, div = zero, zero, zero
    k_out = torch.empty((T, B), dtype=F32, device=dev)
    K_out = torch.empty((T, n, B), dtype=F32, device=dev)
    for t in reversed(range(T)):
        fuv = [fu[t, i] for i in range(n)]
        f = [[fx[t, i, j] for j in range(n)] for i in range(n)]
        fvv = []
        for j in range(n):
            acc = fuv[0] * vxx[0][j]
            for i in range(1, n):
                acc = acc + fuv[i] * vxx[i][j]
            fvv.append(acc)
        qu = cu[t]
        for i in range(n):
            qu = qu + fuv[i] * vx[i]
        quu = cuu[t]
        for j in range(n):
            quu = quu + fvv[j] * fuv[j]
        quuF = quu + lam
        qux = []
        for j in range(n):
            acc = cxu[t, j]
            for i in range(n):
                acc = acc + fvv[i] * f[i][j]
            qux.append(acc)
        qx = []
        for j in range(n):
            acc = cx[t, j]
            for i in range(n):
                acc = acc + f[i][j] * vx[i]
            qx.append(acc)
        w = [[None] * n for _ in range(n)]
        for kk in range(n):
            for j in range(n):
                acc = vxx[kk][0] * f[0][j]
                for l in range(1, n):
                    acc = acc + vxx[kk][l] * f[l][j]
                w[kk][j] = acc
        qxx = [[None] * n for _ in range(n)]
        for i in range(n):
            for j in range(n):
                acc = cxx[t, i, j]
                for kk in range(n):
                    acc = acc + f[kk][i] * w[kk][j]
                qxx[i][j] = acc

        bad = quuF <= 0.0
        q_safe = torch.where(bad, torch.ones_like(quuF), quuF)
        x1 = clip(-qu / q_safe, lo[t], hi[t])
        gk = quuF * x1 + qu
        clamped = ((x1 <= lo[t]) & (gk > 0.0)) | ((x1 >= hi[t]) & (gk < 0.0))
        k = torch.where(bad, torch.zeros_like(x1), x1)
        zero_K = clamped | bad
        Kr = [torch.where(zero_K, torch.zeros_like(qux[j]), -qux[j] / q_safe)
              for j in range(n)]

        div = torch.maximum(div, bad.to(F32))
        dv0 = dv0 + k * qu
        dv1 = dv1 + 0.5 * k * quu * k
        kq = k * quu
        vx = [qx[j] + Kr[j] * kq + Kr[j] * qu + qux[j] * k for j in range(n)]
        vxx = [[qxx[i][j] + Kr[i] * quu * Kr[j] + Kr[i] * qux[j]
                + qux[i] * Kr[j] for j in range(n)] for i in range(n)]
        k_out[t] = k
        K_out[t] = torch.stack(Kr)
    return k_out, K_out, torch.stack([dv0, dv1]), div


# The state dimensions csrc/backward.cu is instantiated for: pendulum's 2,
# and acrobot's and cartpole's 4. A registered custom model with m = 1 has
# the kernel at its own n in its own library (backward_owner).
BACKWARD_KERNEL_NS = (2, 4)


def backward_owner(n: int):
    """The model whose library holds the backward kernel at ``n``: None
    for the main library's n (BACKWARD_KERNEL_NS), else the first
    registered custom model with m = 1 and that n; raises
    NotImplementedError when there is none."""
    if n in BACKWARD_KERNEL_NS:
        return None
    for model in models.custom_models():
        if model.m == 1 and model.n == n and model.has_soa:
            return model
    raise NotImplementedError(
        f"the backward kernel is compiled for n in {BACKWARD_KERNEL_NS} "
        "(csrc/backward.cu) and for the n of each registered custom model "
        f"with m = 1, not n = {n}")


def backward_ns():
    """Every state dimension the backward kernel has on the card."""
    return tuple(sorted({*BACKWARD_KERNEL_NS, *(
        m.n for m in models.custom_models() if m.m == 1 and m.has_soa)}))


def backward_sweep_packed(fx, fu, cx, cu, cxx, cxu, cuu, lo, hi, lam, cxT,
                          cxxT):
    """The m = 1 backward recursion (see module docstring).

    Returns (k (T, B), K (T, n, B), dv (2, B), diverged (B,) f32 0/1).
    """
    if not on_cuda(fu):
        return backward_plain(fx, fu, cx, cu, cxx, cxu, cuu, lo, hi, lam,
                              cxT, cxxT)
    dev = fu.device
    T, n, B = fu.shape
    owner = backward_owner(n)
    for t, shape, name in (
            (fx, (T, n, n, B), "fx"), (fu, (T, n, B), "fu"),
            (cx, (T, n, B), "cx"), (cu, (T, B), "cu"),
            (cxx, (T, n, n, B), "cxx"), (cxu, (T, n, B), "cxu"),
            (cuu, (T, B), "cuu"), (lo, (T, B), "lo"), (hi, (T, B), "hi"),
            (lam, (B,), "lam"), (cxT, (n, B), "cxT"),
            (cxxT, (n, n, B), "cxxT")):
        _build.require(t, shape, name, dev)
    k = torch.empty((T, B), dtype=F32, device=dev)
    K = torch.empty((T, n, B), dtype=F32, device=dev)
    dv = torch.empty((2, B), dtype=F32, device=dev)
    div = torch.empty((B,), dtype=F32, device=dev)
    _build.launch(f"ilqr_backward_n{n}", dev, fx, fu, cx, cu, cxx, cxu, cuu,
                  lo, hi, lam, cxT, cxxT, k, K, dv, div, T, B, model=owner)
    backward_sweep_packed.launches += 1
    return k, K, dv, div


backward_sweep_packed.launches = 0


def pack_backward_inputs(fx, fu, cx, cu, cxx, cxu, cuu, lo, hi):
    """The batch-major derivatives and limit offsets laid out as
    :func:`backward_sweep_packed` takes them, lane last: everything but λ,
    which a λ retry changes. A derivative that is the batch-major view of
    ``derivs_packed``'s lane-last output comes back as that output, with no
    copy. Counted in ``pack_backward_inputs.relayouts``: the composable
    solver lays its inputs out once per iteration and reuses them on every
    λ attempt (ops/backward.py :func:`backward_inputs`).

    Args as :func:`backward_sweep_batched`'s; ``lo``/``hi`` batch-major
    (B, T, 1) or lane-last (T, B) already."""
    pack_backward_inputs.relayouts += 1
    lim = lambda a: a if a.ndim == 2 else lane_last(a[..., 0])
    return (lane_last(fx), lane_last(fu[..., 0]), lane_last(cx[:, :-1]),
            lane_last(cu[..., 0]), lane_last(cxx[:, :-1]),
            lane_last(cxu[..., 0]), lane_last(cuu[..., 0, 0]), lim(lo),
            lim(hi), lane_last(cx[:, -1]), lane_last(cxx[:, -1]))


pack_backward_inputs.relayouts = 0


def backward_sweep_lanes(packed, lam):
    """:func:`backward_sweep_packed` on inputs that
    :func:`pack_backward_inputs` laid out, with ``lam`` (B,); the results
    batch-major: k (B,T,1), K (B,T,1,n), dV (B,2), diverged (B,) bool."""
    fx, fu, cx, cu, cxx, cxu, cuu, lo, hi, cxT, cxxT = packed
    k, K, dv, div = backward_sweep_packed(fx, fu, cx, cu, cxx, cxu, cuu, lo,
                                          hi, lam.to(F32).contiguous(), cxT,
                                          cxxT)
    return (batch_first(k)[..., None], batch_first(K)[:, :, None, :],
            batch_first(dv), div > 0.5)


def backward_sweep_batched(fx, fu, cx, cu, cxx, cxu, cuu, lo, hi, lam):
    """Batch-major wrapper (counterpart of
    ``pallas_backward.backward_sweep_batched`` and of ``backward_m1``'s
    batched rule; a single problem runs as one lane). Lanes are
    independent, so no padding is needed.

    Args: fx (B,T,n,n), fu (B,T,n,1), cx (B,T+1,n), cu (B,T,1),
    cxx (B,T+1,n,n), cxu (B,T,n,1), cuu (B,T,1,1), lo/hi (B,T,1) =
    limits − us, lam (B,). Returns (k (B,T,1), K (B,T,1,n), dV (B,2),
    diverged (B,) bool).
    """
    if fu.shape[-1] != 1:
        raise NotImplementedError(
            "the backward kernel is specialized to m = 1 (the closed-form "
            f"QP); got m = {fu.shape[-1]}")
    return backward_sweep_lanes(
        pack_backward_inputs(fx, fu, cx, cu, cxx, cxu, cuu, lo, hi), lam)
