"""One whole solver iteration in one op (counterpart of
``ilqr_tpu/ops/pallas_iter.py``): the merged linearize + backward sweep,
the take/keep gates, every line-search candidate, the first-accepted-α
selection and the post-accept state.

The CUDA kernel keeps the gains of all T steps in a (T, m·(n+1), B)
device-memory buffer the wrapper allocates (they do not fit on chip for a
useful number of lanes); see csrc/kernels.cu. Layout and dispatch as in
ops/kernel_rollout.py.
"""

from __future__ import annotations

import torch

from ilqr_tpu_torch.ops import _build
from ilqr_tpu_torch.ops.kernel_rollout import (
    F32,
    PackedParams,
    kernel_owner,
    linesearch_plain,
    on_cuda,
    param_stride,
    require_kernel_model,
)
from ilqr_tpu_torch.ops.kernel_sweep import (
    check_supported,
    kernel_args,
    sweep_plain,
)


def iteration_plain(model, integrator, clamp, pp, x0, xs_body, xterm, us,
                    kold, Kold, lam, cost_prev, live, alphas, mode="jvp",
                    use_limits=True, z_min=0.0, tol_grad=1e-6,
                    lambda_grad_term=1e-5, eps=1e-3):
    """Plain version of :func:`iteration_packed`: the sweep, the gates, then
    the line search."""
    k, K, dv, div, gnorm = sweep_plain(model, integrator, pp, xs_body, xterm,
                                       us, lam, mode, use_limits, eps)
    okf = 1.0 - div
    gtf = (okf * (gnorm < tol_grad).to(F32)
           * (lam < lambda_grad_term).to(F32))
    gate = okf * (1.0 - gtf) * live   # take-step gate
    keep = okf * live                 # gain-keep gate
    outs = linesearch_plain(model, integrator, clamp, pp, x0, us, xs_body,
                            xterm, K, k, Kold, kold, alphas, dv, cost_prev,
                            gate, keep, z_min)
    return (*outs, div, gnorm)


def iteration_packed(model, integrator: str, clamp: bool, pp: PackedParams,
                     x0, xs_body, xterm, us, kold, Kold, lam, cost_prev, live,
                     alphas, mode: str = "jvp", use_limits: bool = True,
                     z_min: float = 0.0, tol_grad: float = 1e-6,
                     lambda_grad_term: float = 1e-5, eps: float = 1e-3):
    """One full solver iteration (backward sweep + line search + epilogue).

    Shapes: x0 (n, B), xs_body (T, n, B), xterm (n, B), us (T, m, B),
    kold (T, m, B), Kold (T, m, n, B), alphas (A,); lam, cost_prev, live
    (B,) with the live mask as f32 0/1 (lanes with live == 0 re-emit their
    state unchanged). ``mode`` and ``eps`` as in
    :func:`~ilqr_tpu_torch.ops.kernel_sweep.sweep_packed`; the line search
    takes the ``integrator`` step too.

    Returns (xs_body, us, x_final, k_keep, K_keep, ls_cost, alpha_sel,
    accepted (f32 0/1, raw z-test), dcost, expected, diverged (f32 0/1),
    gnorm).
    """
    check_supported(model, integrator, mode)
    if not on_cuda(us):
        return iteration_plain(model, integrator, clamp, pp, x0, xs_body,
                               xterm, us, kold, Kold, lam, cost_prev, live,
                               alphas, mode, use_limits, z_min, tol_grad,
                               lambda_grad_term, eps)
    dev = us.device
    T, m, B = us.shape
    n = model.n
    prefix = require_kernel_model(model, integrator, pp, dev, lanes=B,
                                  limits=clamp or use_limits)
    A = alphas.shape[0]
    max_a = _build.lib_for(kernel_owner(model)).ilqr_max_alphas()
    if not 1 <= A <= max_a:
        raise ValueError(f"iteration kernel takes 1..{max_a} alphas, got {A}")
    for t, shape, name in (
            (x0, (n, B), "x0"), (xs_body, (T, n, B), "xs_body"),
            (xterm, (n, B), "xterm"), (us, (T, m, B), "us"),
            (kold, (T, m, B), "kold"), (Kold, (T, m, n, B), "Kold"),
            (lam, (B,), "lam"), (cost_prev, (B,), "cost_prev"),
            (live, (B,), "live"), (alphas, (A,), "alphas")):
        _build.require(t, shape, name, dev)
    outs = (torch.empty((T, n, B), dtype=F32, device=dev),
            torch.empty((T, m, B), dtype=F32, device=dev),
            torch.empty((n, B), dtype=F32, device=dev),
            torch.empty((T, m, B), dtype=F32, device=dev),
            torch.empty((T, m, n, B), dtype=F32, device=dev),
            *(torch.empty((B,), dtype=F32, device=dev) for _ in range(7)))
    gains = torch.empty((T, m * (n + 1), B), dtype=F32, device=dev)
    suffix, extra = kernel_args(mode, integrator, eps, model)
    _build.launch(f"{prefix}_iteration{suffix}", dev, pp.vec,
                  param_stride(pp), x0, xs_body, xterm, us, Kold, kold,
                  alphas, A, lam, cost_prev, live, *outs, gains,
                  float(z_min), float(tol_grad),
                  float(lambda_grad_term), T, B, int(bool(clamp)),
                  int(bool(use_limits)), *extra, model=kernel_owner(model))
    iteration_packed.launches += 1
    return outs


iteration_packed.launches = 0
