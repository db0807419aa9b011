"""Merged linearize + backward sweep (counterpart of
``ilqr_tpu/ops/pallas_sweep.py``).

Per timestep, in reverse time: the model derivatives at (x_t, u_t), the
Q-terms, the λ-regularized QuuF, the in-kernel QP (ops/qp.py: the
closed-form m = 1 box QP, the exact enumeration for m = 2…4, projected
Newton for 5 ≤ m ≤ 24, or with ``use_limits=False`` the unconstrained
Newton step), the feedback rows zeroed on clamped controls, dV, the exactly
symmetric Vxx update, a latched divergence flag and the gradient norm (ref
src/ilqr_core.cpp:350-401).

The derivatives come, as in the JAX kernel, from one of three sources:

- the model's closed forms (``mode="jvp"`` with a model that has
  ``jac_soa`` and the Euler step, the JAX kernel's use_analytic: fx = I +
  dt·A, fu = dt·B, the cost's analytic derivatives; structural constants
  fold);
- exact forward-mode derivatives of the discrete step and of the costs
  (``mode="jvp"`` otherwise: the RK4 step, or a model without ``jac_soa``
  such as a custom model with either step; dual numbers through every
  stage, the JAX kernel's in-kernel JVPs);
- the reference's central stencils (``mode="fd"``, eps = ``eps``) of the
  discrete Euler or RK4 step and of the costs.

The last two give dense fx, fu, cx, cu, cxx, cxu, cuu and a dense V_T
Hessian, every sum starting at its first term; the plain version evaluates
them at all T steps at once (ops/kernel_derivs.py) and runs the recursion
over them. m ≤ 24 (past it ``ValueError``, as in the JAX package).

Layout and dispatch as in ops/kernel_rollout.py.
"""

from __future__ import annotations

import dataclasses

import torch

from ilqr_tpu_torch.ops import _build, qp
from ilqr_tpu_torch.ops.kernel_derivs import (
    fd_running,
    fd_terminal,
    jvp_running,
    jvp_terminal,
)
from ilqr_tpu_torch.ops.kernel_rollout import (
    F32,
    PackedParams,
    kernel_owner,
    on_cuda,
    param_stride,
    plain_model,
    require_kernel_model,
    scheme,
    unpack_params,
)


# --- constant folding -------------------------------------------------------
# Models return plain Python floats for structurally constant Jacobian and
# Hessian entries. These helpers drop products and sums with such constants,
# as the JAX package folds them at trace time, so the plain version computes
# the same terms in the same order as the JAX kernel and the CUDA kernel
# (which skips the same structural zeros).

def _is_const(v):
    return isinstance(v, (int, float))


def _fmul(a, b):
    if _is_const(a):
        if _is_const(b):
            return a * b
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
    if _is_const(b):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
    return a * b


def _fadd(a, b):
    if _is_const(a):
        if _is_const(b):
            return a + b
        if a == 0.0:
            return b
    if _is_const(b) and b == 0.0:
        return a
    return a + b


def _lane(v, like):
    """``v`` (Python float or a tensor broadcastable to ``like``) as a
    tensor shaped like ``like``."""
    if _is_const(v):
        return torch.full_like(like, v)
    return torch.broadcast_to(v, like.shape)


def check_supported(model, integrator: str, mode: str):
    """Raises for what the sweep does not take: m > 24, an unknown
    integrator or derivative mode. ``mode="fd"`` and ``mode="jvp"`` run
    with the Euler or the RK4 step for every model with SoA functions."""
    if model.m > qp.MAX_FUSED_M:
        raise ValueError(
            f"merged sweep kernel supports m <= {qp.MAX_FUSED_M}")
    scheme(integrator)
    if mode not in ("jvp", "fd"):
        raise ValueError(f"unknown derivative mode {mode!r}")


def _analytic(mode: str, integrator: str, model=None) -> bool:
    """Whether the closed forms apply (the JAX kernel's use_analytic: jvp
    mode, the Euler step and a model with ``jac_soa``; ``model`` None
    stands for one that has it)."""
    return (mode == "jvp" and integrator == "euler"
            and (model is None or model.has_analytic_soa))


@dataclasses.dataclass
class _Carry:
    vx: list      # n lanes
    vxx: list     # n × n lanes, exactly symmetric
    dv0: torch.Tensor
    dv1: torch.Tensor
    div: torch.Tensor   # latched divergence, f32 0/1
    gacc: torch.Tensor  # Σ_t max_j |k_j| / (|u_j| + 1)


def _terminal_init(model, p, xT) -> _Carry:
    """V_T from the final cost's analytic derivatives; zeroed accumulators."""
    n = model.n
    like = xT[0]
    fcx, fcxx = model.final_cost_derivs_soa(p, xT)
    return _carry([_lane(fcx[i], like) for i in range(n)],
                  [[_lane(fcxx[i][j], like) for j in range(n)]
                   for i in range(n)])


def _terminal_dense(model, p, xT, mode, eps) -> _Carry:
    """V_T from the final cost's dual numbers (``mode="jvp"``) or stencils
    (``"fd"``) at xT (u_T = 0, which the final cost ignores): a dense
    Hessian; zeroed accumulators."""
    n = model.n
    if mode == "jvp":
        c1, h, pairs = jvp_terminal(model, p, xT[:, None], xT.device)
    else:
        c1, h, pairs = fd_terminal(model, p, xT[:, None], eps, xT.device)
    vxx = [[None] * n for _ in range(n)]
    for q, (a, b) in enumerate(pairs):
        vxx[a][b] = vxx[b][a] = h[q, 0]
    return _carry([c1[i, 0] for i in range(n)], vxx)


def _carry(vx, vxx) -> _Carry:
    zero = torch.zeros_like(vx[0])
    return _Carry(vx=vx, vxx=vxx, dv0=zero, dv1=zero, div=zero, gacc=zero)


def _analytic_derivs(model, p, dt, x, u):
    """(fx, fu, cx, cu, cxx, cxu, cuu) at (x, u) from the closed forms:
    fx = I + dt·A, fu = dt·B; structural constants stay Python floats."""
    n, m = model.n, model.m
    A, Bm = model.jac_soa(p, x, u)
    fxc = [[_fadd(_fmul(dt, A[r][i]), 1.0 if r == i else 0.0)
            for i in range(n)] for r in range(n)]
    fuc = [[_fmul(dt, Bm[r][j]) for j in range(m)] for r in range(n)]
    return (fxc, fuc, *model.cost_derivs_soa(p, x, u))


class _DenseDerivs:
    """The dual numbers' (``mode="jvp"``) or the stencils' (``"fd"``)
    dense derivatives at every running step, evaluated at once; ``at(t)``
    gives step t's as nested lists of lanes."""

    def __init__(self, model, integrator, p, dt, xs_body, us, mode, eps):
        self.n, self.m = model.n, model.m
        x, u = xs_body.permute(1, 0, 2), us.permute(1, 0, 2)
        if mode == "jvp":
            out = jvp_running(model, p, dt, integrator, x, u, us.device)
        else:
            out = fd_running(model, p, dt, integrator, x, u, eps, us.device)
        self.jac, self.c1, self.h, self.pairs = out

    def at(self, t):
        n, m = self.n, self.m
        jac, c1, h = self.jac[:, :, t], self.c1[:, t], self.h[:, t]
        fxc = [[jac[r, i] for i in range(n)] for r in range(n)]
        fuc = [[jac[r, n + j] for j in range(m)] for r in range(n)]
        cxx = [[None] * n for _ in range(n)]
        cxu = [[None] * m for _ in range(n)]
        cuu = [[None] * m for _ in range(m)]
        for q, (a, b) in enumerate(self.pairs):
            if b < n:
                cxx[a][b] = cxx[b][a] = h[q]
            elif a < n:
                cxu[a][b - n] = h[q]
            else:
                cuu[a - n][b - n] = cuu[b - n][a - n] = h[q]
        return (fxc, fuc, [c1[i] for i in range(n)],
                [c1[n + j] for j in range(m)], cxx, cxu, cuu)


def _sweep_step(model, p, lam, use_limits, c: _Carry, x, u, derivs):
    """One backward step at (x, u) with ``derivs`` = (fx, fu, cx, cu, cxx,
    cxu, cuu) there; advances ``c`` and returns (k, Krow): k a list of m
    lanes, Krow an m × n nested list of lanes."""
    n, m = model.n, model.m
    tile = x[0]
    fxc, fuc, cx1, cu1, cxx1, cxu1, cuu1 = derivs

    vxl, vxxl = c.vx, c.vxx
    fuT_vxx = [[None] * n for _ in range(m)]
    for jm in range(m):
        for jn in range(n):
            acc = 0.0
            for i in range(n):
                acc = _fadd(acc, _fmul(fuc[i][jm], vxxl[i][jn]))
            fuT_vxx[jm][jn] = acc

    qu = []
    for jm in range(m):
        acc = cu1[jm]
        for i in range(n):
            acc = _fadd(acc, _fmul(fuc[i][jm], vxl[i]))
        qu.append(_lane(acc, tile))

    quu = [[None] * m for _ in range(m)]
    for im in range(m):
        for jm in range(im, m):
            acc = cuu1[im][jm]
            for i in range(n):
                acc = _fadd(acc, _fmul(fuT_vxx[im][i], fuc[i][jm]))
            acc = _lane(acc, tile)
            quu[im][jm] = acc
            quu[jm][im] = acc
    quuF = [[_lane(_fadd(quu[im][jm], lam if im == jm else 0.0), tile)
             for jm in range(m)] for im in range(m)]

    qux = [[None] * n for _ in range(m)]
    qx = [None] * n
    for jn in range(n):
        accx = cx1[jn]
        for i in range(n):
            accx = _fadd(accx, _fmul(fxc[i][jn], vxl[i]))
        qx[jn] = _lane(accx, tile)
        for jm in range(m):
            accq = cxu1[jn][jm]
            for i in range(n):
                accq = _fadd(accq, _fmul(fuT_vxx[jm][i], fxc[i][jn]))
            qux[jm][jn] = _lane(accq, tile)

    w = [[None] * n for _ in range(n)]
    for kk in range(n):
        for j in range(n):
            acc = 0.0
            for l in range(n):
                acc = _fadd(acc, _fmul(vxxl[kk][l], fxc[l][j]))
            w[kk][j] = acc
    qxx = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i, n):
            acc = cxx1[i][j]
            for kk in range(n):
                acc = _fadd(acc, _fmul(fxc[kk][i], w[kk][j]))
            acc = _lane(acc, tile)
            qxx[i][j] = acc
            qxx[j][i] = acc

    if use_limits:
        lo = [p.u_min[jm] - u[jm] for jm in range(m)]
        hi = [p.u_max[jm] - u[jm] for jm in range(m)]
        k_i, free, bad = qp.box_qp(quuF, qu, lo, hi, m)
    else:
        k_i, free, bad = qp.qp_newton(quuF, qu, m)
    Krow = qp.free_solve_rows(quuF, free, qux, m)

    # dV and the divergence latch; the JAX kernel sums onto a zero tile,
    # which leaves every value as the first term's
    c.div = torch.maximum(c.div, bad.to(F32))
    d0 = k_i[0] * qu[0]
    for jm in range(1, m):
        d0 = d0 + k_i[jm] * qu[jm]
    d1 = None
    for im in range(m):
        for jm in range(m):
            t = 0.5 * k_i[im] * quu[im][jm] * k_i[jm]
            d1 = t if d1 is None else d1 + t
    c.dv0 = c.dv0 + d0
    c.dv1 = c.dv1 + d1

    quu_k = []
    for im in range(m):
        acc = quu[im][0] * k_i[0]
        for jm in range(1, m):
            acc = acc + quu[im][jm] * k_i[jm]
        quu_k.append(acc)
    vx_new = []
    for i in range(n):
        acc = qx[i]
        for cm in range(m):
            acc = (acc + Krow[cm][i] * quu_k[cm] + Krow[cm][i] * qu[cm]
                   + qux[cm][i] * k_i[cm])
        vx_new.append(acc)
    vxx_new = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i, n):
            acc = qxx[i][j]
            for cm in range(m):
                for d in range(m):
                    acc = acc + Krow[cm][i] * quu[cm][d] * Krow[d][j]
                acc = acc + Krow[cm][i] * qux[cm][j] + qux[cm][i] * Krow[cm][j]
            vxx_new[i][j] = acc
            vxx_new[j][i] = acc
    c.vx, c.vxx = vx_new, vxx_new

    gstep = torch.abs(k_i[0]) / (torch.abs(u[0]) + 1.0)
    for jm in range(1, m):
        gstep = torch.maximum(gstep,
                              torch.abs(k_i[jm]) / (torch.abs(u[jm]) + 1.0))
    c.gacc = c.gacc + gstep
    return k_i, Krow


def sweep_plain(model, integrator, pp, xs_body, xterm, us, lam, mode="jvp",
                use_limits=True, eps=1e-3):
    """Plain version of :func:`sweep_packed`."""
    check_supported(model, integrator, mode)
    model = plain_model(model, pp.shapes)
    p, dt = unpack_params(pp)
    T, m, B = us.shape
    n = xs_body.shape[1]
    k = torch.empty((T, m, B), dtype=F32, device=us.device)
    K = torch.empty((T, m, n, B), dtype=F32, device=us.device)
    if _analytic(mode, integrator, model):
        c = _terminal_init(model, p, xterm)
        derivs_at = lambda t: _analytic_derivs(model, p, dt, xs_body[t],
                                               us[t])
    else:
        c = _terminal_dense(model, p, xterm, mode, eps)
        derivs_at = _DenseDerivs(model, integrator, p, dt, xs_body, us,
                                 mode, eps).at
    for t in reversed(range(T)):
        k_i, Krow = _sweep_step(model, p, lam, use_limits, c, xs_body[t],
                                us[t], derivs_at(t))
        k[t] = torch.stack(k_i)
        K[t] = torch.stack([torch.stack(row) for row in Krow])
    dv = torch.stack([c.dv0, c.dv1])
    return k, K, dv, c.div, c.gacc * (1.0 / T)


def kernel_args(mode: str, integrator: str, eps: float, model=None):
    """The launcher suffix and the trailing arguments of the sweep and
    iteration launchers: none for the analytic kernels (Euler, a model with
    ``jac_soa``; ``model`` None stands for one); the integrator for the
    dual-number ones (_jvp); for the stencil ones (_fd) the integrator, eps
    and the denominators 2·eps and 4·eps², each taken in double and
    rounded once to f32 by ctypes, as the JAX kernel rounds its Python
    floats."""
    if _analytic(mode, integrator, model):
        return "", ()
    if mode == "jvp":
        return "_jvp", (scheme(integrator),)
    return "_fd", (scheme(integrator), float(eps), float(2.0 * eps),
                   float(4.0 * eps * eps))


def sweep_packed(model, integrator: str, pp: PackedParams, xs_body, xterm,
                 us, lam, mode: str = "jvp", use_limits: bool = True,
                 eps: float = 1e-3):
    """Merged linearize + backward sweep.

    Shapes: xs_body (T, n, B) and xterm (n, B) — the trajectory body and
    terminal state; us (T, m, B); lam (B,). Control limits come from the
    packed params; ``use_limits=False`` takes the unconstrained Newton
    step instead. ``mode="jvp"`` takes the closed forms with the Euler step
    and dual numbers through the RK4 step; ``mode="fd"`` differentiates the
    ``integrator`` step and the costs by the central stencils with
    ``eps``. Returns (k (T, m, B),
    K (T, m, n, B), dv (2, B), diverged (B,) f32 0/1, gnorm (B,)).
    """
    check_supported(model, integrator, mode)
    if not on_cuda(us):
        return sweep_plain(model, integrator, pp, xs_body, xterm, us, lam,
                           mode, use_limits, eps)
    dev = us.device
    T, m, B = us.shape
    n = model.n
    prefix = require_kernel_model(model, integrator, pp, dev, lanes=B,
                                  limits=use_limits)
    for t, shape, name in ((xs_body, (T, n, B), "xs_body"),
                           (xterm, (n, B), "xterm"), (us, (T, m, B), "us"),
                           (lam, (B,), "lam")):
        _build.require(t, shape, name, dev)
    k = torch.empty((T, m, B), dtype=F32, device=dev)
    K = torch.empty((T, m, n, B), dtype=F32, device=dev)
    dv = torch.empty((2, B), dtype=F32, device=dev)
    div = torch.empty((B,), dtype=F32, device=dev)
    gnorm = torch.empty((B,), dtype=F32, device=dev)
    suffix, extra = kernel_args(mode, integrator, eps, model)
    _build.launch(f"{prefix}_sweep{suffix}", dev, pp.vec, param_stride(pp),
                  xs_body, xterm, us, lam, k, K, dv, div, gnorm, T, B,
                  int(bool(use_limits)), *extra, model=kernel_owner(model))
    sweep_packed.launches += 1
    return k, K, dv, div, gnorm


sweep_packed.launches = 0
