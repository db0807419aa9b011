"""The linearization stage: fx, fu, cx, cu, cxx, cxu, cuu for every
(timestep, lane) (counterpart of ``ilqr_tpu/ops/pallas_derivs.py``).

Two modes, as in the JAX kernel: ``"jvp"`` differentiates the model's SoA
functions exactly in forward mode (n+m first-order directions of the Euler
or RK4 step, through every stage, and of the cost; JVP-of-JVP for the
cost's second derivatives on the upper triangle, mirrored); ``"fd"`` takes
the reference's central stencils with ``eps`` (2-point gradient and
Jacobian, 4-point Hessian). The terminal row cx[T], cxx[T] comes from the
final cost (ref derivatives.cpp:48-49, 92).

The plain version, :func:`derivs_plain`, is vectorized over (t, lane) and
the directions, with no loop over T. Its forward mode runs the port's SoA
model functions on :class:`Dual` numbers whose rules are the CUDA kernel's
(csrc/dual.cuh), which are JAX's jvp rules in JAX's operation order; so the
kernel and the plain version compute the same IEEE operations.

The helpers of both modes (:func:`jvp_running`, :func:`jvp_terminal`,
:func:`fd_running`, :func:`fd_terminal`) are model-generic and take the
integrator; the merged sweep's plain version (ops/kernel_sweep.py) takes
its dense derivatives from them. The CUDA kernel (csrc/derivs.cuh) is
instantiated for every model of the package, one csrc/derivs_<model>.cu
each (:data:`DERIVS_KERNEL_MODELS`), and for a registered custom model in
its own library; the plain version takes any model.

Layout (lane last) and dispatch as in ops/kernel_rollout.py.
"""

from __future__ import annotations

import torch

from ilqr_tpu_torch.ops import _build
from ilqr_tpu_torch.ops.kernel_rollout import (
    F32,
    FUSED_KERNEL_MODELS,
    PackedParams,
    batch_first,
    integrate,
    kernel_owner,
    lane_last,
    on_cuda,
    param_stride,
    plain_model,
    require_kernel_model,
    scheme,
    unpack_params,
)


class Dual:
    """Forward-mode dual number over lane tensors, or over Duals for
    second derivatives (the outer layer carries the first direction, the
    inner one the second, as JAX nests jvp(jvp(f, ti), tj)). A non-Dual
    operand is a constant. The rules and their operation order are those of
    csrc/dual.cuh."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v, self.d = v, d

    def __add__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v + o.v, self.d + o.d)
        return Dual(self.v + o, self.d)

    def __radd__(self, o):
        return Dual(o + self.v, self.d)

    def __sub__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v - o.v, self.d - o.d)
        return Dual(self.v - o, self.d)

    def __rsub__(self, o):
        return Dual(o - self.v, -self.d)

    def __mul__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v * o.v, self.d * o.v + self.v * o.d)
        return Dual(self.v * o, self.d * o)

    def __rmul__(self, o):
        return Dual(o * self.v, o * self.d)

    def __truediv__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v / o.v,
                        self.d / o.v + (-o.d * self.v) * (1.0 / (o.v * o.v)))
        return Dual(self.v / o, self.d / o)

    def __rtruediv__(self, o):
        return Dual(o / self.v, (-self.d * o) * (1.0 / (self.v * self.v)))

    def __neg__(self):
        return Dual(-self.v, -self.d)

    @property
    def primal(self):
        """The value a chain of duals is taken at."""
        return self.v.primal if isinstance(self.v, Dual) else self.v

    def __getitem__(self, i):
        return Dual(self.v[i], self.d[i])

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.sin:
            x = args[0]
            return Dual(torch.sin(x.v), x.d * torch.cos(x.v))
        if func is torch.cos:
            x = args[0]
            return Dual(torch.cos(x.v), -(x.d * torch.sin(x.v)))
        if func is torch.tan:   # jax/_src/lax/lax.py tan_p: g·(1 + ans²)
            x = args[0]
            t = torch.tan(x.v)
            return Dual(t, x.d * (1.0 + t * t))
        if func is torch.abs:   # lax.py _abs_jvp_rule: select(x ≥ 0, g, −g)
            x = args[0]
            return Dual(torch.abs(x.v), _select(x.primal >= 0.0, x.d, -x.d))
        if func in (torch.ones_like, torch.zeros_like, torch.full_like):
            # a constant: its tangent is JAX's symbolic zero
            return func(args[0].primal, *args[1:], **(kwargs or {}))
        if func is torch.stack and not kwargs and len(args) == 1:
            return _stack(args[0])
        return NotImplemented


def _select(cond, a, b):
    """torch.where over the parts of two Duals (or of two tensors)."""
    if isinstance(a, Dual):
        return Dual(_select(cond, a.v, b.v), _select(cond, a.d, b.d))
    return torch.where(cond, a, b)


def _stack(items):
    """torch.stack of Duals, their parts broadcast to one shape."""
    vs, ds = [i.v for i in items], [i.d for i in items]
    if isinstance(vs[0], Dual):
        return Dual(_stack(vs), _stack(ds))
    return Dual(torch.stack(torch.broadcast_tensors(*vs)),
                torch.stack(torch.broadcast_tensors(*ds)))


def _basis(c, a, dev):
    """1.0 where input component c is direction a, else 0.0, per direction
    ``a`` (a 1-d tensor of direction indices)."""
    return (a == c).to(F32).to(dev)


def _pairs(nz):
    """Second-order direction pairs (a, b ≥ a) in the JAX kernel's order:
    the state block, then state × control, then the control block."""
    return [(a, b) for a in range(nz) for b in range(a, nz)]


def _check(mode, integrator):
    if mode not in ("jvp", "fd"):
        raise ValueError(f"unknown derivative mode {mode!r}")
    scheme(integrator)


def _store_second(n, m, h, pairs, T1, B, dev):
    """(P, T', B) pair values → (cxx (T', n, n, B), cxu, cuu), symmetric
    blocks mirrored from the upper triangle."""
    nz = n + m
    full = torch.zeros((nz, nz, T1, B), dtype=F32, device=dev)
    for p, (a, b) in enumerate(pairs):
        full[a, b] = h[p]
        if a != b and (b < n or a >= n):   # symmetric blocks only
            full[b, a] = h[p]
    full = full.permute(2, 0, 1, 3)        # (T', nz, nz, B)
    return full[:, :n, :n], full[:, :n, n:], full[:, n:, n:]


def _tangent(c, a, dev, shape):
    """The tangent of input component c along directions ``a``, expanded
    to every (t, lane) — a view; every op on it then has one result per
    (direction, t, lane), as in the kernel's threads."""
    return _basis(c, a, dev)[:, None, None].expand((len(a),) + shape)


# Elements of one pass of the forward mode: the directions and pairs are
# taken in chunks of at most this many (direction, t, lane) values, so that
# a pass over a long, wide batch stays within memory (the chip's checks run
# several plain versions at once) while a short one takes all at once.
JVP_CHUNK = 1 << 24


def _chunks(items, per_item):
    """``items`` in consecutive chunks of at most JVP_CHUNK // per_item."""
    k = max(1, JVP_CHUNK // max(1, per_item))
    return [items[i:i + k] for i in range(0, len(items), k)]


def jvp_running(model, p, dt, integrator, x, u, dev):
    """Forward mode at every running (t, lane): x (n, T, B), u (m, T, B)
    → (jac (n, n+m, T, B) of the discrete step, c1 (n+m, T, B), h (P, T, B)
    over ``pairs``, pairs), as :func:`fd_running` returns them."""
    n, m = model.n, model.m
    sh = tuple(x.shape[1:])
    jac, c1 = [], []
    for dirs in _chunks(list(range(n + m)), x[0].numel()):
        dirs = torch.tensor(dirs)
        xd = [Dual(x[c][None], _tangent(c, dirs, dev, sh)) for c in range(n)]
        ud = [Dual(u[c][None], _tangent(n + c, dirs, dev, sh))
              for c in range(m)]
        jac.append(integrate(model, p, dt, integrator, _stack(xd),
                             _stack(ud)).d)              # (n, k, T, B)
        c1.append(model.cost_soa(p, xd, ud).d)            # (k, T, B)
    pairs = _pairs(n + m)
    return (torch.cat(jac, 1), torch.cat(c1),
            _second(model.cost_soa, p, [*x, *u], n, pairs, dev), pairs)


def _second(cost, p, z, n, pairs, dev):
    """The cost's second derivatives along ``pairs`` (a, b) at every point
    of z (the n states, then the controls): inner direction a, outer b →
    (P, *z[0].shape)."""
    sh = tuple(z[0].shape)
    out = []
    for chunk in _chunks(pairs, z[0].numel()):
        pa = torch.tensor([a for a, _ in chunk])
        pb = torch.tensor([b for _, b in chunk])
        zero = torch.zeros((), dtype=F32, device=dev).expand(
            (len(chunk),) + sh)
        zd = [Dual(Dual(zc[None], _tangent(c, pb, dev, sh)),
                   Dual(_tangent(c, pa, dev, sh), zero))
              for c, zc in enumerate(z)]
        out.append(cost(p, zd[:n], zd[n:]).d.d)
    return torch.cat(out)


def jvp_terminal(model, p, xT, dev):
    """Forward mode of the final cost at xT (n, T', B) → (c1 (n, T', B),
    h (P, T', B) over ``pairs``, pairs)."""
    n = model.n
    dirs = torch.arange(n)
    sh = tuple(xT.shape[1:])
    xd = [Dual(xT[c][None], _tangent(c, dirs, dev, sh)) for c in range(n)]
    c1 = model.final_cost_soa(p, xd).d                   # (n, T', B)
    pairs = _pairs(n)
    final = lambda pp, xs, _us: model.final_cost_soa(pp, xs)
    return c1, _second(final, p, list(xT), n, pairs, dev), pairs


def _shift(z, coef, eps, sign):
    """z ± eps·coef per input component: z[c] (T', B), coef[c] (K,) →
    (K, T', B); the JAX kernel's ``x + eps * t`` / ``x - eps * t``."""
    out = []
    for c in range(len(z)):
        step = eps * coef[c][:, None, None]
        out.append(z[c][None] + step if sign > 0 else z[c][None] - step)
    return out


def fd_running(model, p, dt, integrator, x, u, eps, dev):
    """The stencils at every running (t, lane): x (n, T, B), u (m, T, B)
    → (jac (n, n+m, T, B) of the discrete step, c1 (n+m, T, B), h (P, T, B)
    over ``pairs``, pairs)."""
    n, m = model.n, model.m
    nz = n + m
    z = [x[c] for c in range(n)] + [u[c] for c in range(m)]
    dirs = torch.arange(nz)
    t1 = [_basis(c, dirs, dev) for c in range(nz)]
    den1 = torch.tensor(2.0 * eps, dtype=F32, device=dev)
    den2 = torch.tensor(4.0 * eps * eps, dtype=F32, device=dev)

    def step(zz):
        return integrate(model, p, dt, integrator, torch.stack(zz[:n]),
                         torch.stack(zz[n:]))

    def cost(zz):
        return model.cost_soa(p, zz[:n], zz[n:])

    zp, zm = _shift(z, t1, eps, 1), _shift(z, t1, eps, -1)
    jac = (step(zp) - step(zm)) / den1                   # (n, nz, T, B)
    c1 = (cost(zp) - cost(zm)) / den1                    # (nz, T, B)
    pairs = _pairs(nz)
    h = _fd_hessian(cost, z, pairs, eps, den2, dev)
    return jac, c1, h, pairs


def fd_terminal(model, p, xT, eps, dev):
    """The final cost's stencils at xT (n, T', B) → (c1 (n, T', B),
    h (P, T', B) over ``pairs``, pairs)."""
    n = model.n
    z = [xT[c] for c in range(n)]
    dirs = torch.arange(n)
    t1 = [_basis(c, dirs, dev) for c in range(n)]
    den1 = torch.tensor(2.0 * eps, dtype=F32, device=dev)
    den2 = torch.tensor(4.0 * eps * eps, dtype=F32, device=dev)

    def cost(zz):
        return model.final_cost_soa(p, zz)

    c1 = (cost(_shift(z, t1, eps, 1)) - cost(_shift(z, t1, eps, -1))) / den1
    pairs = _pairs(n)
    return c1, _fd_hessian(cost, z, pairs, eps, den2, dev), pairs


def _fd_hessian(cost, z, pairs, eps, den2, dev):
    """(f₊₊ − f₊₋ − f₋₊ + f₋₋) / (4 eps²) for every pair at once."""
    pa = torch.tensor([a for a, _ in pairs])
    pb = torch.tensor([b for _, b in pairs])
    tsum = [_basis(c, pa, dev) + _basis(c, pb, dev) for c in range(len(z))]
    tdif = [_basis(c, pa, dev) - _basis(c, pb, dev) for c in range(len(z))]
    fpp = cost(_shift(z, tsum, eps, 1))
    fpm = cost(_shift(z, tdif, eps, 1))
    fmp = cost(_shift(z, tdif, eps, -1))
    fmm = cost(_shift(z, tsum, eps, -1))
    return (fpp - fpm - fmp + fmm) / den2


def derivs_plain(model, integrator, pp: PackedParams, xs, us, mode="jvp",
                 eps=1e-3):
    """Plain version of :func:`derivs_packed`."""
    _check(mode, integrator)
    model = plain_model(model, pp.shapes)
    p, dt = unpack_params(pp)
    T, m, B = us.shape
    n = xs.shape[1]
    dev = us.device
    x = xs[:T].permute(1, 0, 2)                          # (n, T, B)
    u = us.permute(1, 0, 2)                              # (m, T, B)
    xT = xs[T:].permute(1, 0, 2)                         # (n, 1, B)
    if mode == "jvp":
        jac, c1, h, pairs = jvp_running(model, p, dt, integrator, x, u, dev)
        c1T, hT, pairsT = jvp_terminal(model, p, xT, dev)
    else:
        jac, c1, h, pairs = fd_running(model, p, dt, integrator, x, u, eps,
                                       dev)
        c1T, hT, pairsT = fd_terminal(model, p, xT, eps, dev)
    jac = jac.permute(2, 0, 1, 3)                        # (T, n, nz, B)
    fx = jac[:, :, :n].contiguous()
    fu = jac[:, :, n:].contiguous()
    cx = torch.cat([c1[:n].permute(1, 0, 2), c1T.permute(1, 0, 2)])
    cu = c1[n:].permute(1, 0, 2).contiguous()
    cxx, cxu, cuu = _store_second(n, m, h, pairs, T, B, dev)
    cxxT, _, _ = _store_second(n, 0, hT, pairsT, 1, B, dev)
    return (fx, fu, cx.contiguous(), cu, torch.cat([cxx, cxxT]).contiguous(),
            cxu.contiguous(), cuu.contiguous())


# The package's models csrc/derivs.cuh is compiled for (one
# csrc/derivs_<model>.cu each), with their params types: every model the
# fused kernels carry (a registered custom model's is in its own library).
# The split sweep runs the m = 1 ones, the composable path all of them.
DERIVS_KERNEL_MODELS = dict(FUSED_KERNEL_MODELS)


def derivs_packed(model, integrator: str, pp: PackedParams, xs, us,
                  mode: str = "jvp", eps: float = 1e-3):
    """Linearization of the Euler or RK4 step and quadratization of the
    cost at every (t, lane), plus the final cost's terminal row.

    Shapes: xs (T+1, n, B), us (T, m, B). Returns (fx (T, n, n, B),
    fu (T, n, m, B), cx (T+1, n, B), cu (T, m, B), cxx (T+1, n, n, B),
    cxu (T, n, m, B), cuu (T, m, m, B)).
    """
    _check(mode, integrator)
    if not on_cuda(us):
        return derivs_plain(model, integrator, pp, xs, us, mode, eps)
    dev = us.device
    T, m, B = us.shape
    prefix = require_kernel_model(model, integrator, pp, dev,
                                  have=DERIVS_KERNEL_MODELS, lanes=B)
    n = model.n
    _build.require(xs, (T + 1, n, B), "xs", dev)
    _build.require(us, (T, m, B), "us", dev)
    e = lambda *s: torch.empty(s, dtype=F32, device=dev)
    outs = (e(T, n, n, B), e(T, n, m, B), e(T + 1, n, B), e(T, m, B),
            e(T + 1, n, n, B), e(T, n, m, B), e(T, m, m, B))
    # the stencil's constants as the JAX kernel rounds them: eps, 2·eps and
    # 4·eps² taken in double, then to f32
    _build.launch(f"{prefix}_derivs", dev, pp.vec, param_stride(pp), xs, us,
                  *outs, int(mode == "fd"), scheme(integrator), float(eps),
                  float(2.0 * eps), float(4.0 * eps * eps), T, B,
                  model=kernel_owner(model))
    derivs_packed.launches += 1
    return outs


derivs_packed.launches = 0


def derivs_batched(model, integrator: str, pp: PackedParams, xs, us,
                   mode: str = "jvp", eps: float = 1e-3):
    """Batch-major wrapper of :func:`derivs_packed` (counterpart of
    ``pallas_derivs.derivs_batched``): xs (B, T+1, n), us (B, T, m) →
    the seven derivative arrays with a leading batch axis."""
    out = derivs_packed(model, integrator, pp, lane_last(xs), lane_last(us),
                        mode, eps)
    return tuple(batch_first(a) for a in out)
