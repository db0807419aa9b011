"""Batched linearization of the dynamics and quadratization of the cost
(counterpart of ``ilqr_tpu/ops/derivatives.py``), batch-major: xs
(B, T+1, n), us (B, T, m) → :class:`Derivs`.

:func:`compute_derivs` dispatches by ``cfg.deriv_kernel``: ``"auto"`` and
``"pallas"`` run the derivative op (ops/kernel_derivs.py) — its CUDA kernel
on the card, its plain version on the CPU — for every model with SoA
functions (a model without them takes ``"xla"`` on ``"auto"``, as the JAX
package's ``_use_fused_derivs`` does, and raises on ``"pallas"``), with the
Euler or RK4 step and shared or per-lane params, in ``"jvp"`` mode for
``deriv_mode="analytic"`` and in ``"fd"`` mode with ``cfg.fd_eps`` for
``"fd"``. The JAX package's ``"auto"`` takes its XLA route above
``MAX_STAGE_KERNEL_M`` = 8 on the TPU (ilqr_tpu/ops/rollout.py:59), a cap
that fences off an XLA:TPU worker fault; the H100 has shown no such fault,
so the port has no cap (ROADMAP.md §A5). ``"xla"`` runs the JAX package's
non-kernel counterparts (shared params only):

- :func:`analytic_derivs`: ``torch.func`` Jacobians and Hessians of the
  model's step and cost (the per-problem functions, vmapped);
- :func:`fd_derivs`: the reference's central stencils with eps
  (finite_diff.h:22-86, derivatives.cpp:129-143).

Row T of cx/cxx is the final cost's (ref derivatives.cpp:48-49, 92).
"""

from __future__ import annotations

import torch
from torch.func import grad, hessian, jacfwd, jvp, vmap

from ilqr_tpu_torch.config import SolverConfig
from ilqr_tpu_torch.models.base import Model, get_integrator
from ilqr_tpu_torch.ops.kernel_derivs import derivs_batched
from ilqr_tpu_torch.ops.kernel_rollout import F32, PackedParams, unpack_params
from ilqr_tpu_torch.types import Derivs


def _flat(a, lead):
    """Merges the first ``lead`` axes into one."""
    return a.reshape((-1,) + tuple(a.shape[lead:]))


def _fns(model, pp, cfg):
    p, dt = unpack_params(pp)
    integ = get_integrator(cfg.integrator)
    step = lambda x, u: integ(model, p, x, u, dt)
    cost = lambda x, u: model.cost(p, x, u)
    final = lambda x: model.final_cost(p, x)
    return step, cost, final


def _jac_fwd(f, args, argnum):
    """Forward-mode Jacobian of the per-problem ``f`` with respect to
    ``args[argnum]`` over a batch: one jvp of ``vmap(f)`` per input
    direction (``vmap(jacfwd(f))`` through ``torch.linalg.solve`` gives
    wrong tangents in torch 2.13 for batches above one)."""
    z = args[argnum]
    cols = []
    for i in range(z.shape[-1]):
        tangents = tuple(torch.zeros_like(a) for a in args)
        tangents[argnum][:, i] = 1.0
        cols.append(jvp(vmap(f), args, tangents)[1])
    return torch.stack(cols, dim=-1)


def analytic_derivs(model: Model, pp: PackedParams, cfg: SolverConfig, xs,
                    us) -> Derivs:
    """Exact derivatives by ``torch.func``: forward-mode Jacobians of the
    step, grad and jacfwd-of-grad of the cost, grad and hessian of the
    final cost."""
    step, cost, final = _fns(model, pp, cfg)
    B, T1, n = xs.shape
    x, u = _flat(xs[:, :-1], 2), _flat(us, 2)
    shape = lambda a: a.reshape((B, T1 - 1) + tuple(a.shape[1:]))
    fx = _jac_fwd(step, (x, u), 0)
    fu = _jac_fwd(step, (x, u), 1)
    cx = vmap(grad(cost, argnums=0))(x, u)
    cu = vmap(grad(cost, argnums=1))(x, u)
    cxx = vmap(jacfwd(grad(cost, argnums=0), argnums=0))(x, u)
    cxu = vmap(jacfwd(grad(cost, argnums=0), argnums=1))(x, u)
    cuu = vmap(jacfwd(grad(cost, argnums=1), argnums=1))(x, u)
    cx_T = vmap(grad(final))(xs[:, -1])
    cxx_T = vmap(hessian(final))(xs[:, -1])
    return Derivs(
        fx=shape(fx), fu=shape(fu),
        cx=torch.cat([shape(cx), cx_T[:, None]], dim=1), cu=shape(cu),
        cxx=torch.cat([shape(cxx), cxx_T[:, None]], dim=1),
        cxu=shape(cxu), cuu=shape(cuu))


def _on(f, lead):
    """``f`` applied over ``lead`` leading axes of every argument."""
    def g(*args):
        n = args[0].shape[:lead]
        out = vmap(f)(*[_flat(a, lead) for a in args])
        return out.reshape(tuple(n) + tuple(out.shape[1:]))
    return g


def _fd_jacobian(f, z, eps, den1):
    """Central-difference Jacobian (finite_diff.h:35-47): f maps (N, P, d)
    probes → (N, P, out); returns (N, out, d)."""
    probes = eps * torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)
    fp = f(z[:, None, :] + probes[None])
    fm = f(z[:, None, :] - probes[None])
    return ((fp - fm) / den1).transpose(1, 2)


def _fd_gradient(f, z, eps, den1):
    """Central-difference gradient (finite_diff.h:22-33): f maps (N, P, d)
    probes → (N, P); returns (N, d)."""
    probes = eps * torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)
    return (f(z[:, None, :] + probes[None])
            - f(z[:, None, :] - probes[None])) / den1


def _fd_hessian(f, z, eps, den2):
    """4-point-stencil Hessian over the full (i, j) grid
    (finite_diff.h:67-86): f maps (N, d, d, dim) → (N, d, d)."""
    e = eps * torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)
    ei, ej = e[None, :, None, :], e[None, None, :, :]
    base = z[:, None, None, :]
    fpp = f(base + ei + ej)
    fpm = f(base + ei - ej)
    fmp = f(base - ei + ej)
    fmm = f(base - ei - ej)
    return (fpp - fmp - fpm + fmm) / den2


def fd_derivs(model: Model, pp: PackedParams, cfg: SolverConfig, xs,
              us) -> Derivs:
    """The reference's central differences (2-point gradients and
    Jacobians, 4-point Hessians, cross-Hessian in (x_i, u_j)) with
    ``cfg.fd_eps``."""
    step, cost, final = _fns(model, pp, cfg)
    eps = cfg.fd_eps
    dev = xs.device
    den1 = torch.tensor(2.0 * eps, dtype=F32, device=dev)
    den2 = torch.tensor(4.0 * eps * eps, dtype=F32, device=dev)
    B, T1, n = xs.shape
    m = us.shape[-1]
    x, u = _flat(xs[:, :-1], 2), _flat(us, 2)            # (N, n), (N, m)
    N = x.shape[0]
    shape = lambda a: a.reshape((B, T1 - 1) + tuple(a.shape[1:]))

    def with_u(f, k):   # f(probe_x, u_t) over k probe axes
        return lambda zx: _on(f, 1 + k)(
            zx, u.reshape((N,) + (1,) * k + (m,)).expand(
                zx.shape[:-1] + (m,)))

    def with_x(f, k):   # f(x_t, probe_u) over k probe axes
        return lambda zu: _on(f, 1 + k)(
            x.reshape((N,) + (1,) * k + (n,)).expand(
                zu.shape[:-1] + (n,)), zu)

    fx = _fd_jacobian(with_u(step, 1), x, eps, den1)
    fu = _fd_jacobian(with_x(step, 1), u, eps, den1)
    cx = _fd_gradient(with_u(cost, 1), x, eps, den1)
    cu = _fd_gradient(with_x(cost, 1), u, eps, den1)
    cxx = _fd_hessian(with_u(cost, 2), x, eps, den2)
    cuu = _fd_hessian(with_x(cost, 2), u, eps, den2)

    # cross-Hessian, 4-point in (x_i, u_j) (derivatives.cpp:129-143)
    ex = (eps * torch.eye(n, dtype=F32, device=dev))[None, :, None, :]
    eu = (eps * torch.eye(m, dtype=F32, device=dev))[None, None, :, :]
    xb, ub = x[:, None, None, :], u[:, None, None, :]

    def c_at(sx, su):
        xq = (xb + sx * ex).expand(N, n, m, n)
        uq = (ub + su * eu).expand(N, n, m, m)
        return _on(cost, 3)(xq, uq)

    cxu = (c_at(1, 1) - c_at(-1, 1) - c_at(1, -1) + c_at(-1, -1)) / den2

    xT = xs[:, -1]
    cx_T = _fd_gradient(_on(final, 2), xT, eps, den1)
    cxx_T = _fd_hessian(_on(final, 3), xT, eps, den2)
    return Derivs(
        fx=shape(fx), fu=shape(fu),
        cx=torch.cat([shape(cx), cx_T[:, None]], dim=1), cu=shape(cu),
        cxx=torch.cat([shape(cxx), cxx_T[:, None]], dim=1),
        cxu=shape(cxu), cuu=shape(cuu))


def stage_route(model: Model, route: str, field: str) -> str:
    """The route a stage takes by its config ``field`` = ``route``: "xla"
    when asked, or on "auto" for a model without SoA functions; the kernel
    op ("pallas") otherwise. "pallas" on a model without SoA functions
    raises ValueError naming the missing ones."""
    missing = [f for f in ("dynamics_soa", "cost_soa", "final_cost_soa")
               if getattr(model, f) is None]
    if route == "pallas" and missing:
        raise ValueError(
            f"{field}='pallas' runs the kernels, which take a model's SoA "
            f"functions; model {model.name!r} lacks {', '.join(missing)} "
            f"(use {field}='auto' or 'xla')")
    return "xla" if route == "xla" or missing else "pallas"


def compute_derivs(model: Model, pp: PackedParams, cfg: SolverConfig, xs,
                   us) -> Derivs:
    """Derivatives along (xs, us), dispatched by ``cfg.deriv_kernel`` (see
    the module docstring)."""
    if cfg.deriv_mode not in ("analytic", "fd"):
        raise ValueError(f"unknown deriv_mode {cfg.deriv_mode!r}")
    if stage_route(model, cfg.deriv_kernel, "deriv_kernel") == "xla":
        impl = analytic_derivs if cfg.deriv_mode == "analytic" else fd_derivs
        return impl(model, pp, cfg, xs, us)
    mode = "jvp" if cfg.deriv_mode == "analytic" else "fd"
    return Derivs(*derivs_batched(model, cfg.integrator, pp, xs, us, mode,
                                  cfg.fd_eps))
