"""Closed-loop rollout and the batched line search, batch-major
(counterpart of ``ilqr_tpu/ops/rollout.py``; ref src/ilqr_core.cpp:184-226,
305-337).

``cfg.rollout_kernel`` picks the route: ``"auto"``/``"pallas"`` run the
rollout op (ops/kernel_rollout.py ``rollout_batched`` — its CUDA kernel on
the card, its plain version on the CPU); ``"xla"`` runs the JAX package's
scan with the per-problem model functions, which a model without SoA
functions takes on ``"auto"`` (``"pallas"`` raises for it). The line
search evaluates all α-candidates as one rollout with the α axis folded
into the lanes — candidate (b, a) at lane b·A + a, per-problem params row
b tiled A times — and picks the first accepted α per problem, exactly like
the reference's serial backtracking order.

``clamp_forward=False`` reproduces the reference's unclamped rollout
(ilqr_core.cpp:322-329); ``True`` clamps the controls to the box.
"""

from __future__ import annotations

import torch
from torch.func import vmap

from ilqr_tpu_torch.config import SolverConfig
from ilqr_tpu_torch.models.base import Model, get_integrator
from ilqr_tpu_torch.ops.derivatives import stage_route
from ilqr_tpu_torch.ops.kernel_rollout import (
    F32,
    PackedParams,
    _sign,
    is_batched,
    rollout_batched,
    unpack_params,
)
from ilqr_tpu_torch.types import LineSearchResult


def _rollout_scan(model: Model, pp: PackedParams, cfg: SolverConfig, x0,
                  u_ff, xs_ref, K):
    """The JAX package's scan rollout, a loop over T over the batch."""
    p, dt = unpack_params(pp)
    integ = get_integrator(cfg.integrator)
    cost = vmap(lambda x, u: model.cost(p, x, u))
    step = vmap(lambda x, u: integ(model, p, x, u, dt))
    T = u_ff.shape[1]
    x, xs, us, costs = x0, [x0], [], []
    for t in range(T):
        u = u_ff[:, t] + (K[:, t] @ (x - xs_ref[:, t])[..., None])[..., 0]
        if cfg.clamp_forward:
            u = torch.minimum(p.u_max, torch.maximum(u, p.u_min))
        costs.append(cost(x, u))
        x = step(x, u)
        xs.append(x)
        us.append(u)
    total = torch.stack(costs, 1).sum(1) + vmap(
        lambda xx: model.final_cost(p, xx))(x)
    return torch.stack(xs, 1), torch.stack(us, 1), total


def rollout(model: Model, pp: PackedParams, cfg: SolverConfig, x0, u_ff,
            xs_ref, K):
    """Closed-loop rollout u_t = u_ff,t + K_t (x_t − x̄_t) (ref :314-332):
    x0 (B, n), u_ff (B, T, m), xs_ref (B, T+1, n), K (B, T, m, n) →
    (xs (B, T+1, n), us (B, T, m) as applied, total cost (B,))."""
    if stage_route(model, cfg.rollout_kernel, "rollout_kernel") == "xla":
        return _rollout_scan(model, pp, cfg, x0, u_ff, xs_ref, K)
    return rollout_batched(model, cfg.integrator, cfg.clamp_forward, pp, x0,
                           u_ff, xs_ref, K)


def open_loop_rollout(model: Model, pp: PackedParams, cfg: SolverConfig, x0,
                      us):
    """Initial rollout with no feedback (ref init_traj, ilqr_core.cpp:20)."""
    B, T, m = us.shape
    n = x0.shape[-1]
    zeros = lambda *s: torch.zeros(s, dtype=F32, device=x0.device)
    return rollout(model, pp, cfg, x0, us, zeros(B, T + 1, n),
                   zeros(B, T, m, n))


def line_search(model: Model, pp: PackedParams, cfg: SolverConfig, x0, xs,
                us, k, K, dV, cost_s) -> LineSearchResult:
    """All-α batched line search (ref :184-226): z = dcost/expected > z_min
    with expected = −α(dV₀+α·dV₁), z = sign(dcost) where expected ≤ 0; the
    first (largest-α) accepted candidate wins.

    x0 (B, n), xs (B, T+1, n), us/k (B, T, m), K (B, T, m, n), dV (B, 2),
    cost_s (B,)."""
    B, T, m = us.shape
    alphas = torch.tensor([float(a) for a in cfg.alphas], dtype=F32,
                          device=us.device)
    A = alphas.shape[0]

    def tile(a):
        return a[:, None].expand((B, A) + tuple(a.shape[1:])).reshape(
            (B * A,) + tuple(a.shape[1:]))

    u_ff = us[:, None] + alphas[None, :, None, None] * k[:, None]
    if is_batched(pp):   # lane b·A + a reads problem b's row
        pp = pp._replace(vec=pp.vec.repeat_interleave(A, dim=0))
    xs_c, us_c, costs = rollout(model, pp, cfg, tile(x0),
                                u_ff.reshape((B * A, T, m)), tile(xs),
                                tile(K))
    costs = costs.reshape(B, A)
    dcost = cost_s[:, None] - costs
    expected = -alphas[None, :] * (dV[:, 0:1] + alphas[None, :] * dV[:, 1:2])
    z = torch.where(expected > 0, dcost / expected, _sign(dcost))
    accept = z > cfg.z_min
    accepted = accept.any(dim=1)
    idx = accept.to(torch.int32).argmax(dim=1)   # the first accepted α
    lanes = torch.arange(B, device=us.device)
    pick = lambda a: a[lanes, idx]
    rows = lanes * A + idx
    return LineSearchResult(
        xs=xs_c[rows], us=us_c[rows], cost=pick(costs), dcost=pick(dcost),
        expected=pick(expected), z=pick(z),
        alpha=torch.where(accepted, alphas[idx],
                          torch.zeros((), dtype=F32, device=us.device)),
        accepted=accepted)
