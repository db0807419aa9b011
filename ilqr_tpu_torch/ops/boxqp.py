"""Box-constrained QPs of the backward pass, batched over a leading lane
axis (counterpart of ``ilqr_tpu/ops/boxqp.py``; ref src/boxqp.cpp).

Minimize ½xᵀQx + xᵀc s.t. lower ≤ x ≤ upper, for every lane at once:
Q (B, m, m), c (B, m), lower/upper broadcastable to (B, m).

- :func:`boxqp`: the reference's iterative projected Newton
  (ref boxqp.cpp:26-139) with its quirks (the initial value without the
  ½, the break order s_improve → all clamped → not PD → small gradient →
  line search failed, the state left at each break as the reference
  leaves it, the f32 floor of the relative-improvement tolerance). The
  JAX package runs it as a vmapped ``while_loop``: every lane iterates
  until the last one stops, and a stopped lane is frozen. Here the loop
  runs on the host while any lane is live, with a finished lane frozen,
  which gives each lane the same iterates; "any live" is read once per
  QP iteration (:func:`host_any`). The Armijo backtracking inside an
  iteration evaluates all its candidate steps at once (the f32 step
  sequence 1, 0.6, 0.36, … down to ``min_step``) and takes, per lane,
  the first at which the reference's loop stops — the same candidate,
  with no host sync.
- :func:`boxqp_enum`: exact active-set enumeration for m ≤ 4, all 3^m
  candidates as one batch axis.
- :func:`boxqp_pn`: the fixed-shape projected Newton (m + 6 iterations).

These are plain PyTorch on either device, as the JAX package's are XLA
code: no Pallas kernel computes them. The m ≤ 4 f32 factorizations are the
unrolled Cholesky of the JAX package (``_use_unrolled``); above, the
factor is LAPACK's (``torch.linalg.cholesky_ex``) of the symmetrized input,
as ``jnp.linalg.cholesky`` takes it, with a failed factorization returned
as NaN, as JAX returns it, where ``torch.linalg.cholesky`` would raise.

Status codes (ref boxqp.cpp; "higher is better", < 1 failure): −1 non-PD
free-subspace Hessian, 0 no convergence in max_iter, 2 internal line
search failed, 4 relative improvement < tol, 5 free-gradient norm < tol,
6 all dimensions clamped.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from ilqr_tpu_torch.config import BoxQPConfig
from ilqr_tpu_torch.ops.kernel_rollout import F32, clip
from ilqr_tpu_torch.types import BoxQPResult


def host_any(flags: torch.Tensor) -> bool:
    """``flags.any()`` read on the host: the composable solver's syncs
    (its outer loop, its λ retries and the iterative QP's loop), counted
    in ``host_any.syncs``."""
    host_any.syncs += 1
    return bool(flags.any().item())


host_any.syncs = 0


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _dot(a, b):
    return (a * b).sum(-1)


def clamp_to_limits(x, lower, upper):
    """(ref: include/boxqp.h:48-51)"""
    return torch.minimum(upper, torch.maximum(x, lower))


def quad_cost(Q, c, x):
    """½xᵀQx + x·c per lane (ref: include/boxqp.h:53-55)."""
    return _dot(0.5 * x, _mv(Q, x)) + _dot(x, c)


def _chol_small(Q):
    """Unrolled Cholesky–Banachiewicz of the JAX package for m ≤ 4: a
    non-positive pivot gives NaN, which poisons the entries that depend on
    it. Column by column, each column's entries at once: entry (i, j) is
    Q[i, j] − L[i, 0]·L[j, 0] − … − L[i, j−1]·L[j, j−1] in that order, then
    the pivot's square root or the division by it, as JAX's scalar loop
    computes it."""
    m = Q.shape[-1]
    cols = []                                   # cols[k]: L[k:, k]
    for j in range(m):
        s = Q[..., j:, j]
        for k in range(j):
            s = s - cols[k][..., j - k:] * cols[k][..., j - k:j - k + 1]
        d = torch.sqrt(torch.where(s[..., :1] > 0, s[..., :1],
                                   float("nan")))
        cols.append(torch.cat([d, s[..., 1:] / d], dim=-1))
    zero = torch.zeros_like(cols[0][..., :1])
    return torch.stack([torch.cat([zero.expand(*zero.shape[:-1], j), c],
                                  dim=-1) for j, c in enumerate(cols)],
                       dim=-1)


def _cho_solve_small(chol_lower, b):
    """Unrolled forward and back substitution solving L Lᵀ x = b (m ≤ 4);
    ``chol_lower`` (…, m, m) broadcasts against b (…, m). The forward pass
    subtracts each solved y_k from all later rows at once, which keeps
    JAX's per-entry order (k ascending)."""
    m = b.shape[-1]
    y, rest = [], b
    for i in range(m):
        y.append(rest[..., 0] / chol_lower[..., i, i])
        rest = rest[..., 1:] - chol_lower[..., i + 1:, i] * y[i][..., None]
    x = [None] * m
    for i in reversed(range(m)):
        s = y[i]
        for k in range(i + 1, m):
            s = s - chol_lower[..., k, i] * x[k]
        x[i] = s / chol_lower[..., i, i]
    return torch.stack(x, dim=-1)


_UNROLL_MAX = 4


def _use_unrolled(dtype, size) -> bool:
    return size <= _UNROLL_MAX and dtype == F32


def cholesky(P):
    """``jnp.linalg.cholesky``: the lower factor of the symmetrized input,
    NaN on the lower triangle where the factorization fails."""
    L, info = torch.linalg.cholesky_ex((P + P.mT) / 2)
    nan = torch.full_like(L, float("nan")).tril()
    return torch.where((info != 0)[..., None, None], nan, L)


def cho_solve(chol_lower, b):
    """``jax.scipy.linalg.cho_solve((L, True), b)`` for b (…, m), the
    factor broadcast against it."""
    shape = torch.broadcast_shapes(chol_lower.shape[:-2], b.shape[:-1])
    m = b.shape[-1]
    return torch.cholesky_solve(
        b.expand(shape + (m,))[..., None],
        chol_lower.expand(shape + (m, m)))[..., 0]


def _eye(m, like):
    return torch.eye(m, dtype=like.dtype, device=like.device)


def masked_cholesky(Q, free):
    """Lower Cholesky factor of Q restricted to the ``free`` dims, identity
    on the clamped ones (ref boxqp.cpp:80-90); NaN entries signal a non-PD
    free block."""
    m = Q.shape[-1]
    qf = torch.where(free[..., :, None] & free[..., None, :], Q, _eye(m, Q))
    if _use_unrolled(Q.dtype, m):
        return _chol_small(qf)
    return cholesky(qf)


def free_solve(chol_lower, b, free, unrolled=None):
    """Solves Q_free z = b on the free subspace, zero on clamped dims.
    ``unrolled=None`` takes the unrolled substitution for f32 m ≤ 4."""
    if unrolled is None:
        unrolled = _use_unrolled(b.dtype, b.shape[-1])
    bm = torch.where(free, b, torch.zeros_like(b))
    z = _cho_solve_small(chol_lower, bm) if unrolled else cho_solve(
        chol_lower, bm)
    return torch.where(free, z, torch.zeros_like(z))


@functools.lru_cache(maxsize=None)
def _steps(step_dec: float, min_step: float, device):
    """The line search's f32 steps 1, step·dec, … up to the first below
    ``min_step``, where the reference's loop fails at the latest, and
    whether each step fails (below ``min_step``; never the first)."""
    dec, low = np.float32(step_dec), np.float32(min_step)
    out = [np.float32(1.0)]
    while not out[-1] < low:
        out.append(np.float32(out[-1] * dec))
    steps = np.array(out, np.float32)
    fails = steps < low
    fails[0] = False
    return (torch.as_tensor(steps, device=device),
            torch.as_tensor(fails, device=device))


def quadclamp_line_search(x0, search, Q, c, lower, upper, cfg: BoxQPConfig):
    """Armijo backtracking with clamping (ref: src/boxqp.cpp:143-178), per
    lane: (x_opt (B, m), v_opt (B,), failed (B,), n_steps (B,) int32).
    Every step of the reference's loop is evaluated at once, and each lane
    takes the first at which that loop stops; on a non-descent direction
    it stops at once with failed set."""
    steps, fails = _steps(cfg.step_dec, cfg.min_step, x0.device)
    J = steps.shape[0]
    grad = _mv(Q, x0) + c
    slope = _dot(search, grad)
    bad_direction = slope >= 0
    old_v = quad_cost(Q, c, x0)
    s = steps.reshape((J,) + (1,) * x0.ndim)
    xc = clamp_to_limits(x0 + s * search, lower, upper)      # (J, B, m)
    v = quad_cost(Q, c, xc)                                   # (J, B)
    ratio = (v - old_v) / (steps[:, None] * slope)
    # the loop stops at the first step that fails or passes Armijo; the
    # first one also fails on a non-descent direction
    stop = ~(ratio < cfg.armijo) | fails[:, None]
    stop[0] |= bad_direction
    n = stop.to(torch.int32).argmax(dim=0)
    lanes = torch.arange(n.shape[0], device=n.device)
    return (xc[n, lanes], v[n, lanes], fails[n] | bad_direction,
            n.to(torch.int32))


@functools.lru_cache(maxsize=None)
def _break_codes(device) -> torch.Tensor:
    """The status of the first break that holds, in the reference's
    statement order: s_improve, all clamped, not PD, small gradient, line
    search failed, and none (0: go on)."""
    return torch.tensor((4, 6, -1, 5, 2, 0), dtype=torch.int32,
                        device=device)


def boxqp(Q, c, x0, lower, upper, cfg: BoxQPConfig = BoxQPConfig()
          ) -> BoxQPResult:
    """The reference's projected-Newton box QP (ref: src/boxqp.cpp:26-139)
    warm-started from x0 (B, m), batched (see the module docstring)."""
    B, m = x0.shape
    dev = x0.device
    lower = lower.expand(B, m)
    upper = upper.expand(B, m)
    codes = _break_codes(dev)
    zeros = torch.zeros_like(x0)
    go_on = torch.ones((B,), dtype=torch.bool, device=dev)
    x = clamp_to_limits(x0, lower, upper)
    # reference quirk: the initial value has no ½ (boxqp.cpp:36)
    val = _dot(x, _mv(Q, x)) + _dot(x, c)
    # the reference's tolerance assumes f64; floored at ~10 ulp in f32
    rel_improve_tol = max(cfg.min_rel_improve,
                          10.0 * float(torch.finfo(x0.dtype).eps))
    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    oldval = torch.zeros_like(val)
    clamped = torch.zeros((B, m), dtype=torch.bool, device=dev)
    chol = _eye(m, x0).expand(B, m, m)
    status = torch.zeros_like(it)
    live = go_on
    while True:
        boxqp.iterations += 1
        # break 1: stopped improving (ref :54-57; not on the first pass)
        s_improve = (it > 0) & ((oldval - val)
                                < rel_improve_tol * oldval.abs())
        grad = _mv(Q, x) + c
        # active set (ref :61-71)
        new_clamped = ((((x - lower).abs() < cfg.clamp_tol) & (grad > 0))
                       | (((x - upper).abs() < cfg.clamp_tol) & (grad < 0)))
        free = ~new_clamped
        # break 2: everything clamped (ref :74-77), before the factor
        s_all_clamped = new_clamped.all(dim=-1)
        chol_new = masked_cholesky(Q, free)
        s_not_pd = torch.isnan(chol_new).any(dim=(-2, -1))
        # break 3: free-subspace gradient small (ref :92-97)
        gf = torch.where(free, grad, zeros)
        s_small_grad = torch.sqrt(_dot(gf, gf)) < cfg.min_grad
        # Newton step on the free dims (ref :99-119)
        grad_clamped = _mv(Q, torch.where(new_clamped, x, zeros)) + c
        search = torch.where(
            free, -free_solve(chol_new, grad_clamped, free) - x, zeros)
        xc, v, ls_failed, _n = quadclamp_line_search(
            x, search, Q, c, lower, upper, cfg)
        st = codes[torch.stack([s_improve, s_all_clamped, s_not_pd,
                                s_small_grad, ls_failed, go_on], dim=-1)
                   .to(torch.int32).argmax(dim=-1)]
        # the state as the reference leaves it at each break, on the
        # lanes still live: below s_improve nothing ran; the factor is
        # not updated when everything is clamped; x and val move only on
        # a step
        moved = live & ~s_improve
        step = live & (st == 0)
        oldval = torch.where(moved, val, oldval)
        val = torch.where(step, v, val)
        x = torch.where(step[:, None], xc, x)
        clamped = torch.where(moved[:, None], new_clamped, clamped)
        chol = torch.where((moved & ~s_all_clamped)[:, None, None],
                           chol_new, chol)
        status = torch.where(live, st, status)
        it = it + live.to(torch.int32)
        live = (status == 0) & (it <= cfg.max_iter)
        if not host_any(live):
            break
    return BoxQPResult(x=x, status=status, free=~clamped, chol_free=chol,
                       n_iters=it)


boxqp.iterations = 0   # passes of the host loop


@functools.lru_cache(maxsize=None)
def _active_sets(m, dtype, device):
    """The 3^m active sets: free (C, 1, m) bool and the side (C, 1, m) of
    each clamped dim (−1 lower, +1 upper, 0 free)."""
    combos = list(itertools.product((0, 1, 2), repeat=m))
    free = torch.tensor([[s == 1 for s in cb] for cb in combos],
                        device=device)[:, None]
    side = torch.tensor([[0.0 if s == 1 else (-1.0 if s == 0 else 1.0)
                          for s in cb] for cb in combos], dtype=dtype,
                        device=device)[:, None]
    return free, side


def boxqp_enum(Q, c, lower, upper) -> BoxQPResult:
    """Exact box QP by active-set enumeration for m ≤ 4: each of the 3^m
    active sets (each dim at lower / free / at upper) solved in closed
    form on its free block, the valid KKT point of least value kept (the
    first on ties, as the JAX loop keeps it). Status 5, or −1 for a
    non-PD Hessian or no valid candidate."""
    B, m = c.shape
    assert m <= 4, "active-set enumeration is for m <= 4 (3^m candidates)"
    dev, dtype = c.device, c.dtype
    free, side = _active_sets(m, dtype, dev)                 # (C, 1, m)
    lower = lower.expand(B, m)
    upper = upper.expand(B, m)
    big = torch.finfo(dtype).max / 8
    not_pd = torch.isnan(masked_cholesky(
        Q, torch.ones((B, m), dtype=torch.bool, device=dev))).any(
            dim=(-2, -1))
    xc = torch.where(side < 0, lower,
                     torch.where(side > 0, upper, torch.zeros_like(lower)))
    chol = masked_cholesky(Q, free)                          # (C, B, m, m)
    rhs = -(c + _mv(Q, torch.where(free, torch.zeros_like(xc), xc)))
    xf = free_solve(chol, torch.where(free, rhs, torch.zeros_like(rhs)),
                    free)
    x = torch.where(free, xf, xc)                            # (C, B, m)
    g = _mv(Q, x) + c
    primal_ok = torch.where(free, (x >= lower) & (x <= upper),
                            torch.ones_like(free)).all(dim=-1)
    dual_ok = torch.where(free, torch.ones_like(free),
                          torch.where(side < 0, g >= 0, g <= 0)).all(dim=-1)
    valid = primal_ok & dual_ok & ~torch.isnan(x).any(dim=-1)
    val = quad_cost(Q, c, x)                                 # (C, B)
    key = torch.where(valid & (val < big), val,
                      torch.full_like(val, float("inf")))
    best = key.argmin(dim=0)                                 # first least
    lanes = torch.arange(B, device=dev)
    taken = torch.isfinite(key[best, lanes])
    best_x = torch.where(taken[:, None], x[best, lanes], torch.zeros_like(c))
    best_free = taken[:, None] & free[best, 0]
    status = torch.where(not_pd | ~valid.any(dim=0), -1, 5).to(torch.int32)
    return BoxQPResult(
        x=best_x, status=status, free=best_free,
        chol_free=masked_cholesky(Q, best_free),
        n_iters=torch.ones((B,), dtype=torch.int32, device=dev))


def boxqp_pn(Q, c, lower, upper) -> BoxQPResult:
    """The JAX package's fixed-shape projected Newton for any m
    (``boxqp_mode="pn_fixed"``): from clamp(−Q⁻¹c), m + 6 iterations of
    {KKT active set → masked-Cholesky free-subspace solve → best of the
    five clamped steps 1, ½, ¼, ⅛, 1/16, kept only if better}. Status 5,
    or −1 if the free-subspace Hessian lost positive definiteness at any
    iterate (the factor then replaced by the identity)."""
    B, m = c.shape
    eye = _eye(m, Q)
    one = torch.ones((), dtype=Q.dtype, device=Q.device)
    lower = lower.expand(B, m)
    upper = upper.expand(B, m)

    def masked(free_f):
        return (free_f[..., :, None] * free_f[..., None, :] * Q
                + torch.diag_embed(one - free_f))

    def chol_safe(P):
        L = cholesky(P)
        bad = torch.isnan(L).any(dim=(-2, -1))
        return torch.where(bad[:, None, None], eye, L), bad

    L, bad = chol_safe(Q)
    x = clip(cho_solve(L, -c), lower, upper)
    v = quad_cost(Q, c, x)
    for _ in range(m + 6):
        g = _mv(Q, x) + c
        cl = ((x <= lower) & (g > 0)) | ((x >= upper) & (g < 0))
        free_f = torch.where(cl, torch.zeros_like(x), torch.ones_like(x))
        L_it, bad_it = chol_safe(masked(free_f))
        bad = bad | bad_it
        rhs = free_f * (c + _mv(Q, (one - free_f) * x))
        d = cho_solve(L_it, rhs)
        xn = free_f * (-d) + (one - free_f) * x
        best, v_best = x, v
        for step in (1.0, 0.5, 0.25, 0.125, 0.0625):
            cand = clip(x + step * (xn - x), lower, upper)
            vc = quad_cost(Q, c, cand)
            take = vc < v_best
            best = torch.where(take[:, None], cand, best)
            v_best = torch.where(take, vc, v_best)
        x, v = best, v_best
    g = _mv(Q, x) + c
    cl = ((x <= lower) & (g > 0)) | ((x >= upper) & (g < 0))
    free = ~cl & ~bad[:, None]
    x = torch.where(bad[:, None], torch.zeros_like(x), x)
    free_f = torch.where(free, torch.ones_like(x), torch.zeros_like(x))
    chol, _ = chol_safe(masked(free_f))
    return BoxQPResult(
        x=x, status=torch.where(bad, -1, 5).to(torch.int32), free=free,
        chol_free=chol,
        n_iters=torch.full((B,), m + 6, dtype=torch.int32, device=c.device))
