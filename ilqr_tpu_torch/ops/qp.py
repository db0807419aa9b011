"""The merged sweep's per-lane box QPs and the unconstrained Newton step,
plain PyTorch (counterpart of the in-kernel QPs of
``ilqr_tpu/ops/pallas_sweep.py``: ``_qp_m1`` … ``_qp_m4``, ``_subdet``,
``_adj_det``, ``_chol_masked_tiles``, ``_chol_solve_tiles``, ``_qp_pn``,
``_qp_newton`` and ``_free_solve_rows``).

Every matrix is a nested list of per-lane tensors (``q[i][j]`` of shape
(B,)), every vector a list of them; the m > 4 helpers (``chol_masked``,
``chol_solve``) take them stacked, (m, m, …) and (m, …). Each function
repeats the JAX tile code's operations in its order, and csrc/qp.cuh
repeats them again for the CUDA kernels, so the plain versions and the
kernels agree bitwise where the trig does not enter.

- m = 1: closed form clamp(−Qu/QuuF);
- m = 2, 3, 4: exact active-set enumeration: all 3^m (lower/free/upper)
  candidate sets in ``itertools.product`` order, each solved in closed form
  and kept if it passes its KKT filter and its value is strictly below the
  best so far (ties go to the first candidate); at m = 4 the 15
  per-free-subset adjugates and reciprocal determinants are shared by the
  81 candidates;
- 5 ≤ m ≤ 24: projected Newton (ref src/boxqp.cpp:26-139, fixed shape):
  from the box-clamped Newton point, m + 6 iterations of KKT active set →
  masked Cholesky of the identity-padded free block → the clamped ladder
  of steps 1, ½, ¼, ⅛, 1/16, keeping the best candidate whose value is
  strictly below the current one;
- unconstrained: k = −QuuF⁻¹·Qu with a Sylvester PD check (m ≤ 4) or the
  pivots of the all-free Cholesky (m > 4).

The ``bad`` flag (QuuF not positive definite by its leading principal
minors, or a non-positive pivot on a free dim) zeroes k and marks the lane
diverged. The feedback rows come from the identity-padded free-subspace
inverse, zero on clamped controls (ref src/ilqr_core.cpp:377-385).

The m > 4 code is vectorized over the trailing index of each update (a
column of the Cholesky factor, the rows of the gradient, the five ladder
candidates, the n feedback columns), so each entry still sees exactly the
f32 operations of the JAX tile code, in its order, and the sums that JAX
accumulates in sequence (the objective, the substitutions) stay
sequential.

The reciprocal square root of a Cholesky pivot is the IEEE-rounded 1/√d
(a correctly rounded square root, then a division): ``1.0f / sqrtf(d)`` in
csrc/qp.cuh, and here ``_rsqrt``, which picks the PyTorch op that rounds so
on the tensor's device: ``1.0 / torch.sqrt(d)`` on the card (where
``torch.rsqrt`` is the approximate ``rsqrtf``), ``torch.rsqrt`` on the CPU
(where the f32 ``torch.sqrt`` is not correctly rounded: it differs from
the correctly rounded square root in 0.6% of 10⁵ uniform inputs in
[1e-3, 1e3], and ``torch.rsqrt`` matches the IEEE 1/√d on all of them;
tests/test_torch_qp_pn.py holds both facts). So the
plain version and the kernel agree bit for bit. The JAX tile code takes
``jax.lax.rsqrt``, which on XLA:CPU differs from the IEEE 1/√d in 29% of
f32 inputs by at most 2 ulp (10⁶ uniform inputs in [1e-3, 1e3]), so the
port matches the JAX package's projected Newton to a tolerance, not bit
for bit.
"""

from __future__ import annotations

import itertools

import torch

from ilqr_tpu_torch.ops.kernel_rollout import clip

# The widest in-kernel QP (ilqr_tpu/ops/pallas_sweep.py MAX_FUSED_M).
MAX_FUSED_M = 24
BIG = 3.0e38   # the enumeration's starting best value
PN_STEPS = (1.0, 0.5, 0.25, 0.125, 0.0625)   # the projected Newton's ladder


def _safe(d):
    """d where d > 0, else 1 (a non-positive pivot is flagged ``bad``)."""
    return torch.where(d <= 0.0, torch.ones_like(d), d)


def _pick(flag, val, like):
    """A 0/1 f32 carrier of the Python bool ``flag`` where ``val``."""
    return torch.where(val, torch.full_like(like, 1.0 * flag), like)


def qp_m1(quuF, qu, lo, hi):
    """Closed-form 1-D box QP. Returns (k, free, bad)."""
    q11 = quuF[0][0]
    g1 = qu[0]
    bad = q11 <= 0.0
    q_safe = torch.where(bad, torch.ones_like(q11), q11)
    x1 = clip(-g1 * (1.0 / q_safe), lo[0], hi[0])
    gk = q11 * x1 + g1
    clamped = (((x1 <= lo[0]) & (gk > 0.0))
               | ((x1 >= hi[0]) & (gk < 0.0)))
    k = [torch.where(bad, torch.zeros_like(x1), x1)]
    free = [~clamped & ~bad]
    return k, free, bad


def qp_m2(quuF, qu, lo, hi):
    """Exact 2-D box QP by active-set enumeration (9 candidates)."""
    a, b, c = quuF[0][0], quuF[0][1], quuF[1][1]
    g0, g1 = qu[0], qu[1]
    det = a * c - b * b
    bad = (a <= 0.0) | (det <= 0.0)
    rsa, rsc, rsdet = 1.0 / _safe(a), 1.0 / _safe(c), 1.0 / _safe(det)

    best_v = torch.full_like(a, BIG)
    best0 = torch.zeros_like(a)
    best1 = torch.zeros_like(a)
    bf0 = torch.zeros_like(a)
    bf1 = torch.zeros_like(a)
    for s0, s1 in itertools.product((0, 1, 2), repeat=2):
        f0, f1 = s0 == 1, s1 == 1
        x0c = lo[0] if s0 == 0 else hi[0]
        x1c = lo[1] if s1 == 0 else hi[1]
        if f0 and f1:
            x0 = (-g0 * c + g1 * b) * rsdet
            x1 = (-g1 * a + g0 * b) * rsdet
        elif f0:
            x1 = x1c
            x0 = -(g0 + b * x1) * rsa
        elif f1:
            x0 = x0c
            x1 = -(g1 + b * x0) * rsc
        else:
            x0, x1 = x0c, x1c
        gr0 = a * x0 + b * x1 + g0
        gr1 = b * x0 + c * x1 + g1
        ok = ((x0 >= lo[0]) & (x0 <= hi[0]) if f0
              else (gr0 >= 0.0 if s0 == 0 else gr0 <= 0.0))
        ok = ok & ((x1 >= lo[1]) & (x1 <= hi[1]) if f1
                   else (gr1 >= 0.0 if s1 == 0 else gr1 <= 0.0))
        v = (0.5 * (a * x0 * x0 + 2.0 * b * x0 * x1 + c * x1 * x1)
             + g0 * x0 + g1 * x1)
        take = ok & (v < best_v)
        best_v = torch.where(take, v, best_v)
        best0 = torch.where(take, x0, best0)
        best1 = torch.where(take, x1, best1)
        bf0 = _pick(f0, take, bf0)
        bf1 = _pick(f1, take, bf1)

    zero = torch.zeros_like(a)
    k = [torch.where(bad, zero, best0), torch.where(bad, zero, best1)]
    free = [(bf0 > 0.5) & ~bad, (bf1 > 0.5) & ~bad]
    return k, free, bad


def _adj3(a, b, c, dd, e, f):
    """Adjugate entries of the symmetric [[a, b, c], [b, dd, e],
    [c, e, f]] and its determinant, in the JAX kernel's expressions."""
    A00 = dd * f - e * e
    A01 = -(b * f - e * c)
    A02 = b * e - dd * c
    A11 = a * f - c * c
    A12 = -(a * e - b * c)
    A22 = a * dd - b * b
    det = a * A00 + b * A01 + c * A02
    return [[A00, A01, A02], [A01, A11, A12], [A02, A12, A22]], det


def qp_m3(quuF, qu, lo, hi):
    """Exact 3-D box QP by active-set enumeration (27 candidates)."""
    q, g = quuF, qu
    zero = torch.zeros_like(q[0][0])

    # Sylvester criterion on leading principal minors
    det2 = q[0][0] * q[1][1] - q[0][1] * q[0][1]
    det3 = (q[0][0] * (q[1][1] * q[2][2] - q[1][2] * q[1][2])
            - q[0][1] * (q[0][1] * q[2][2] - q[1][2] * q[0][2])
            + q[0][2] * (q[0][1] * q[1][2] - q[1][1] * q[0][2]))
    bad = (q[0][0] <= 0.0) | (det2 <= 0.0) | (det3 <= 0.0)

    best_v = torch.full_like(zero, BIG)
    best = [zero, zero, zero]
    bf = [zero, zero, zero]
    rq = [1.0 / _safe(q[i][i]) for i in range(3)]
    rpair = {(i, j): 1.0 / _safe(q[i][i] * q[j][j] - q[i][j] * q[i][j])
             for i in range(3) for j in range(i + 1, 3)}

    def value(x):
        v = zero
        for i in range(3):
            v = v + g[i] * x[i] + 0.5 * q[i][i] * x[i] * x[i]
        return (v + q[0][1] * x[0] * x[1] + q[0][2] * x[0] * x[2]
                + q[1][2] * x[1] * x[2])

    for combo in itertools.product((0, 1, 2), repeat=3):
        F = [i for i in range(3) if combo[i] == 1]
        xc = [lo[i] if combo[i] == 0 else hi[i] if combo[i] == 2 else None
              for i in range(3)]

        def rhs(i):
            acc = g[i]
            for j in range(3):
                if combo[j] != 1:
                    acc = acc + q[i][j] * xc[j]
            return acc

        x = list(xc)
        if len(F) == 1:
            i = F[0]
            x[i] = -rhs(i) * rq[i]
        elif len(F) == 2:
            i, j = F
            aa, bb, cc = q[i][i], q[i][j], q[j][j]
            rd = rpair[(i, j)]
            ri, rj = rhs(i), rhs(j)
            x[i] = (-ri * cc + rj * bb) * rd
            x[j] = (-rj * aa + ri * bb) * rd
        elif len(F) == 3:
            adj, det = _adj3(q[0][0], q[0][1], q[0][2], q[1][1], q[1][2],
                             q[2][2])
            rdet = 1.0 / _safe(det)
            for r in range(3):
                x[r] = -(adj[r][0] * g[0] + adj[r][1] * g[1]
                         + adj[r][2] * g[2]) * rdet

        ok = None
        for i in range(3):
            gr = g[i]
            for j in range(3):
                gr = gr + q[i][j] * x[j]
            if combo[i] == 1:
                c = (x[i] >= lo[i]) & (x[i] <= hi[i])
            elif combo[i] == 0:
                c = gr >= 0.0
            else:
                c = gr <= 0.0
            ok = c if ok is None else ok & c

        v = value(x)
        take = ok & (v < best_v)
        best_v = torch.where(take, v, best_v)
        for i in range(3):
            best[i] = torch.where(take, x[i], best[i])
            bf[i] = _pick(combo[i] == 1, take, bf[i])

    k = [torch.where(bad, zero, best[i]) for i in range(3)]
    free = [(bf[i] > 0.5) & ~bad for i in range(3)]
    return k, free, bad


def subdet(q, rows, cols):
    """Determinant of q[rows][cols] (static index tuples, len ≤ 4) by
    first-row cofactor expansion, fully unrolled."""
    if len(rows) == 1:
        return q[rows[0]][cols[0]]
    acc = None
    for jpos, cj in enumerate(cols):
        minor = subdet(q, rows[1:], cols[:jpos] + cols[jpos + 1:])
        term = q[rows[0]][cj] * minor
        if acc is None:
            acc = term
        elif jpos % 2 == 0:
            acc = acc + term
        else:
            acc = acc - term
    return acc


def adj_det(q, idx):
    """Adjugate (nested list over positions in ``idx``) and determinant of
    the symmetric q[idx][idx]; symmetry halves the cofactor count."""
    k = len(idx)
    if k == 1:
        return [[torch.ones_like(q[idx[0]][idx[0]])]], q[idx[0]][idx[0]]
    det = subdet(q, idx, idx)
    adj = [[None] * k for _ in range(k)]
    for a in range(k):
        for b in range(a, k):
            cof = subdet(q, idx[:b] + idx[b + 1:], idx[:a] + idx[a + 1:])
            if (a + b) % 2:
                cof = -cof
            adj[a][b] = adj[b][a] = cof
    return adj, det


def _sylvester_bad(q, m):
    """A leading principal minor of q is ≤ 0 (or q[0][0] is)."""
    bad = q[0][0] <= 0.0
    for k in range(2, m + 1):
        bad = bad | (subdet(q, tuple(range(k)), tuple(range(k))) <= 0.0)
    return bad


def qp_m4(quuF, qu, lo, hi):
    """Exact 4-D box QP by active-set enumeration (81 candidates), the
    free-subspace solves through 15 shared adjugates."""
    q, g = quuF, qu
    zero = torch.zeros_like(q[0][0])
    bad = _sylvester_bad(q, 4)

    sub = {}
    for k in range(1, 5):
        for idx in itertools.combinations(range(4), k):
            adj, det = adj_det(q, idx)
            sub[idx] = (adj, 1.0 / _safe(det))

    best_v = torch.full_like(zero, BIG)
    best = [zero] * 4
    bf = [zero] * 4
    for combo in itertools.product((0, 1, 2), repeat=4):
        F = tuple(i for i in range(4) if combo[i] == 1)
        xc = [lo[i] if combo[i] == 0 else hi[i] if combo[i] == 2 else None
              for i in range(4)]
        x = list(xc)
        if F:
            adj, rdet = sub[F]
            rhs = []
            for i in F:
                acc = g[i]
                for j in range(4):
                    if combo[j] != 1:
                        acc = acc + q[i][j] * xc[j]
                rhs.append(acc)
            for a, i in enumerate(F):
                s = adj[a][0] * rhs[0]
                for b in range(1, len(F)):
                    s = s + adj[a][b] * rhs[b]
                x[i] = -s * rdet

        ok = None
        for i in range(4):
            gr = g[i]
            for j in range(4):
                gr = gr + q[i][j] * x[j]
            if combo[i] == 1:
                c = (x[i] >= lo[i]) & (x[i] <= hi[i])
            elif combo[i] == 0:
                c = gr >= 0.0
            else:
                c = gr <= 0.0
            ok = c if ok is None else ok & c

        v = zero
        for i in range(4):
            v = v + g[i] * x[i] + 0.5 * q[i][i] * x[i] * x[i]
        for i in range(4):
            for j in range(i + 1, 4):
                v = v + q[i][j] * x[i] * x[j]

        take = ok & (v < best_v)
        best_v = torch.where(take, v, best_v)
        for i in range(4):
            best[i] = torch.where(take, x[i], best[i])
            bf[i] = _pick(combo[i] == 1, take, bf[i])

    k = [torch.where(bad, zero, best[i]) for i in range(4)]
    free = [(bf[i] > 0.5) & ~bad for i in range(4)]
    return k, free, bad


def qp_newton(quuF, qu, m):
    """Unconstrained regularized Newton step k = −QuuF⁻¹·Qu with a
    Sylvester PD check (ref src/ilqr_core.cpp:369 with no active limits).
    All dims free."""
    zero = torch.zeros_like(quuF[0][0])
    if m == 1:
        q11 = quuF[0][0]
        bad = q11 <= 0.0
        x = [-qu[0] / _safe(q11)]
    elif m == 2:
        a, b, c = quuF[0][0], quuF[0][1], quuF[1][1]
        det = a * c - b * b
        bad = (a <= 0.0) | (det <= 0.0)
        rsdet = 1.0 / _safe(det)
        x = [(-qu[0] * c + qu[1] * b) * rsdet,
             (-qu[1] * a + qu[0] * b) * rsdet]
    elif m == 3:
        a, b, c = quuF[0][0], quuF[0][1], quuF[0][2]
        dd, e, f = quuF[1][1], quuF[1][2], quuF[2][2]
        det2 = a * dd - b * b
        adj, det3 = _adj3(a, b, c, dd, e, f)
        bad = (a <= 0.0) | (det2 <= 0.0) | (det3 <= 0.0)
        rsdet = 1.0 / _safe(det3)
        x = [-(adj[j][0] * qu[0] + adj[j][1] * qu[1] + adj[j][2] * qu[2])
             * rsdet for j in range(3)]
    elif m == 4:
        bad = _sylvester_bad(quuF, 4)
        adj, det = adj_det(quuF, (0, 1, 2, 3))
        rsdet = 1.0 / _safe(det)
        x = []
        for j in range(4):
            s = adj[j][0] * qu[0]
            for i in range(1, 4):
                s = s + adj[j][i] * qu[i]
            x.append(-s * rsdet)
    elif m <= MAX_FUSED_M:
        # all-free masked Cholesky (its pivots are the PD check) + a solve
        Q = _stack(quuF)
        L, rdiag, bad = chol_masked(Q, torch.ones_like(Q[0]))
        x = list(chol_solve(L, rdiag, -torch.stack(qu)).unbind(0))
    else:
        raise ValueError(f"in-kernel Newton supports m <= {MAX_FUSED_M}")
    k = [torch.where(bad, zero, xi) for xi in x]
    return k, [~bad for _ in range(m)], bad


def _nonzero(d):
    return torch.where(d == 0.0, torch.ones_like(d), d)


def free_solve_rows(quuF, free, cols, m):
    """Rows of −(Q_free)⁻¹·cols with identity padding on clamped dims and
    zeroed clamped rows (ref ilqr_core.cpp:377-385). ``cols[j][i]`` =
    Qux[j, i]; returns the m × n nested list of K rows."""
    zero = torch.zeros_like(quuF[0][0])
    one = torch.ones_like(zero)
    n_cols = len(cols[0])
    if m == 1:
        q11 = quuF[0][0]
        rq = -(1.0 / torch.where(q11 <= 0.0, one, q11))
        return [[torch.where(free[0], cols[0][i] * rq, zero)
                 for i in range(n_cols)]]
    if m == 2:
        a, b, c = quuF[0][0], quuF[0][1], quuF[1][1]
        ap = torch.where(free[0], a, one)
        cp = torch.where(free[1], c, one)
        bp = torch.where(free[0] & free[1], b, zero)
        rdet = 1.0 / _nonzero(ap * cp - bp * bp)
        out = [[], []]
        for i in range(n_cols):
            v0, v1 = cols[0][i], cols[1][i]
            s0 = (cp * v0 - bp * v1) * rdet
            s1 = (ap * v1 - bp * v0) * rdet
            out[0].append(torch.where(free[0], -s0, zero))
            out[1].append(torch.where(free[1], -s1, zero))
        return out
    if m == 3:
        adj, det = _adj3(
            torch.where(free[0], quuF[0][0], one),
            torch.where(free[0] & free[1], quuF[0][1], zero),
            torch.where(free[0] & free[2], quuF[0][2], zero),
            torch.where(free[1], quuF[1][1], one),
            torch.where(free[1] & free[2], quuF[1][2], zero),
            torch.where(free[2], quuF[2][2], one))
        rdet = 1.0 / _nonzero(det)
        out = [[], [], []]
        for i in range(n_cols):
            v = [cols[0][i], cols[1][i], cols[2][i]]
            for j in range(3):
                s = (adj[j][0] * v[0] + adj[j][1] * v[1]
                     + adj[j][2] * v[2]) * rdet
                out[j].append(torch.where(free[j], -s, zero))
        return out
    if m == 4:
        P = [[None] * 4 for _ in range(4)]
        for i in range(4):
            P[i][i] = torch.where(free[i], quuF[i][i], one)
            for j in range(i + 1, 4):
                P[i][j] = P[j][i] = torch.where(free[i] & free[j],
                                                quuF[i][j], zero)
        adj, det = adj_det(P, (0, 1, 2, 3))
        rdet = 1.0 / _nonzero(det)
        out = [[], [], [], []]
        for i in range(n_cols):
            v = [cols[jm][i] for jm in range(4)]
            for j in range(4):
                s = adj[j][0] * v[0]
                for b in range(1, 4):
                    s = s + adj[j][b] * v[b]
                out[j].append(torch.where(free[j], -s * rdet, zero))
        return out
    if m > MAX_FUSED_M:
        raise ValueError(f"free-subspace rows support m <= {MAX_FUSED_M}")
    # one masked Cholesky of the identity-padded matrix shared by the n
    # columns, solved together (clamped rows pass through, zeroed on output)
    free_b = torch.stack(free)
    L, rdiag, _bad = chol_masked(
        _stack(quuF), torch.where(free_b, one, zero))
    b = torch.stack([torch.stack(row) for row in cols])        # (m, n, B)
    sv = chol_solve(L[:, :, None], rdiag[:, None], b)
    out = torch.where(free_b[:, None], -sv, zero)
    return [list(row.unbind(0)) for row in out.unbind(0)]


# --- general m (m > 4): masked Cholesky and projected Newton ---------------

def _stack(q):
    """A nested list of per-lane tensors as one (m, m, …) tensor."""
    return torch.stack([torch.stack(row) for row in q])


def _rsqrt(d):
    """The IEEE-rounded 1/√d on d's device (see the module docstring)."""
    return torch.rsqrt(d) if d.device.type == "cpu" else 1.0 / torch.sqrt(d)


def chol_masked(Q, free_f):
    """Cholesky of P = mask(Q), where P has the free principal block of Q and
    identity rows and columns on clamped dims (P_ij = free_i·free_j·Q_ij +
    (1 − free_i)·δ_ij); the factor keeps that padding, so solves pass
    clamped entries through (_chol_masked_tiles).

    Q (m, m, …) symmetric, free_f (m, …) f32 0/1. Returns (L (m, m, …),
    lower-triangular, rdiag (m, …) = 1/L_ii, bad (…) bool: a non-positive
    pivot on a free dim). Column i of L is computed for all rows j > i at
    once, its products L_jk·L_ik for all k at once; each entry subtracts
    them in k order, as the tile code does.
    """
    m = Q.shape[0]
    L = torch.zeros_like(Q)
    rdiag = torch.empty_like(free_f)
    bad = torch.zeros(Q.shape[2:], dtype=torch.bool, device=Q.device)
    for i in range(m):
        d = free_f[i] * Q[i, i] + (1.0 - free_f[i])
        if i:
            for sq in (L[i, :i] * L[i, :i]).unbind(0):
                d = d - sq
        bad = bad | ((free_f[i] > 0.5) & (d <= 0.0))
        d_safe = _safe(d)
        rd = _rsqrt(d_safe)
        rdiag[i] = rd
        L[i, i] = d_safe * rd
        if i + 1 < m:
            acc = free_f[i] * free_f[i + 1:] * Q[i + 1:, i]
            if i:
                for prod in (L[i + 1:, :i] * L[i, :i]).unbind(1):
                    acc = acc - prod
            L[i + 1:, i] = acc * rd
    return L, rdiag, bad


def chol_solve(L, rdiag, b):
    """Solves L·Lᵀ·x = b by forward and back substitution
    (_chol_solve_tiles). b (m, …) broadcasts against L's trailing dims. The
    forward pass updates the pending rows a column at a time (row i still
    subtracts L_ik·y_k in k order); the back substitution forms each row's
    products at once and subtracts them in ascending k."""
    m = b.shape[0]
    acc = b.clone()
    for k in range(m):
        acc[k] = acc[k] * rdiag[k]            # y_k
        if k + 1 < m:
            acc[k + 1:] = acc[k + 1:] - L[k + 1:, k] * acc[k]
    y = acc
    x = torch.empty_like(y)
    for i in range(m - 1, -1, -1):
        s = y[i]
        if i + 1 < m:
            for prod in (L[i + 1:, i] * x[i + 1:]).unbind(0):
                s = s - prod
        x[i] = s * rdiag[i]
    return x


def _pn_val(Q, g, x):
    """½xᵀQx + gᵀx as the tile code sums it: the diagonal terms
    g_i·x_i + ½q_ii·x_i·x_i in i order, then q_ij·x_i·x_j over i < j in
    (i, j) order (only those pairs are multiplied).
    Q (m, m, B), g (m, B), x (m, …, B) with any candidate dims between."""
    m = x.shape[0]
    extra = (1,) * (x.dim() - 2)
    iu, ju = torch.triu_indices(m, m, 1, device=x.device)
    qd = torch.diagonal(Q, dim1=0, dim2=1).movedim(-1, 0)
    ge, qd, qu = (a.reshape(a.shape[:1] + extra + a.shape[1:])
                  for a in (g, qd, Q[iu, ju]))
    t1 = ge * x
    t2 = 0.5 * qd * x * x
    prod = qu * x[iu] * x[ju]
    v = torch.zeros_like(x[0])
    for a, b in zip(t1.unbind(0), t2.unbind(0)):
        v = v + a + b
    for p in prod.unbind(0):
        v = v + p
    return v


def _pn_grad(Q, g, x):
    """Qx + g, each row summed from g_i in j order."""
    acc = g
    for prod in (Q * x[None]).unbind(1):
        acc = acc + prod
    return acc


def _kkt_clamped(x, gr, lo, hi):
    return ((x <= lo) & (gr > 0.0)) | ((x >= hi) & (gr < 0.0))


def qp_pn(quuF, qu, lo, hi, m):
    """Box QP for 5 ≤ m ≤ 24 by projected Newton (_qp_pn): from
    clamp(−QuuF⁻¹·Qu), m + 6 iterations of {KKT active set → masked
    Cholesky free-subspace solve → the clamped candidates x + s·(x_N − x)
    for s in PN_STEPS, the best whose value is strictly below the current
    one taken}; the all-free and every iteration's factorization flag a
    non-PD free block (``bad``). Returns (k, free, bad) as the enumeration
    QPs do: ``free`` is the final KKT-free set."""
    if m > MAX_FUSED_M:
        raise ValueError(f"the in-kernel box QP supports m <= {MAX_FUSED_M}")
    Q, g = _stack(quuF), torch.stack(qu)
    lo, hi = torch.stack(lo), torch.stack(hi)
    one = torch.ones_like(g)
    zero = torch.zeros_like(g)
    L, rdiag, bad = chol_masked(Q, one)
    x = clip(chol_solve(L, rdiag, -g), lo, hi)
    v_cur = _pn_val(Q, g, x)
    steps = torch.tensor(PN_STEPS, dtype=g.dtype, device=g.device)[:, None]
    for _ in range(m + 6):
        free_f = torch.where(_kkt_clamped(x, _pn_grad(Q, g, x), lo, hi),
                             zero, one)
        L, rdiag, bad_it = chol_masked(Q, free_f)
        bad = bad | bad_it
        rhs = free_f * _pn_grad(Q, g, (1.0 - free_f) * x)
        d = chol_solve(L, rdiag, rhs)
        xn = free_f * (-d) + (1.0 - free_f) * x
        # the ladder's five candidates at once: (m, 5, B)
        cand = clip(x[:, None] + steps * (xn - x)[:, None], lo[:, None],
                    hi[:, None])
        # the strict v_c < v_best rule picks one of x (0) and the
        # candidates (s + 1); the pick is then copied once, as the kernel
        # copies a taken candidate
        vals = torch.cat([v_cur[None], _pn_val(Q, g, cand)])
        pick = torch.zeros_like(v_cur, dtype=torch.long)
        for s in range(len(PN_STEPS)):
            v_best = vals.gather(0, pick[None])[0]
            pick = torch.where(vals[s + 1] < v_best, s + 1, pick)
        v_cur = vals.gather(0, pick[None])[0]
        x = torch.cat([x[:, None], cand], 1).gather(
            1, pick.expand(m, -1)[:, None])[:, 0]
    free = ~_kkt_clamped(x, _pn_grad(Q, g, x), lo, hi) & ~bad
    k = torch.where(bad, zero, x)
    return list(k.unbind(0)), list(free.unbind(0)), bad


_BOX_QPS = {1: qp_m1, 2: qp_m2, 3: qp_m3, 4: qp_m4}


def box_qp(quuF, qu, lo, hi, m):
    """The in-kernel box QP for control dimension m (k, free, bad)."""
    if m in _BOX_QPS:
        return _BOX_QPS[m](quuF, qu, lo, hi)
    return qp_pn(quuF, qu, lo, hi, m)
