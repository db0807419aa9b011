"""The merged sweep's per-lane box QPs for m ≤ 4 and the unconstrained
Newton step, plain PyTorch (counterpart of the in-kernel QPs of
``ilqr_tpu/ops/pallas_sweep.py``: ``_qp_m1`` … ``_qp_m4``, ``_subdet``,
``_adj_det``, ``_qp_newton`` and ``_free_solve_rows`` for m ≤ 4).

Every matrix is a nested list of per-lane tensors (``q[i][j]`` of shape
(B,)), every vector a list of them. Each function repeats the JAX tile
code's operations in its order, and csrc/qp.cuh repeats them again for the
CUDA kernels, so the three agree bitwise where the trig does not enter.

- m = 1: closed form clamp(−Qu/QuuF);
- m = 2, 3, 4: exact active-set enumeration: all 3^m (lower/free/upper)
  candidate sets in ``itertools.product`` order, each solved in closed form
  and kept if it passes its KKT filter and its value is strictly below the
  best so far (ties go to the first candidate); at m = 4 the 15
  per-free-subset adjugates and reciprocal determinants are shared by the
  81 candidates;
- unconstrained: k = −QuuF⁻¹·Qu with a Sylvester PD check.

The ``bad`` flag (QuuF not positive definite by its leading principal
minors) zeroes k and marks the lane diverged. The feedback rows come from
the identity-padded free-subspace inverse, zero on clamped controls
(ref src/ilqr_core.cpp:377-385).
"""

from __future__ import annotations

import itertools

import torch

from ilqr_tpu_torch.ops.kernel_rollout import clip

MAX_ENUM_M = 4
BIG = 3.0e38   # the enumeration's starting best value


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
    else:
        raise NotImplementedError(
            f"the Newton step is ported for m <= {MAX_ENUM_M} (m = {m}); "
            "the masked-Cholesky m > 4 branch comes with the "
            "projected-Newton QP")
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
    raise NotImplementedError(
        f"free-subspace rows are ported for m <= {MAX_ENUM_M} (m = {m})")


_BOX_QPS = {1: qp_m1, 2: qp_m2, 3: qp_m3, 4: qp_m4}


def box_qp(quuF, qu, lo, hi, m):
    """The in-kernel box QP for control dimension m (k, free, bad)."""
    if m not in _BOX_QPS:
        raise NotImplementedError(
            f"the in-kernel box QP is ported for m <= {MAX_ENUM_M} "
            f"(m = {m}); the projected-Newton QP for 5 <= m <= 24 is not "
            "ported yet")
    return _BOX_QPS[m](quuF, qu, lo, hi)
