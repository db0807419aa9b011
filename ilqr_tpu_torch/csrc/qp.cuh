// The merged sweep's per-lane QPs (counterpart of
// ilqr_tpu/ops/pallas_sweep.py _qp_m1 … _qp_m4, _subdet, _adj_det,
// _chol_masked_tiles, _chol_solve_tiles, _qp_pn, _qp_newton and
// _free_solve_rows; plain version ilqr_tpu_torch/ops/qp.py).
//
// Every expression repeats the JAX tile code's operations in its order, so
// that with --fmad=false each value is the IEEE f32 result the plain
// version computes. For m ≤ 4: the candidate order of
// itertools.product((0,1,2), repeat=m) (lower / free / upper), a strict
// v < best from 3e38 (ties go to the first candidate), one shared
// reciprocal where JAX takes one, the Sylvester minors for the PD check,
// the identity-padded free-subspace inverse for the feedback rows. The
// combinatorics (candidates, free subsets, cofactor expansions) are
// resolved at compile time: candidate C and subset masks are template
// parameters (template recursion over distinct instantiations), so every
// index into the per-lane registers is a constant. For 5 ≤ m ≤ 24:
// projected Newton over a masked Cholesky, in runtime loops (below).
#pragma once

#include "jnp.cuh"

namespace qp {

constexpr float kBig = 3.0e38f;  // the enumeration's starting best value

// d where d > 0, else 1 (a non-positive pivot is flagged bad)
__device__ __forceinline__ float safe(float d) { return d <= 0.0f ? 1.0f : d; }
// d where d ≠ 0, else 1
__device__ __forceinline__ float nonzero(float d) {
  return d == 0.0f ? 1.0f : d;
}

// --- helpers over index sets held as bitmasks (ascending). They are loops,
// not recursions, so that where a kernel calls them with an unrolled loop
// index they inline and fold to constants (a recursive device function
// stays a call, and its stack can no longer be sized at compile time).
__host__ __device__ constexpr int popc(unsigned s) {
  int n = 0;
  for (; s; s >>= 1) n += static_cast<int>(s & 1u);
  return n;
}
__host__ __device__ constexpr int low_bit(unsigned s) {
  int i = 0;
  while (!((s >> i) & 1u)) ++i;
  return i;
}
// index of the n-th set bit of s
__host__ __device__ constexpr int nth_bit(unsigned s, int n) {
  for (int i = 0; i < 32; ++i) {
    if ((s >> i) & 1u) {
      if (n == 0) return i;
      --n;
    }
  }
  return -1;
}
// digit i of candidate c in base 3, dimension 0 the slowest (product order)
__host__ __device__ constexpr int digit(int c, int i, int m) {
  for (int k = m - 1; k > i; --k) c /= 3;
  return c % 3;
}
__host__ __device__ constexpr unsigned free_mask(int c, int m) {
  unsigned f = 0u;
  for (int i = 0; i < m; ++i)
    if (digit(c, i, m) == 1) f |= 1u << i;
  return f;
}

// ---------------------------------------------------------------------------
// m = 1: closed form (_qp_m1)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void box1(const float q[1][1], const float g[1],
                                     const float lo[1], const float hi[1],
                                     float k[1], bool is_free[1], bool& bad) {
  const float q11 = q[0][0];
  const float g1 = g[0];
  bad = q11 <= 0.0f;
  const float q_safe = bad ? 1.0f : q11;
  const float x1 = jnp::clip(-g1 * (1.0f / q_safe), lo[0], hi[0]);
  const float gk = q11 * x1 + g1;
  const bool clamped = (x1 <= lo[0] && gk > 0.0f) || (x1 >= hi[0] && gk < 0.0f);
  k[0] = bad ? 0.0f : x1;
  is_free[0] = !clamped && !bad;
}

// ---------------------------------------------------------------------------
// m = 2: 9 candidates (_qp_m2)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void box2(const float q[2][2], const float g[2],
                                     const float lo[2], const float hi[2],
                                     float k[2], bool is_free[2], bool& bad) {
  const float a = q[0][0], b = q[0][1], c = q[1][1];
  const float g0 = g[0], g1 = g[1];
  const float det = a * c - b * b;
  bad = (a <= 0.0f) || (det <= 0.0f);
  const float rsa = 1.0f / safe(a), rsc = 1.0f / safe(c);
  const float rsdet = 1.0f / safe(det);
  float best_v = kBig, best0 = 0.0f, best1 = 0.0f, bf0 = 0.0f, bf1 = 0.0f;
#pragma unroll
  for (int s0 = 0; s0 < 3; ++s0) {
#pragma unroll
    for (int s1 = 0; s1 < 3; ++s1) {
      const bool f0 = s0 == 1, f1 = s1 == 1;
      const float x0c = s0 == 0 ? lo[0] : hi[0];
      const float x1c = s1 == 0 ? lo[1] : hi[1];
      float x0, x1;
      if (f0 && f1) {
        x0 = (-g0 * c + g1 * b) * rsdet;
        x1 = (-g1 * a + g0 * b) * rsdet;
      } else if (f0) {
        x1 = x1c;
        x0 = -(g0 + b * x1) * rsa;
      } else if (f1) {
        x0 = x0c;
        x1 = -(g1 + b * x0) * rsc;
      } else {
        x0 = x0c;
        x1 = x1c;
      }
      const float gr0 = a * x0 + b * x1 + g0;
      const float gr1 = b * x0 + c * x1 + g1;
      bool ok = f0 ? (x0 >= lo[0] && x0 <= hi[0])
                   : (s0 == 0 ? gr0 >= 0.0f : gr0 <= 0.0f);
      ok = ok && (f1 ? (x1 >= lo[1] && x1 <= hi[1])
                     : (s1 == 0 ? gr1 >= 0.0f : gr1 <= 0.0f));
      const float v = 0.5f * (a * x0 * x0 + 2.0f * b * x0 * x1 + c * x1 * x1)
                      + g0 * x0 + g1 * x1;
      if (ok && v < best_v) {
        best_v = v;
        best0 = x0;
        best1 = x1;
        bf0 = f0 ? 1.0f : 0.0f;
        bf1 = f1 ? 1.0f : 0.0f;
      }
    }
  }
  k[0] = bad ? 0.0f : best0;
  k[1] = bad ? 0.0f : best1;
  is_free[0] = bf0 > 0.5f && !bad;
  is_free[1] = bf1 > 0.5f && !bad;
}

// Adjugate entries of the symmetric [[a, b, c], [b, dd, e], [c, e, f]] and
// its determinant, in the JAX kernel's expressions.
__device__ __forceinline__ float adj3(float a, float b, float c, float dd,
                                      float e, float f, float adj[3][3]) {
  const float A00 = dd * f - e * e;
  const float A01 = -(b * f - e * c);
  const float A02 = b * e - dd * c;
  const float A11 = a * f - c * c;
  const float A12 = -(a * e - b * c);
  const float A22 = a * dd - b * b;
  adj[0][0] = A00; adj[0][1] = A01; adj[0][2] = A02;
  adj[1][0] = A01; adj[1][1] = A11; adj[1][2] = A12;
  adj[2][0] = A02; adj[2][1] = A12; adj[2][2] = A22;
  return a * A00 + b * A01 + c * A02;
}

// ---------------------------------------------------------------------------
// m = 3: 27 candidates (_qp_m3)
// ---------------------------------------------------------------------------
struct Shared3 {
  float rq[3];        // 1 / safe(q_ii)
  float rpair[3][3];  // 1 / safe(q_ii q_jj − q_ij²), i < j
};

template <int C>
__device__ __forceinline__ void cand3(const float q[3][3], const float g[3],
                                      const float lo[3], const float hi[3],
                                      const Shared3& sh, float& best_v,
                                      float best[3], float bf[3]) {
  constexpr unsigned F = free_mask(C, 3);
  constexpr int nf = popc(F);
  float xc[3], x[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    xc[i] = digit(C, i, 3) == 0 ? lo[i] : hi[i];
    x[i] = xc[i];
  }
  // rhs(i) = g_i + Σ over the fixed dims j of q_ij·xc_j
  auto rhs = [&](int i) {
    float acc = g[i];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (digit(C, j, 3) != 1) acc = acc + q[i][j] * xc[j];
    return acc;
  };
  if constexpr (nf == 1) {
    constexpr int i = low_bit(F);
    x[i] = -rhs(i) * sh.rq[i];
  } else if constexpr (nf == 2) {
    constexpr int i = nth_bit(F, 0), j = nth_bit(F, 1);
    const float aa = q[i][i], bb = q[i][j], cc = q[j][j];
    const float rd = sh.rpair[i][j];
    const float ri = rhs(i), rj = rhs(j);
    x[i] = (-ri * cc + rj * bb) * rd;
    x[j] = (-rj * aa + ri * bb) * rd;
  } else if constexpr (nf == 3) {
    float adj[3][3];
    const float rdet = 1.0f / safe(adj3(q[0][0], q[0][1], q[0][2], q[1][1],
                                        q[1][2], q[2][2], adj));
#pragma unroll
    for (int r = 0; r < 3; ++r)
      x[r] = -(adj[r][0] * g[0] + adj[r][1] * g[1] + adj[r][2] * g[2]) * rdet;
  }
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float gr = g[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) gr = gr + q[i][j] * x[j];
    const int s = digit(C, i, 3);
    ok = ok && (s == 1 ? (x[i] >= lo[i] && x[i] <= hi[i])
                       : (s == 0 ? gr >= 0.0f : gr <= 0.0f));
  }
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    v = v + g[i] * x[i] + 0.5f * q[i][i] * x[i] * x[i];
  v = v + q[0][1] * x[0] * x[1] + q[0][2] * x[0] * x[2]
      + q[1][2] * x[1] * x[2];
  if (ok && v < best_v) {
    best_v = v;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      best[i] = x[i];
      bf[i] = digit(C, i, 3) == 1 ? 1.0f : 0.0f;
    }
  }
  if constexpr (C + 1 < 27) cand3<C + 1>(q, g, lo, hi, sh, best_v, best, bf);
}

__device__ __forceinline__ void box3(const float q[3][3], const float g[3],
                                     const float lo[3], const float hi[3],
                                     float k[3], bool is_free[3], bool& bad) {
  // Sylvester criterion on leading principal minors
  const float det2 = q[0][0] * q[1][1] - q[0][1] * q[0][1];
  const float det3 = (q[0][0] * (q[1][1] * q[2][2] - q[1][2] * q[1][2])
                      - q[0][1] * (q[0][1] * q[2][2] - q[1][2] * q[0][2])
                      + q[0][2] * (q[0][1] * q[1][2] - q[1][1] * q[0][2]));
  bad = (q[0][0] <= 0.0f) || (det2 <= 0.0f) || (det3 <= 0.0f);
  Shared3 sh;
#pragma unroll
  for (int i = 0; i < 3; ++i) sh.rq[i] = 1.0f / safe(q[i][i]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i + 1; j < 3; ++j)
      sh.rpair[i][j] = 1.0f / safe(q[i][i] * q[j][j] - q[i][j] * q[i][j]);
  float best_v = kBig, best[3] = {0.0f, 0.0f, 0.0f}, bf[3] = {0.0f, 0.0f, 0.0f};
  cand3<0>(q, g, lo, hi, sh, best_v, best, bf);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    k[i] = bad ? 0.0f : best[i];
    is_free[i] = bf[i] > 0.5f && !bad;
  }
}

// ---------------------------------------------------------------------------
// Cofactor expansion and adjugates (_subdet, _adj_det) on 4 × 4 matrices;
// rows and columns are ascending index sets held as bitmasks.
// ---------------------------------------------------------------------------
template <unsigned R, unsigned Cs>
__device__ __forceinline__ float subdet(const float q[4][4]);

// terms J.. of the first-row expansion, added to acc as _subdet does
template <unsigned R, unsigned Cs, int J>
__device__ __forceinline__ float subdet_terms(const float q[4][4], float acc) {
  if constexpr (J == popc(Cs)) {
    return acc;
  } else {
    constexpr int r0 = low_bit(R);
    constexpr int cj = nth_bit(Cs, J);
    const float minor = subdet<R & (R - 1u), Cs & ~(1u << cj)>(q);
    const float term = q[r0][cj] * minor;
    float next;
    if constexpr (J == 0)
      next = term;
    else if constexpr (J % 2 == 0)
      next = acc + term;
    else
      next = acc - term;
    return subdet_terms<R, Cs, J + 1>(q, next);
  }
}

template <unsigned R, unsigned Cs>
__device__ __forceinline__ float subdet(const float q[4][4]) {
  if constexpr (popc(R) == 1)
    return q[low_bit(R)][low_bit(Cs)];
  else
    return subdet_terms<R, Cs, 0>(q, 0.0f);
}

// cofactors (a, b ≥ a) of the symmetric q[S][S], mirrored
template <unsigned S, int A, int B>
__device__ __forceinline__ void adj_entries(const float q[4][4],
                                            float adj[4][4]) {
  constexpr int k = popc(S);
  if constexpr (A < k) {
    if constexpr (B < k) {
      constexpr unsigned rows = S & ~(1u << nth_bit(S, B));
      constexpr unsigned cols = S & ~(1u << nth_bit(S, A));
      float cof = subdet<rows, cols>(q);
      if constexpr ((A + B) % 2) cof = -cof;
      adj[A][B] = cof;
      adj[B][A] = cof;
      adj_entries<S, A, B + 1>(q, adj);
    } else {
      adj_entries<S, A + 1, A + 1>(q, adj);
    }
  }
}

// adjugate (over positions in S) and determinant of q[S][S]
template <unsigned S>
__device__ __forceinline__ float adj_det(const float q[4][4], float adj[4][4]) {
  if constexpr (popc(S) == 1) {
    adj[0][0] = 1.0f;
    return q[low_bit(S)][low_bit(S)];
  } else {
    adj_entries<S, 0, 0>(q, adj);
    return subdet<S, S>(q);
  }
}

// a leading principal minor of q is ≤ 0 (Sylvester)
__device__ __forceinline__ bool sylvester_bad4(const float q[4][4]) {
  return (q[0][0] <= 0.0f) || (subdet<0x3u, 0x3u>(q) <= 0.0f)
         || (subdet<0x7u, 0x7u>(q) <= 0.0f) || (subdet<0xFu, 0xFu>(q) <= 0.0f);
}

// ---------------------------------------------------------------------------
// m = 4: 81 candidates over 15 shared free-subset adjugates (_qp_m4)
// ---------------------------------------------------------------------------
struct Shared4 {
  float adj[16][4][4];  // per free-subset mask; positions within the subset
  float rdet[16];
};

template <unsigned S>
__device__ __forceinline__ void fill_shared4(const float q[4][4], Shared4& sh) {
  sh.rdet[S] = 1.0f / safe(adj_det<S>(q, sh.adj[S]));
  if constexpr (S < 15u) fill_shared4<S + 1u>(q, sh);
}

template <int C>
__device__ __forceinline__ void cand4(const float q[4][4], const float g[4],
                                      const float lo[4], const float hi[4],
                                      const Shared4& sh, float& best_v,
                                      float best[4], float bf[4]) {
  constexpr unsigned F = free_mask(C, 4);
  constexpr int nf = popc(F);
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = digit(C, i, 4) == 0 ? lo[i] : hi[i];
  if constexpr (nf > 0) {
    float rhs[4];
#pragma unroll
    for (int a = 0; a < nf; ++a) {
      const int i = nth_bit(F, a);
      float acc = g[i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (digit(C, j, 4) != 1) acc = acc + q[i][j] * x[j];
      rhs[a] = acc;
    }
#pragma unroll
    for (int a = 0; a < nf; ++a) {
      float s = sh.adj[F][a][0] * rhs[0];
#pragma unroll
      for (int b = 1; b < nf; ++b) s = s + sh.adj[F][a][b] * rhs[b];
      x[nth_bit(F, a)] = -s * sh.rdet[F];
    }
  }
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float gr = g[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) gr = gr + q[i][j] * x[j];
    const int s = digit(C, i, 4);
    ok = ok && (s == 1 ? (x[i] >= lo[i] && x[i] <= hi[i])
                       : (s == 0 ? gr >= 0.0f : gr <= 0.0f));
  }
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v = v + g[i] * x[i] + 0.5f * q[i][i] * x[i] * x[i];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = i + 1; j < 4; ++j) v = v + q[i][j] * x[i] * x[j];
  if (ok && v < best_v) {
    best_v = v;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      best[i] = x[i];
      bf[i] = digit(C, i, 4) == 1 ? 1.0f : 0.0f;
    }
  }
  if constexpr (C + 1 < 81) cand4<C + 1>(q, g, lo, hi, sh, best_v, best, bf);
}

__device__ __forceinline__ void box4(const float q[4][4], const float g[4],
                                     const float lo[4], const float hi[4],
                                     float k[4], bool is_free[4], bool& bad) {
  bad = sylvester_bad4(q);
  Shared4 sh;
  fill_shared4<1u>(q, sh);
  float best_v = kBig;
  float best[4] = {0.0f, 0.0f, 0.0f, 0.0f}, bf[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  cand4<0>(q, g, lo, hi, sh, best_v, best, bf);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    k[i] = bad ? 0.0f : best[i];
    is_free[i] = bf[i] > 0.5f && !bad;
  }
}

// ---------------------------------------------------------------------------
// General m (5 ≤ M ≤ 24): the masked Cholesky (_chol_masked_tiles), its
// solve (_chol_solve_tiles) and projected Newton (_qp_pn).
//
// The JAX kernel unrolls O(m³)·(m + 6) operations per timestep, which took
// Mosaic minutes to compile at m ≥ 12. Here the Newton iterations, the
// ladder, the Cholesky rows and every loop over the control dims are
// runtime loops (#pragma unroll 1): the matrices live in the thread's local
// memory, indexed at run time, and the code stays O(1) in m. Each loop is a
// loop, never a recursion, so the frame (a few KB at m = 24) is sized at
// compile time.
// ---------------------------------------------------------------------------
constexpr int kMaxFusedM = 24;  // pallas_sweep.py MAX_FUSED_M

// Cholesky of P = mask(q): the free principal block of q, identity rows and
// columns on clamped dims (P_ij = free_i·free_j·q_ij + (1 − free_i)·δ_ij).
// Writes the lower triangle of L and rdiag_i = 1/L_ii; returns whether a
// free dim has a non-positive pivot. The reciprocal square root is
// 1.0f / sqrtf(d), IEEE-rounded like the plain version's 1.0 / torch.sqrt.
template <int M>
__device__ __forceinline__ bool chol_masked(const float q[M][M],
                                            const float free_f[M],
                                            float L[M][M], float rdiag[M]) {
  bool bad = false;
#pragma unroll 1
  for (int i = 0; i < M; ++i) {
    float d = free_f[i] * q[i][i] + (1.0f - free_f[i]);
#pragma unroll 1
    for (int k = 0; k < i; ++k) d = d - L[i][k] * L[i][k];
    bad = bad || (free_f[i] > 0.5f && d <= 0.0f);
    const float d_safe = d <= 0.0f ? 1.0f : d;
    const float rd = 1.0f / sqrtf(d_safe);
    rdiag[i] = rd;
    L[i][i] = d_safe * rd;
#pragma unroll 1
    for (int j = i + 1; j < M; ++j) {
      float acc = free_f[i] * free_f[j] * q[j][i];
#pragma unroll 1
      for (int k = 0; k < i; ++k) acc = acc - L[j][k] * L[i][k];
      L[j][i] = acc * rd;
    }
  }
  return bad;
}

// L·Lᵀ·x = b by forward and back substitution (b and x distinct)
template <int M>
__device__ __forceinline__ void chol_solve(const float L[M][M],
                                           const float rdiag[M],
                                           const float b[M], float x[M]) {
  float y[M];
#pragma unroll 1
  for (int i = 0; i < M; ++i) {
    float acc = b[i];
#pragma unroll 1
    for (int k = 0; k < i; ++k) acc = acc - L[i][k] * y[k];
    y[i] = acc * rdiag[i];
  }
#pragma unroll 1
  for (int i = M - 1; i >= 0; --i) {
    float acc = y[i];
#pragma unroll 1
    for (int k = i + 1; k < M; ++k) acc = acc - L[k][i] * x[k];
    x[i] = acc * rdiag[i];
  }
}

// ½xᵀqx + gᵀx in the tile code's order: the diagonal terms first, then
// q_ij·x_i·x_j over i < j
template <int M>
__device__ __forceinline__ float pn_val(const float q[M][M], const float g[M],
                                        const float x[M]) {
  float v = 0.0f;
#pragma unroll 1
  for (int i = 0; i < M; ++i)
    v = v + g[i] * x[i] + 0.5f * q[i][i] * x[i] * x[i];
#pragma unroll 1
  for (int i = 0; i < M; ++i)
#pragma unroll 1
    for (int j = i + 1; j < M; ++j) v = v + q[i][j] * x[i] * x[j];
  return v;
}

// row i of q·x + g, summed from g_i in j order
template <int M>
__device__ __forceinline__ float pn_grad_row(const float q[M][M],
                                             const float g[M],
                                             const float x[M], int i) {
  float acc = g[i];
#pragma unroll 1
  for (int j = 0; j < M; ++j) acc = acc + q[i][j] * x[j];
  return acc;
}

__device__ __forceinline__ bool kkt_clamped(float x, float gr, float lo,
                                            float hi) {
  return (x <= lo && gr > 0.0f) || (x >= hi && gr < 0.0f);
}

// Projected Newton (_qp_pn): from clamp(−q⁻¹g), M + 6 iterations of {KKT
// active set → masked-Cholesky solve on the free dims → the clamped
// candidates x + s·(x_N − x), s = 1, ½, ¼, ⅛, 1/16, the best one strictly
// below the current value taken}. The f32 0/1 masks carry the active set;
// every factorization's pivots feed the PD flag.
template <int M>
__device__ __forceinline__ void pn(const float q[M][M], const float g[M],
                                   const float lo[M], const float hi[M],
                                   float k[M], bool is_free[M], bool& bad) {
  float L[M][M], rdiag[M], ff[M], rhs[M], x[M], d[M], xn[M], best[M], c[M];
#pragma unroll 1
  for (int i = 0; i < M; ++i) {
    ff[i] = 1.0f;
    rhs[i] = -g[i];
  }
  bad = chol_masked<M>(q, ff, L, rdiag);
  chol_solve<M>(L, rdiag, rhs, x);
#pragma unroll 1
  for (int i = 0; i < M; ++i) x[i] = jnp::clip(x[i], lo[i], hi[i]);
  float v_cur = pn_val<M>(q, g, x);
#pragma unroll 1
  for (int it = 0; it < M + 6; ++it) {
#pragma unroll 1
    for (int i = 0; i < M; ++i)
      ff[i] = kkt_clamped(x[i], pn_grad_row<M>(q, g, x, i), lo[i], hi[i])
                  ? 0.0f : 1.0f;
    const bool bad_it = chol_masked<M>(q, ff, L, rdiag);
    bad = bad || bad_it;
#pragma unroll 1
    for (int i = 0; i < M; ++i) {
      float acc = g[i];
#pragma unroll 1
      for (int j = 0; j < M; ++j) acc = acc + q[i][j] * ((1.0f - ff[j]) * x[j]);
      rhs[i] = ff[i] * acc;
    }
    chol_solve<M>(L, rdiag, rhs, d);
#pragma unroll 1
    for (int i = 0; i < M; ++i) {
      xn[i] = ff[i] * (-d[i]) + (1.0f - ff[i]) * x[i];
      best[i] = x[i];
    }
    float v_best = v_cur;
    float step = 1.0f;
#pragma unroll 1
    for (int s = 0; s < 5; ++s, step = step * 0.5f) {
#pragma unroll 1
      for (int i = 0; i < M; ++i)
        c[i] = jnp::clip(x[i] + step * (xn[i] - x[i]), lo[i], hi[i]);
      const float v_c = pn_val<M>(q, g, c);
      if (v_c < v_best) {
        v_best = v_c;
#pragma unroll 1
        for (int i = 0; i < M; ++i) best[i] = c[i];
      }
    }
#pragma unroll 1
    for (int i = 0; i < M; ++i) x[i] = best[i];
    v_cur = v_best;
  }
#pragma unroll 1
  for (int i = 0; i < M; ++i) {
    is_free[i] =
        !kkt_clamped(x[i], pn_grad_row<M>(q, g, x, i), lo[i], hi[i]) && !bad;
    k[i] = bad ? 0.0f : x[i];
  }
}

// ---------------------------------------------------------------------------
// Dispatch by m, the Newton step (_qp_newton) and the feedback rows
// (_free_solve_rows)
// ---------------------------------------------------------------------------
template <int M>
__device__ __forceinline__ void box(const float q[M][M], const float g[M],
                                    const float lo[M], const float hi[M],
                                    float k[M], bool is_free[M], bool& bad) {
  static_assert(M >= 1 && M <= kMaxFusedM, "the in-kernel QPs cover m <= 24");
  if constexpr (M == 1) box1(q, g, lo, hi, k, is_free, bad);
  if constexpr (M == 2) box2(q, g, lo, hi, k, is_free, bad);
  if constexpr (M == 3) box3(q, g, lo, hi, k, is_free, bad);
  if constexpr (M == 4) box4(q, g, lo, hi, k, is_free, bad);
  if constexpr (M >= 5) pn<M>(q, g, lo, hi, k, is_free, bad);
}

// Unconstrained regularized Newton step k = −QuuF⁻¹·Qu (ref
// src/ilqr_core.cpp:369 with no active limits); all dims free. The PD check
// is Sylvester's for m ≤ 4, the all-free Cholesky's pivots above.
template <int M>
__device__ __forceinline__ void newton(const float q[M][M], const float g[M],
                                       float k[M], bool is_free[M], bool& bad) {
  static_assert(M >= 1 && M <= kMaxFusedM, "the Newton step covers m <= 24");
  float x[M];
  if constexpr (M >= 5) {
    float L[M][M], rdiag[M], ff[M], rhs[M];
#pragma unroll 1
    for (int i = 0; i < M; ++i) {
      ff[i] = 1.0f;
      rhs[i] = -g[i];
    }
    bad = chol_masked<M>(q, ff, L, rdiag);
    chol_solve<M>(L, rdiag, rhs, x);
  } else if constexpr (M == 1) {
    bad = q[0][0] <= 0.0f;
    x[0] = -g[0] / safe(q[0][0]);
  } else if constexpr (M == 2) {
    const float a = q[0][0], b = q[0][1], c = q[1][1];
    const float det = a * c - b * b;
    bad = (a <= 0.0f) || (det <= 0.0f);
    const float rsdet = 1.0f / safe(det);
    x[0] = (-g[0] * c + g[1] * b) * rsdet;
    x[1] = (-g[1] * a + g[0] * b) * rsdet;
  } else if constexpr (M == 3) {
    const float a = q[0][0], b = q[0][1], dd = q[1][1];
    const float det2 = a * dd - b * b;
    float adj[3][3];
    const float det3 = adj3(a, b, q[0][2], dd, q[1][2], q[2][2], adj);
    bad = (a <= 0.0f) || (det2 <= 0.0f) || (det3 <= 0.0f);
    const float rsdet = 1.0f / safe(det3);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      x[j] = -(adj[j][0] * g[0] + adj[j][1] * g[1] + adj[j][2] * g[2]) * rsdet;
  } else {
    bad = sylvester_bad4(q);
    float adj[4][4];
    const float rsdet = 1.0f / safe(adj_det<0xFu>(q, adj));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = adj[j][0] * g[0];
#pragma unroll
      for (int i = 1; i < 4; ++i) s = s + adj[j][i] * g[i];
      x[j] = -s * rsdet;
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j) {
    k[j] = bad ? 0.0f : x[j];
    is_free[j] = !bad;
  }
}

// Rows of −(Q_free)⁻¹·Qux with identity padding on clamped dims and zeroed
// clamped rows (ref ilqr_core.cpp:377-385); one reciprocal determinant
// (m ≤ 4) or one masked Cholesky (m ≥ 5) shared by all N columns.
template <int M, int N>
__device__ __forceinline__ void free_rows(const float q[M][M],
                                          const bool is_free[M],
                                          const float qux[M][N],
                                          float K[M][N]) {
  static_assert(M >= 1 && M <= kMaxFusedM,
                "the free-subspace rows cover m <= 24");
  if constexpr (M >= 5) {
    float L[M][M], rdiag[M], ff[M], v[M], sv[M];
#pragma unroll 1
    for (int j = 0; j < M; ++j) ff[j] = is_free[j] ? 1.0f : 0.0f;
    chol_masked<M>(q, ff, L, rdiag);
#pragma unroll 1
    for (int i = 0; i < N; ++i) {
#pragma unroll 1
      for (int j = 0; j < M; ++j) v[j] = qux[j][i];
      chol_solve<M>(L, rdiag, v, sv);
#pragma unroll 1
      for (int j = 0; j < M; ++j) K[j][i] = is_free[j] ? -sv[j] : 0.0f;
    }
  } else if constexpr (M == 1) {
    const float rq = -(1.0f / (q[0][0] <= 0.0f ? 1.0f : q[0][0]));
#pragma unroll
    for (int i = 0; i < N; ++i) K[0][i] = is_free[0] ? qux[0][i] * rq : 0.0f;
  } else if constexpr (M == 2) {
    const float ap = is_free[0] ? q[0][0] : 1.0f;
    const float cp = is_free[1] ? q[1][1] : 1.0f;
    const float bp = (is_free[0] && is_free[1]) ? q[0][1] : 0.0f;
    const float rdet = 1.0f / nonzero(ap * cp - bp * bp);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float v0 = qux[0][i], v1 = qux[1][i];
      const float s0 = (cp * v0 - bp * v1) * rdet;
      const float s1 = (ap * v1 - bp * v0) * rdet;
      K[0][i] = is_free[0] ? -s0 : 0.0f;
      K[1][i] = is_free[1] ? -s1 : 0.0f;
    }
  } else if constexpr (M == 3) {
    float adj[3][3];
    const bool f0 = is_free[0], f1 = is_free[1], f2 = is_free[2];
    const float det = adj3(f0 ? q[0][0] : 1.0f, (f0 && f1) ? q[0][1] : 0.0f,
                           (f0 && f2) ? q[0][2] : 0.0f, f1 ? q[1][1] : 1.0f,
                           (f1 && f2) ? q[1][2] : 0.0f, f2 ? q[2][2] : 1.0f,
                           adj);
    const float rdet = 1.0f / nonzero(det);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float s = (adj[j][0] * qux[0][i] + adj[j][1] * qux[1][i]
                         + adj[j][2] * qux[2][i]) * rdet;
        K[j][i] = is_free[j] ? -s : 0.0f;
      }
  } else {
    float P[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      P[i][i] = is_free[i] ? q[i][i] : 1.0f;
#pragma unroll
      for (int j = i + 1; j < 4; ++j) {
        P[i][j] = (is_free[i] && is_free[j]) ? q[i][j] : 0.0f;
        P[j][i] = P[i][j];
      }
    }
    float adj[4][4];
    const float rdet = 1.0f / nonzero(adj_det<0xFu>(P, adj));
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = adj[j][0] * qux[0][i];
#pragma unroll
        for (int b = 1; b < 4; ++b) s = s + adj[j][b] * qux[b][i];
        K[j][i] = is_free[j] ? -s * rdet : 0.0f;
      }
  }
}

}  // namespace qp
