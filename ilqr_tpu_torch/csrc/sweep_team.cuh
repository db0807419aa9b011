// sweep_packed (the merged linearize + backward sweep) as a team of kTeam =
// 32 threads per lane, one warp, for the models that take the split
// iteration (m·n ≥ 32: the quadrotor, n = 12, m = 4, and the m ≥ 5 models,
// n = 6, 5 ≤ m ≤ 24): the one-thread sweep_kernel of kernels.cuh redesigned
// for this card. The models with m·n < 32 run their stencil and
// dual-number sweeps on the team of their whole iteration (iteration_team.cuh
// sweep_small_team_kernel), a custom model's too where it has one
// (custom.cuh team_iteration), and their closed-form sweep on one thread a
// lane, as a custom model outside that rule does in every form (a custom
// model with m·n ≥ 32 does not take this warp). fused::launch_model_sweep,
// at the end
// of this file, picks among the three at compile time (kSweepKind).
// The same models' whole iteration runs this sweep as its phase 0
// (sweep_lane, iteration_warp.cuh).
//
// Replaces: ilqr_tpu/ops/pallas_sweep.py sweep_packed (_kernel +
// _sweep_step, _terminal_init, _qp_pn, _chol_masked_tiles,
// _chol_solve_tiles, _free_solve_rows, _qp_m4, _qp_newton), as kernels.cuh
// sweep_kernel does, on the same inputs and outputs, with the same
// launcher names and signatures.
// Bound on this card: latency. By bytes a launch is tiny (per lane-step it
// reads x, u and writes k, K); by operations it is the Riccati algebra and
// the QP (projected Newton: m + 6 masked Cholesky factorizations and
// solves per step; the quadrotor's 81 candidates), in a serial chain per
// lane, since each step waits on the V-carry of the step before. One thread
// per lane in blocks of 64 used 16 of the 132 SMs at B = 1024, ran every
// step's independent work in series and kept its matrices in local memory.
// Design: a warp serves one lane, with the lane's V-carry, the step's
// derivatives, Q-terms, QP state and gains in shared memory (Lane below);
// a block of kLanes warps serves kLanes lanes, so B = 1024 is 256 blocks.
// Exchange is through that memory, with __syncwarp between a store and
// another thread's load; a team meets no block barrier after the start.
// Every output value is computed by one thread with the one-thread
// kernel's operations in its order (--fmad=false); no sum is split or
// reordered across threads, so the results are that kernel's bit for bit.
//  - Linearization: under the stencils, thread s takes the perturbed steps
//    (sides) s, s + 32, … and the cost-Hessian pairs after them in one
//    list; under the dual numbers, the directions and the pairs; V_T's
//    dense Hessian likewise, once per launch. The closed forms (Model::jac
//    and cost_derivs) run on thread 0.
//  - Q-terms: one thread per output entry (fuᵀVxx, qu, qx, Vxx·fx, then
//    the upper triangles of Quu/QuuF and Qxx, and Qux), each with
//    sweep_step.cuh's fold_add and structural kinds, the kinds read from a
//    table in shared memory filled at compile-time indices.
//  - QP, 5 ≤ m ≤ 24: the masked Cholesky by columns (thread j forms L[j][i]
//    with chol_masked's k order, its rows of QuuF and L in registers;
//    thread i the pivot and its 1/√d, shared by a shuffle; the
//    non-positive-pivot flag OR-ed over the warp); the QP's vectors
//    replicated in every thread's registers, so that each solve runs on
//    every thread at once (free_rows' n right-hand sides one a thread),
//    gradient rows and the KKT mask (a ballot) by row, each of the
//    ladder's five candidates and its value (pn_val) on a thread of its
//    own, and the serial strict-< selection on every thread.
//  - QP, the quadrotor (box4): the 15 free-subset adjugates one a thread;
//    the 81 candidates in itertools.product order over the threads, each
//    one thread's; the winner is the lowest (value, index) among each
//    thread's strict minima below the 3e38 sentinel, reduced over the warp
//    by shuffles, which is the serial strict-<, first-wins rule. Without
//    limits the Newton step runs on every thread.
//  - dV, the gnorm term and the divergence latch on thread 0; each Vxx
//    upper-triangle entry, each Quu·k entry and then each vx entry on a
//    thread of its own; thread q < m(n + 1) stores gain entry q.
// A team whose lane lies past B (in the last block) returns after the
// block's one barrier, before it reads or writes anything.
#pragma once

#include <type_traits>

#include "kernels.cuh"

namespace sweep_team {

constexpr int kTeam = 32;  // threads per lane: one warp
// Lanes per block. Timed on an H100 at chip_smoke.py phase 3's shapes
// (B = 1024) against 1, 2 and 8, ms of thruster_ring's analytic / fd / jvp
// rows: 6.451 / 8.794 / 8.208 at 1, 6.323 / 8.712 / 8.152 at 2,
// 6.442 / 8.752 / 8.205 at 4, 6.474 / 8.780 / 8.277 at 8; of the
// quadrotor's fd + RK4 row 2.799, 2.726, 2.685, 2.742. Every choice puts
// about 8 warps on each SM at B = 1024; no count was fastest on every row.
constexpr int kLanes = 4;
constexpr int kBlock = kTeam * kLanes;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLadder = 5;  // projected Newton's step sizes 1, ½, … 1/16

// The structural kinds of the step's factors (sweep::Kinds) as a table in
// shared memory, for the entries a thread picks at run time. Under the dense
// policies every kind is 'x' and no table is kept.
template <class Model>
struct KindTable {
  static constexpr int N = Model::N, M = Model::M;
  char fx[N][N], fu[N][M], cxx[N][N], cxu[N][M], cuu[M][M];
};

template <class Model, class Deriv>
using KindStore =
    std::conditional_t<Deriv::kDense, char, KindTable<Model>>;

template <class Model, class Deriv>
struct Kinds {
  const KindStore<Model, Deriv>* tab;
#define ILQR_KIND(NAME)                                              \
  __device__ __forceinline__ char NAME(int r, int c) const {        \
    if constexpr (Deriv::kDense) return 'x';                         \
    else return tab->NAME[r][c];                                     \
  }
  ILQR_KIND(fx)
  ILQR_KIND(fu)
  ILQR_KIND(cxx)
  ILQR_KIND(cxu)
  ILQR_KIND(cuu)
#undef ILQR_KIND
};

// Fills the table at compile-time indices (one thread)
template <class Model, class Deriv>
__device__ __forceinline__ void fill_kinds(KindStore<Model, Deriv>& t) {
  if constexpr (!Deriv::kDense) {
    constexpr int N = Model::N, M = Model::M;
    using Kd = sweep::Kinds<Model, Deriv>;
#pragma unroll
    for (int r = 0; r < N; ++r) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        t.fx[r][i] = Kd::fx(r, i);
        t.cxx[r][i] = Kd::cxx(r, i);
      }
#pragma unroll
      for (int j = 0; j < M; ++j) {
        t.fu[r][j] = Kd::fu(r, j);
        t.cxu[r][j] = Kd::cxu(r, j);
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) t.cuu[i][j] = Kd::cuu(i, j);
  }
}

// The row stride of the m × m matrices (Quu, QuuF, L, Lᵀ): a multiple of 4,
// so that a row is read as float4s, and an odd one of them, so that the
// float4s of eight threads' own rows fall in distinct banks
template <int M>
constexpr int kStride = ((M + 3) / 4 * 4) % 8 == 0 ? (M + 3) / 4 * 4 + 4
                                                  : (M + 3) / 4 * 4;

// One lane's state in shared memory
template <class Model>
struct Lane {
  static constexpr int N = Model::N, M = Model::M, NZ = N + M;
  static constexpr int MP = kStride<M>;
  typename Model::Params p;
  float x[N], u[M];            // (x_t, u_t)
  float vx[N], vxx[N][N];      // the V-carry
  float fx[N][N], fu[N][M], cx[N], cu[M], cxx[N][N], cxu[N][M], cuu[M][M];
  float fvv[M][N], qx[N], w[N][N];   // fuᵀVxx, Qx, Vxx·fx
  alignas(16) float quu[M][MP], quuF[M][MP];
  alignas(16) float qu[MP], lo[MP], hi[MP];   // Qu, the box relative to u
  float qux[M][N], qxx[N][N];
  float k[M];                  // the step
  float Krow[M][N], quu_k[M];  // the feedback rows, Quu·k
  bool isf[M];                 // the QP's free dims
  union {
    float side[2 * NZ][N + 1];  // the stencils' perturbed steps and costs
    struct {                    // projected Newton (m ≥ 5)
      alignas(16) float L[M][MP], Lt[M][MP], rdiag[MP], v[MP];
    } pn;
    struct {                    // the enumeration (m = 4)
      float adj[16][4][4], rdet[16], best[4];
    } e4;
  } scr;
};

// The pair (a, b ≥ a) that is the q-th of fd.cuh's and jvp.cuh's loops over
// nz directions
__device__ __forceinline__ void pair_of(int q, int nz, int& a, int& b) {
  a = 0;
  while (q >= nz - a) {
    q -= nz - a;
    ++a;
  }
  b = a + q;
}

// The first of a thread's items in a list that starts at item `at` of the
// team's round-robin (thread r takes the items ≡ r mod kTeam)
__device__ __forceinline__ int first_item(int rank, int at) {
  return ((rank - at) % kTeam + kTeam) % kTeam;
}

// A running-cost Hessian entry of the pair (a, b ≥ a), placed and mirrored
// as fd::linearize places it
template <class Model>
__device__ __forceinline__ void put_hessian(Lane<Model>& s, int a, int b,
                                            float h) {
  constexpr int N = Model::N;
  if (b < N) {
    s.cxx[a][b] = h;
    s.cxx[b][a] = h;
  } else if (a < N) {
    s.cxu[a][b - N] = h;
  } else {
    s.cuu[a - N][b - N] = h;
    s.cuu[b - N][a - N] = h;
  }
}

// --- V_T (sweep::terminal_init) from x_T in s.x
template <class Model, class Deriv>
__device__ __forceinline__ void terminal(Lane<Model>& s,
                                         const typename Model::Params& p,
                                         const Deriv& d, int rank) {
  constexpr int N = Model::N, M = Model::M;
  if constexpr (!Deriv::kDense) {
    if (rank == 0) {
      float xT[N], vx[N], cxx_diag[N];
#pragma unroll
      for (int i = 0; i < N; ++i) xT[i] = s.x[i];
      Model::final_cost_derivs(p, xT, vx, cxx_diag);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s.vx[i] = vx[i];
#pragma unroll
        for (int j = 0; j < N; ++j) s.vxx[i][j] = (i == j) ? cxx_diag[i] : 0.0f;
      }
    }
  } else {
    float xT[N], u0[M];
#pragma unroll
    for (int i = 0; i < N; ++i) xT[i] = s.x[i];
#pragma unroll
    for (int j = 0; j < M; ++j) u0[j] = 0.0f;
    constexpr int NP = N * (N + 1) / 2;
    for (int q = rank; q < N + NP; q += kTeam) {
      float v;
      int a = q, b = q;
      if (q < N) {
        if constexpr (std::is_same_v<Deriv, sweep::FiniteDiff>) {
          float xp[N], up[M], xm[N], um[M];
          fd::shift<Model>(xT, u0, a, -1, 0.0f, d.s.eps, true, xp, up);
          fd::shift<Model>(xT, u0, a, -1, 0.0f, d.s.eps, false, xm, um);
          v = (Model::final_cost(p, xp) - Model::final_cost(p, xm)) / d.s.den1;
        } else {
          jvp::D1 xd[N], ud[M];
          jvp::seed1<Model>(xT, u0, a, xd, ud);
          v = Model::final_cost(p, xd).d;
        }
        s.vx[a] = v;
      } else {
        pair_of(q - N, N, a, b);
        if constexpr (std::is_same_v<Deriv, sweep::FiniteDiff>) {
          v = fd::second<Model, false>(p, xT, u0, a, b, d.s);
        } else {
          jvp::D2 xd[N], ud[M];
          jvp::seed2<Model>(xT, u0, a, b, xd, ud);
          v = Model::final_cost(p, xd).d.d;
        }
        s.vxx[a][b] = v;
        s.vxx[b][a] = v;
      }
    }
  }
  __syncwarp();
}

// --- the step's derivatives at (s.x, s.u) into fx, fu, cx, cu, cxx, cxu,
// cuu (sweep::step's linearization)
template <class Model, class Deriv>
__device__ __forceinline__ void linearize(Lane<Model>& s,
                                          const typename Model::Params& p,
                                          const Deriv& d, int rank) {
  constexpr int N = Model::N, M = Model::M, NZ = N + M;
  constexpr int NP = NZ * (NZ + 1) / 2;
  float x[N], u[M];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = s.x[i];
#pragma unroll
  for (int j = 0; j < M; ++j) u[j] = s.u[j];
  if constexpr (!Deriv::kDense) {
    // fx = I + dt·A, fu = dt·B (Euler), the cost's analytic derivatives
    if (rank == 0) {
      float A[N][N], Bu[N][M];
      d.template jac<Model>(p, x, u, A, Bu);
#pragma unroll
      for (int r = 0; r < N; ++r) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const char ak = Model::a_kind(r, i);
          if (ak == 'x')
            s.fx[r][i] = (r == i) ? p.dt * A[r][i] + 1.0f : p.dt * A[r][i];
          else if (ak == '1')
            s.fx[r][i] = (r == i) ? p.dt + 1.0f : p.dt;
          else
            s.fx[r][i] = (r == i) ? 1.0f : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const char bk = Model::b_kind(r, j);
          s.fu[r][j] =
              bk == 'x' ? p.dt * Bu[r][j] : (bk == '1' ? p.dt : 0.0f);
        }
      }
      float cx[N], cu[M], cxx[N][N], cxu[N][M], cuu[M][M];
      Model::cost_derivs(p, x, u, cx, cu, cxx, cxu, cuu);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s.cx[i] = cx[i];
#pragma unroll
        for (int j = 0; j < N; ++j)
          if (Model::cxx_kind(i, j) == 'x') s.cxx[i][j] = cxx[i][j];
#pragma unroll
        for (int j = 0; j < M; ++j)
          if (Model::cxu_kind(i, j) == 'x') s.cxu[i][j] = cxu[i][j];
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
        s.cu[i] = cu[i];
#pragma unroll
        for (int j = 0; j < M; ++j)
          if (Model::cuu_kind(i, j) == 'x') s.cuu[i][j] = cuu[i][j];
      }
    }
  } else if constexpr (std::is_same_v<Deriv, sweep::FiniteDiff>) {
    const fd::Stencil& st = d.s;
    // the 2·nz sides (z + eps·t_a on even items, z − eps·t_a on odd ones:
    // the step and the running cost there), then the Hessian pairs
    for (int q = rank; q < 2 * NZ + NP; q += kTeam) {
      if (q < 2 * NZ) {
        float xq[N], uq[M], y[N];
        fd::shift<Model>(x, u, q >> 1, -1, 0.0f, st.eps, (q & 1) == 0, xq,
                         uq);
        integrate::step<Model>(p, xq, uq, st.scheme, y);
#pragma unroll
        for (int r = 0; r < N; ++r) s.scr.side[q][r] = y[r];
        s.scr.side[q][N] = Model::cost(p, xq, uq);
      } else {
        int a, b;
        pair_of(q - 2 * NZ, NZ, a, b);
        put_hessian(s, a, b, fd::second<Model, true>(p, x, u, a, b, st));
      }
    }
    __syncwarp();
    // the difference quotients, one entry a thread
    for (int e = rank; e < NZ * (N + 1); e += kTeam) {
      const int a = e / (N + 1), r = e % (N + 1);
      const float v = (s.scr.side[2 * a][r] - s.scr.side[2 * a + 1][r])
                      / st.den1;
      if (r < N) {
        if (a < N)
          s.fx[r][a] = v;
        else
          s.fu[r][a - N] = v;
      } else if (a < N) {
        s.cx[a] = v;
      } else {
        s.cu[a - N] = v;
      }
    }
  } else {
    // one first-order dual pass per direction, then the pairs
    for (int q = rank; q < NZ + NP; q += kTeam) {
      if (q < NZ) {
        jvp::D1 xd[N], ud[M], y[N];
        jvp::seed1<Model>(x, u, q, xd, ud);
        integrate::step<Model, jvp::D1>(p, xd, ud, d.scheme, y);
        const float dc = Model::cost(p, xd, ud).d;
        if (q < N) {
#pragma unroll
          for (int r = 0; r < N; ++r) s.fx[r][q] = y[r].d;
          s.cx[q] = dc;
        } else {
#pragma unroll
          for (int r = 0; r < N; ++r) s.fu[r][q - N] = y[r].d;
          s.cu[q - N] = dc;
        }
      } else {
        int a, b;
        pair_of(q - NZ, NZ, a, b);
        jvp::D2 xd[N], ud[M];
        jvp::seed2<Model>(x, u, a, b, xd, ud);
        put_hessian(s, a, b, Model::cost(p, xd, ud).d.d);
      }
    }
  }
  __syncwarp();
}

// --- the Q-terms (sweep::step, ref ilqr_core.cpp:359-363), one entry a
// thread in two rounds: fvv, qu, qx, w; then Quu/QuuF, Qux, Qxx (and the
// box relative to u)
template <class Model, bool kLimits, class Deriv>
__device__ __forceinline__ void q_terms(Lane<Model>& s,
                                        const typename Model::Params& p,
                                        const Kinds<Model, Deriv>& kd,
                                        float lam, int rank) {
  constexpr int N = Model::N, M = Model::M;
  // round 1
  constexpr int A1 = M * N, A2 = A1 + M, A3 = A2 + N;
  for (int e = rank; e < A1; e += kTeam) {   // fvv[jm][jn] = Σ fu·Vxx
    const int jm = e / N, jn = e % N;
    float acc = 0.0f;
    bool live = false;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (kd.fu(i, jm) != '.')
        sweep::fold_add(acc, live, s.fu[i][jm] * s.vxx[i][jn]);
    s.fvv[jm][jn] = acc;
  }
  for (int jm = first_item(rank, A1); jm < M; jm += kTeam) {   // qu
    float acc = s.cu[jm];
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (kd.fu(i, jm) != '.') acc = acc + s.fu[i][jm] * s.vx[i];
    s.qu[jm] = acc;
  }
  for (int jn = first_item(rank, A2); jn < N; jn += kTeam) {   // qx
    float ax = s.cx[jn];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const char fk = kd.fx(i, jn);
      if (fk == '1') ax = ax + s.vx[i];
      if (fk == 'x') ax = ax + s.fx[i][jn] * s.vx[i];
    }
    s.qx[jn] = ax;
  }
  for (int e = first_item(rank, A3); e < N * N; e += kTeam) {  // w = Vxx fx
    const int kk = e / N, j = e % N;
    float acc = 0.0f;
    bool live = false;
#pragma unroll
    for (int l = 0; l < N; ++l) {
      const char fk = kd.fx(l, j);
      if (fk == '1') sweep::fold_add(acc, live, s.vxx[kk][l]);
      if (fk == 'x') sweep::fold_add(acc, live, s.vxx[kk][l] * s.fx[l][j]);
    }
    s.w[kk][j] = acc;
  }
  __syncwarp();
  // round 2
  constexpr int U = M * (M + 1) / 2, B1 = U + M * N;
  constexpr int B2 = B1 + N * (N + 1) / 2;
  {   // the upper triangle of Quu and QuuF
    int im = 0, row0 = 0;   // row0: the index of (im, im)
    for (int e = rank; e < U; e += kTeam) {
      while (e >= row0 + (M - im)) {
        row0 += M - im;
        ++im;
      }
      const int jm = im + (e - row0);
      float acc = 0.0f;
      bool live = false;
      if (kd.cuu(im, jm) == 'x') {
        acc = s.cuu[im][jm];
        live = true;
      }
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (kd.fu(i, jm) != '.')
          sweep::fold_add(acc, live, s.fvv[im][i] * s.fu[i][jm]);
      s.quu[im][jm] = acc;
      s.quu[jm][im] = acc;
      const float f = (im == jm) ? acc + lam : acc;
      s.quuF[im][jm] = f;
      s.quuF[jm][im] = f;
    }
  }
  for (int e = first_item(rank, U); e < M * N; e += kTeam) {   // Qux
    const int jm = e / N, jn = e % N;
    float aq = 0.0f;
    bool live = false;
    if (kd.cxu(jn, jm) == 'x') {
      aq = s.cxu[jn][jm];
      live = true;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const char fk = kd.fx(i, jn);
      if (fk == '1') sweep::fold_add(aq, live, s.fvv[jm][i]);
      if (fk == 'x') sweep::fold_add(aq, live, s.fvv[jm][i] * s.fx[i][jn]);
    }
    s.qux[jm][jn] = aq;
  }
  {   // the upper triangle of Qxx = cxx + fxᵀ Vxx fx
    int i = 0, row0 = 0;
    for (int e = first_item(rank, B1); e < N * (N + 1) / 2; e += kTeam) {
      while (e >= row0 + (N - i)) {
        row0 += N - i;
        ++i;
      }
      const int j = i + (e - row0);
      float acc = 0.0f;
      bool live = false;
      if (kd.cxx(i, j) == 'x') {
        acc = s.cxx[i][j];
        live = true;
      }
#pragma unroll
      for (int kk = 0; kk < N; ++kk) {
        const char fk = kd.fx(kk, i);
        if (fk == '1') sweep::fold_add(acc, live, s.w[kk][j]);
        if (fk == 'x') sweep::fold_add(acc, live, s.fx[kk][i] * s.w[kk][j]);
      }
      s.qxx[i][j] = acc;
      s.qxx[j][i] = acc;
    }
  }
  if constexpr (kLimits) {
    for (int j = first_item(rank, B2); j < M; j += kTeam) {
      s.lo[j] = Model::u_lo(p, j) - s.u[j];
      s.hi[j] = Model::u_hi(p, j) - s.u[j];
    }
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// The QP for 5 ≤ m ≤ 24 (qp.cuh pn, newton, free_rows), spread over the team
//
// Thread j < m keeps row j of QuuF and, while it factors, row j of L in
// registers; the QP's vectors (the iterate, a solve's right-hand side and
// solution) are replicated in every thread's registers, where each thread
// forms the entries it needs, and the free mask travels as a ballot. A
// solve runs on every thread at once (the same values), reading the rows
// of L and of Lᵀ from shared memory as float4 broadcasts. A loop that one
// thread ran over shared memory issued a warp-wide instruction for every
// element it read, and the ~8 warps on an SM share one pipe for those.
// The loops over the controls unroll: m is a compile-time constant.
// ---------------------------------------------------------------------------

// entry j (a compile-time index) of v
__device__ __forceinline__ float part(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// entries [from, to) of a 16-byte aligned row padded to a multiple of 4,
// read as float4s, into out (from and to compile-time after unrolling)
template <int M>
__device__ __forceinline__ void load_row(const float* row, int from, int to,
                                         float out[M]) {
#pragma unroll
  for (int c = 0; c < M; c += 4) {
    if (c + 3 >= from && c < to) {
      const float4 v = *reinterpret_cast<const float4*>(row + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j >= from && c + j < to) out[c + j] = part(v, j);
    }
  }
}

// entry i (a run-time index) of a register vector
template <int M>
__device__ __forceinline__ float pick(const float v[M], int i) {
  float r = 0.0f;
#pragma unroll
  for (int j = 0; j < M; ++j)
    if (j == i) r = v[j];
  return r;
}

// entry i of the free mask as the f32 0/1 the serial QP carries
__device__ __forceinline__ float ffv(unsigned mask, int i) {
  return (mask >> i) & 1u ? 1.0f : 0.0f;
}

// qp::chol_masked of mask(q) by columns, q's row j in Qr on thread j: for
// column i, thread j > i forms L[j][i] and thread i the pivot and rdiag[i],
// each sum over k in chol_masked's order, row i read as float4 broadcasts;
// each entry is stored to L and to Lᵀ. Returns on every thread whether a
// free dim has a non-positive pivot.
template <int M, int S>
__device__ __forceinline__ bool chol(const float Qr[M], unsigned ff,
                                     float (*L)[S], float (*Lt)[S],
                                     float* rdiag, int rank) {
  bool bad = false;
  const float ffj = ffv(ff, rank);
  float Lr[M];   // row `rank` of L
#pragma unroll
  for (int k = 0; k < M; ++k) Lr[k] = 0.0f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float Li[M];   // row i of L, entries k < i
    load_row<M>(L[i], 0, i, Li);
    const float ffi = ffv(ff, i);
    float acc = rank == i ? ffi * Qr[i] + (1.0f - ffi) : ffi * ffj * Qr[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - Lr[k] * Li[k];
    float rd = 0.0f;
    if (rank == i) {
      bad = bad || (ffi > 0.5f && acc <= 0.0f);
      const float d_safe = acc <= 0.0f ? 1.0f : acc;
      rd = 1.0f / sqrtf(d_safe);
      rdiag[i] = rd;
      Lr[i] = d_safe * rd;
    }
    rd = __shfl_sync(kFull, rd, i);
    if (rank > i) Lr[i] = acc * rd;
    if (rank >= i && rank < M) {
      L[rank][i] = Lr[i];
      Lt[i][rank] = Lr[i];
    }
    __syncwarp();
  }
  return __any_sync(kFull, bad);
}

// qp::chol_solve of L·Lᵀ·x = b on every calling thread, v in registers
// holding b and then x: forward substitution along the rows of L, back
// substitution along the rows of Lᵀ (the columns of L)
template <int M, int S>
__device__ __forceinline__ void solve(const float (*L)[S],
                                      const float (*Lt)[S],
                                      const float* rdiag, float v[M]) {
  float rd[M];
  load_row<M>(rdiag, 0, M, rd);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float Li[M];
    load_row<M>(L[i], 0, i, Li);
    float acc = v[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - Li[k] * v[k];
    v[i] = acc * rd[i];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float Ci[M];   // L[k][i], k > i
    load_row<M>(Lt[i], i + 1, M, Ci);
    float acc = v[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) acc = acc - Ci[k] * v[k];
    v[i] = acc * rd[i];
  }
}

// qp::pn_val (½xᵀqx + gᵀx: the diagonal terms first, then q_ij·x_i·x_j over
// i < j) of the register vector x, q's rows read as float4 broadcasts
template <int M, int S>
__device__ __forceinline__ float pn_val(const float (*q)[S], const float* g,
                                        const float x[M]) {
  float gr[M];
  load_row<M>(g, 0, M, gr);
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < M; ++i)
    v = v + gr[i] * x[i] + 0.5f * q[i][i] * x[i] * x[i];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float Qi[M];
    load_row<M>(q[i], i + 1, M, Qi);
#pragma unroll
    for (int j = i + 1; j < M; ++j) v = v + Qi[j] * x[i] * x[j];
  }
  return v;
}

// qp::pn on (QuuF, Qu, lo, hi) into s.k, s.isf; returns bad. The first
// pass (it = −1) is the all-free solve from −g, clipped; each later pass
// the KKT mask, the masked factorization and solve, and the ladder, whose
// candidate c thread c forms and values.
template <class Model>
__device__ __forceinline__ bool pn(Lane<Model>& s, int rank) {
  constexpr int M = Model::M, S = Lane<Model>::MP;
  auto& P = s.scr.pn;
  const int r = rank < M ? rank : 0;   // the row a thread holds
  float Qr[M];
  load_row<M>(s.quuF[r], 0, M, Qr);
  const float gi = s.qu[r], loi = s.lo[r], hii = s.hi[r];
  unsigned ff = (1u << M) - 1u;
  float x[M];
#pragma unroll
  for (int i = 0; i < M; ++i) x[i] = 0.0f;
  float v_cur = 0.0f;
  bool bad = false;
#pragma unroll 1
  for (int it = -1; it < M + 6; ++it) {
    if (it >= 0) {   // the KKT active set at x
      float gr = gi;
#pragma unroll
      for (int j = 0; j < M; ++j) gr = gr + Qr[j] * x[j];
      ff = __ballot_sync(kFull, rank < M
                         && !qp::kkt_clamped(pick<M>(x, r), gr, loi, hii));
    }
    const bool bad_it = chol<M, S>(Qr, ff, P.L, P.Lt, P.rdiag, rank);
    bad = bad || bad_it;
    float rhs = -gi;
    if (it >= 0) {
      float acc = gi;
#pragma unroll
      for (int j = 0; j < M; ++j)
        acc = acc + Qr[j] * ((1.0f - ffv(ff, j)) * x[j]);
      rhs = ffv(ff, r) * acc;
    }
    if (rank < M) P.v[rank] = rhs;
    __syncwarp();
    float d[M], lo[M], hi[M];
    load_row<M>(P.v, 0, M, d);
    load_row<M>(s.lo, 0, M, lo);
    load_row<M>(s.hi, 0, M, hi);
    solve<M, S>(P.L, P.Lt, P.rdiag, d);
    if (it < 0) {
#pragma unroll
      for (int i = 0; i < M; ++i) x[i] = jnp::clip(d[i], lo[i], hi[i]);
      v_cur = pn_val<M, S>(s.quuF, s.qu, x);
    } else {
      float xn[M];
#pragma unroll
      for (int i = 0; i < M; ++i)
        xn[i] = ffv(ff, i) * (-d[i]) + (1.0f - ffv(ff, i)) * x[i];
      // candidate c = rank < 5 at step 2^−c, clipped, and its value
      float step = 1.0f;
#pragma unroll
      for (int c = 0; c + 1 < kLadder; ++c)
        if (c < rank) step = step * 0.5f;
      float v_own = 0.0f;
      if (rank < kLadder) {
        float cand[M];
#pragma unroll
        for (int i = 0; i < M; ++i)
          cand[i] = jnp::clip(x[i] + step * (xn[i] - x[i]), lo[i], hi[i]);
        v_own = pn_val<M, S>(s.quuF, s.qu, cand);
      }
      // the serial selection, on every thread: the best strictly below the
      // current value, the first of equals; its candidate formed again
      float v_best = v_cur;
      int sel = -1;
#pragma unroll
      for (int c = 0; c < kLadder; ++c) {
        const float v_c = __shfl_sync(kFull, v_own, c);
        if (v_c < v_best) {
          v_best = v_c;
          sel = c;
        }
      }
      if (sel >= 0) {
        float st = 1.0f;
#pragma unroll
        for (int c = 0; c + 1 < kLadder; ++c)
          if (c < sel) st = st * 0.5f;
#pragma unroll
        for (int i = 0; i < M; ++i)
          x[i] = jnp::clip(x[i] + st * (xn[i] - x[i]), lo[i], hi[i]);
      }
      v_cur = v_best;
    }
    __syncwarp();   // P.v, L and Lᵀ read before the next pass writes them
  }
  float gr = gi;
#pragma unroll
  for (int j = 0; j < M; ++j) gr = gr + Qr[j] * x[j];
  if (rank < M) {
    const float xi = pick<M>(x, rank);
    s.isf[rank] = !qp::kkt_clamped(xi, gr, loi, hii) && !bad;
    s.k[rank] = bad ? 0.0f : xi;
  }
  __syncwarp();
  return bad;
}

// qp::newton for m ≥ 5: the all-free Cholesky and one solve
template <class Model>
__device__ __forceinline__ bool newton(Lane<Model>& s, int rank) {
  constexpr int M = Model::M, S = Lane<Model>::MP;
  auto& P = s.scr.pn;
  float Qr[M];
  load_row<M>(s.quuF[rank < M ? rank : 0], 0, M, Qr);
  const bool bad = chol<M, S>(Qr, (1u << M) - 1u, P.L, P.Lt, P.rdiag, rank);
  if (rank < M) P.v[rank] = -s.qu[rank];
  __syncwarp();
  float x[M];
  load_row<M>(P.v, 0, M, x);
  solve<M, S>(P.L, P.Lt, P.rdiag, x);
  if (rank < M) {
    s.k[rank] = bad ? 0.0f : pick<M>(x, rank);
    s.isf[rank] = !bad;
  }
  __syncwarp();
  return bad;
}

// qp::free_rows for m ≥ 5: one masked Cholesky; thread i < n solves column
// i of Qux and writes column i of the feedback rows
template <class Model>
__device__ __forceinline__ void free_rows(Lane<Model>& s, int rank) {
  constexpr int N = Model::N, M = Model::M, S = Lane<Model>::MP;
  auto& P = s.scr.pn;
  const int r = rank < M ? rank : 0;
  float Qr[M];
  load_row<M>(s.quuF[r], 0, M, Qr);
  const unsigned ff = __ballot_sync(kFull, rank < M && s.isf[r]);
  chol<M, S>(Qr, ff, P.L, P.Lt, P.rdiag, rank);
  if (rank < N) {
    float v[M];
#pragma unroll
    for (int j = 0; j < M; ++j) v[j] = s.qux[j][rank];
    solve<M, S>(P.L, P.Lt, P.rdiag, v);
#pragma unroll
    for (int j = 0; j < M; ++j)
      s.Krow[j][rank] = (ff >> j) & 1u ? -v[j] : 0.0f;
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// The QP for m = 4 (qp.cuh box4, newton<4>, free_rows<4, N>)
// ---------------------------------------------------------------------------

template <class Model>
__device__ __forceinline__ void load4(const Lane<Model>& s, float q[4][4],
                                      float g[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    g[i] = s.qu[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) q[i][j] = s.quuF[i][j];
  }
}

// thread S − 1 forms the adjugate and reciprocal determinant of free subset
// S (qp::fill_shared4's)
template <class Model, unsigned S>
__device__ __forceinline__ void fill_subsets(const float q[4][4],
                                             Lane<Model>& s, int rank) {
  if (rank == static_cast<int>(S) - 1) {
    float adj[4][4];
    s.scr.e4.rdet[S] = 1.0f / qp::safe(qp::adj_det<S>(q, adj));
    constexpr int k = qp::popc(S);
#pragma unroll
    for (int a = 0; a < k; ++a)
#pragma unroll
      for (int b = 0; b < k; ++b) s.scr.e4.adj[S][a][b] = adj[a][b];
  }
  if constexpr (S < 15u) fill_subsets<Model, S + 1u>(q, s, rank);
}

// Candidate C of qp::cand4 with C a run-time index: its point x, whether it
// satisfies the KKT conditions and its value
template <class Model>
__device__ __forceinline__ void cand4_at(int C, const Lane<Model>& s,
                                         const float q[4][4],
                                         const float g[4], float x[4],
                                         bool& ok, float& v) {
  const unsigned F = qp::free_mask(C, 4);
  const int nf = qp::popc(F);
  int dg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dg[i] = qp::digit(C, i, 4);
    x[i] = dg[i] == 0 ? s.lo[i] : s.hi[i];
  }
  if (nf > 0) {
    float rhs[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (a < nf) {
        const int i = qp::nth_bit(F, a);
        float acc = s.qu[i];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (dg[j] != 1) acc = acc + s.quuF[i][j] * x[j];
        rhs[a] = acc;
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (a < nf) {
        float sa = s.scr.e4.adj[F][a][0] * rhs[0];
#pragma unroll
        for (int b = 1; b < 4; ++b)
          if (b < nf) sa = sa + s.scr.e4.adj[F][a][b] * rhs[b];
        const float xv = -sa * s.scr.e4.rdet[F];
        const int i = qp::nth_bit(F, a);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c == i) x[c] = xv;
      }
    }
  }
  ok = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float gr = g[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) gr = gr + q[i][j] * x[j];
    ok = ok && (dg[i] == 1 ? (x[i] >= s.lo[i] && x[i] <= s.hi[i])
                           : (dg[i] == 0 ? gr >= 0.0f : gr <= 0.0f));
  }
  v = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v = v + g[i] * x[i] + 0.5f * q[i][i] * x[i] * x[i];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = i + 1; j < 4; ++j) v = v + q[i][j] * x[i] * x[j];
}

// qp::box4: the 81 candidates over the team; returns bad
template <class Model>
__device__ __forceinline__ bool box4(Lane<Model>& s, int rank) {
  constexpr int kCands = 81;
  float q[4][4], g[4];
  load4(s, q, g);
  const bool bad = qp::sylvester_bad4(q);
  fill_subsets<Model, 1u>(q, s, rank);
  __syncwarp();
  float bv = qp::kBig, bx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int bc = kCands;
  for (int C = rank; C < kCands; C += kTeam) {
    float x[4], v;
    bool ok;
    cand4_at(C, s, q, g, x, ok, v);
    if (ok && v < bv) {
      bv = v;
      bc = C;
#pragma unroll
      for (int i = 0; i < 4; ++i) bx[i] = x[i];
    }
  }
  // the lowest (value, index) over the team: no value is NaN, and equal
  // values go to the lower index, as the serial strict < leaves them
  const int own = bc;
#pragma unroll
  for (int off = kTeam / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, off);
    const int oc = __shfl_xor_sync(kFull, bc, off);
    if (ov < bv || (ov == bv && oc < bc)) {
      bv = ov;
      bc = oc;
    }
  }
  if (bc < kCands && own == bc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s.scr.e4.best[i] = bx[i];
  }
  __syncwarp();
  if (rank < 4) {
    const bool won = bc < kCands;
    s.k[rank] = bad ? 0.0f : (won ? s.scr.e4.best[rank] : 0.0f);
    s.isf[rank] = won && qp::digit(bc, rank, 4) == 1 && !bad;
  }
  __syncwarp();
  return bad;
}

// qp::newton<4> on every thread (the same values), stored by thread 0
template <class Model>
__device__ __forceinline__ bool newton4(Lane<Model>& s, int rank) {
  float q[4][4], g[4], k[4];
  bool isf[4], bad;
  load4(s, q, g);
  qp::newton<4>(q, g, k, isf, bad);
  if (rank == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s.k[j] = k[j];
      s.isf[j] = isf[j];
    }
  }
  __syncwarp();
  return bad;
}

// qp::free_rows<4, N>: the adjugate of the masked QuuF on every thread,
// column i of the feedback rows on thread i < N
template <class Model>
__device__ __forceinline__ void free_rows4(Lane<Model>& s, int rank) {
  constexpr int N = Model::N;
  float q[4][4], g[4];
  bool isf[4];
  load4(s, q, g);
#pragma unroll
  for (int j = 0; j < 4; ++j) isf[j] = s.isf[j];
  float P[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    P[i][i] = isf[i] ? q[i][i] : 1.0f;
#pragma unroll
    for (int j = i + 1; j < 4; ++j) {
      P[i][j] = (isf[i] && isf[j]) ? q[i][j] : 0.0f;
      P[j][i] = P[i][j];
    }
  }
  float adj[4][4];
  const float rdet = 1.0f / qp::nonzero(qp::adj_det<0xFu>(P, adj));
  for (int i = rank; i < N; i += kTeam) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float sj = adj[j][0] * s.qux[0][i];
#pragma unroll
      for (int b = 1; b < 4; ++b) sj = sj + adj[j][b] * s.qux[b][i];
      s.Krow[j][i] = isf[j] ? -sj * rdet : 0.0f;
    }
  }
  __syncwarp();
}

// The accumulators thread 0 carries (sweep::Carry's scalars)
struct Acc {
  float dv0 = 0.0f, dv1 = 0.0f, div = 0.0f, gacc = 0.0f;
};

// One backward step at (s.x, s.u): the gains of step t stored to k_out,
// K_out; the V-carry in s advanced; thread 0's accumulators advanced
template <class Model, bool kLimits, class Deriv>
__device__ __forceinline__ void step(Lane<Model>& s,
                                     const typename Model::Params& p,
                                     const Deriv& d,
                                     const Kinds<Model, Deriv>& kd, float lam,
                                     int rank, Acc& acc, int t, size_t B,
                                     int lane, float* __restrict__ k_out,
                                     float* __restrict__ K_out) {
  constexpr int N = Model::N, M = Model::M;
  static_assert(M == 4 || M >= 5, "the team sweep covers m = 4 and m >= 5");
  linearize<Model>(s, p, d, rank);
  q_terms<Model, kLimits>(s, p, kd, lam, rank);

  // --- the QP and the feedback rows
  bool bad;
  if constexpr (M >= 5) {
    if constexpr (kLimits)
      bad = pn(s, rank);
    else
      bad = newton(s, rank);
    free_rows(s, rank);
  } else {
    if constexpr (kLimits)
      bad = box4(s, rank);
    else
      bad = newton4(s, rank);
    free_rows4(s, rank);
  }

  // --- the gains of step t; the divergence latch, dV and the gnorm term on
  // thread 0; each Vxx entry and each Quu·k entry on a thread of its own
  constexpr int G = M * (N + 1);
  for (int q = rank; q < G; q += kTeam) {
    if (q < M)
      k_out[(static_cast<size_t>(t) * M + q) * B + lane] = s.k[q];
    else
      K_out[(static_cast<size_t>(t) * M * N + (q - M)) * B + lane] =
          (&s.Krow[0][0])[q - M];
  }
  if (rank == 0) {
    acc.div = fmaxf(acc.div, bad ? 1.0f : 0.0f);
    float d0 = s.k[0] * s.qu[0];
#pragma unroll 1
    for (int jm = 1; jm < M; ++jm) d0 = d0 + s.k[jm] * s.qu[jm];
    float d1 = 0.0f;
#pragma unroll 1
    for (int im = 0; im < M; ++im)
#pragma unroll 8
      for (int jm = 0; jm < M; ++jm) {
        const float tt = 0.5f * s.k[im] * s.quu[im][jm] * s.k[jm];
        d1 = (im == 0 && jm == 0) ? tt : d1 + tt;
      }
    acc.dv0 = acc.dv0 + d0;
    acc.dv1 = acc.dv1 + d1;
    float gstep = fabsf(s.k[0]) / (fabsf(s.u[0]) + 1.0f);
#pragma unroll 1
    for (int jm = 1; jm < M; ++jm)
      gstep = jnp::maximum(gstep, fabsf(s.k[jm]) / (fabsf(s.u[jm]) + 1.0f));
    acc.gacc = acc.gacc + gstep;
  }
  constexpr int NV = N * (N + 1) / 2;
  {   // Vxx[i][j], j ≥ i, on threads 1 … NV (items 1 … NV)
    int i = 0, row0 = 0;
    for (int e = first_item(rank, 1); e < NV; e += kTeam) {
      while (e >= row0 + (N - i)) {
        row0 += N - i;
        ++i;
      }
      const int j = i + (e - row0);
      float a = s.qxx[i][j];
#pragma unroll 1
      for (int cm = 0; cm < M; ++cm) {
#pragma unroll 8
        for (int dd = 0; dd < M; ++dd)
          a = a + s.Krow[cm][i] * s.quu[cm][dd] * s.Krow[dd][j];
        a = a + s.Krow[cm][i] * s.qux[cm][j] + s.qux[cm][i] * s.Krow[cm][j];
      }
      s.vxx[i][j] = a;
      s.vxx[j][i] = a;
    }
  }
  for (int im = first_item(rank, 1 + NV); im < M; im += kTeam) {
    float a = s.quu[im][0] * s.k[0];
#pragma unroll 4
    for (int jm = 1; jm < M; ++jm) a = a + s.quu[im][jm] * s.k[jm];
    s.quu_k[im] = a;
  }
  __syncwarp();
  for (int i = rank; i < N; i += kTeam) {   // vx
    float a = s.qx[i];
#pragma unroll 4
    for (int cm = 0; cm < M; ++cm)
      a = a + s.Krow[cm][i] * s.quu_k[cm] + s.Krow[cm][i] * s.qu[cm]
          + s.qux[cm][i] * s.k[cm];
    s.vx[i] = a;
  }
  __syncwarp();
}

// The merged sweep of lane `lane` on its warp, its state in s: p and x_T
// loaded, V_T, then the T steps from T − 1 down, the gains of each stored to
// k_out, K_out. Returns thread 0's accumulators (the other threads' are
// zero).
template <class Model, bool kLimits, class Deriv>
__device__ __forceinline__ Acc sweep_lane(
    Lane<Model>& s, const Kinds<Model, Deriv>& kd,
    const float* __restrict__ params, int pstride,
    const float* __restrict__ xs, const float* __restrict__ xterm,
    const float* __restrict__ us, float lm, int T, size_t B, int lane,
    const Deriv& d, int rank, float* __restrict__ k_out,
    float* __restrict__ K_out) {
  constexpr int N = Model::N, M = Model::M, NZ = N + M;
  static_assert(NZ <= kTeam, "a team loads (x_t, u_t), one entry a thread");
  if (rank == 0) s.p = fused::load_lane<Model>(params, pstride, lane);
  if (rank < N) s.x[rank] = xterm[rank * B + lane];
  __syncwarp();
  const typename Model::Params& p = s.p;
  terminal<Model>(s, p, d, rank);
  Acc acc;
  // (x_t, u_t) one entry a thread, loaded one step ahead
  auto load = [&](int t) {
    if (rank < N) return xs[(static_cast<size_t>(t) * N + rank) * B + lane];
    if (rank < NZ)
      return us[(static_cast<size_t>(t) * M + rank - N) * B + lane];
    return 0.0f;
  };
  float next = T > 0 ? load(T - 1) : 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    if (rank < N)
      s.x[rank] = next;
    else if (rank < NZ)
      s.u[rank - N] = next;
    if (t > 0) next = load(t - 1);
    __syncwarp();
    step<Model, kLimits>(s, p, d, kd, lm, rank, acc, t, B, lane, k_out,
                         K_out);
  }
  return acc;
}

template <class Model, bool kLimits, class Deriv>
__global__ void __launch_bounds__(kBlock)
sweep_team_kernel(const float* __restrict__ params, int pstride,
                  const float* __restrict__ xs,
                  const float* __restrict__ xterm,
                  const float* __restrict__ us,
                  const float* __restrict__ lam, float* __restrict__ k_out,
                  float* __restrict__ K_out, float* __restrict__ dv,
                  float* __restrict__ div, float* __restrict__ gnorm, int T,
                  int B_, Deriv d) {
  extern __shared__ float4 smem[];
  __shared__ KindStore<Model, Deriv> kinds;
  if (threadIdx.x == 0) fill_kinds<Model, Deriv>(kinds);
  __syncthreads();
  const int rank = threadIdx.x % kTeam;
  const int lane = blockIdx.x * kLanes + threadIdx.x / kTeam;
  if (lane >= B_) return;   // the whole team: no barrier follows
  Lane<Model>& s = reinterpret_cast<Lane<Model>*>(smem)[threadIdx.x / kTeam];
  const size_t B = B_;
  const Acc acc = sweep_lane<Model, kLimits>(
      s, Kinds<Model, Deriv>{&kinds}, params, pstride, xs, xterm, us,
      lam[lane], T, B, lane, d, rank, k_out, K_out);
  if (rank == 0) {
    dv[lane] = acc.dv0;
    dv[B + lane] = acc.dv1;
    div[lane] = acc.div;
    gnorm[lane] = acc.gacc * static_cast<float>(1.0 / T);
  }
}

// A block's dynamic shared memory (kLanes lanes' state), and the status of
// the call that allows kernel K, a team kernel of this model, that much:
// made once per kernel (and so once per process: the port drives one card
// a process)
template <class Model, auto K>
inline int prepare(size_t& smem) {
  smem = kLanes * sizeof(Lane<Model>);
  static const int err = (int)cudaFuncSetAttribute(
      K, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kLanes * sizeof(Lane<Model>)));
  return err;
}

}  // namespace sweep_team

namespace fused {

// Whether a model's merged sweep is the team kernel: the models with
// m·n ≥ 32, which take the split iteration (fused._use_iter_kernel), where
// the team covers them (m ≥ 4, n + m ≤ 32: every such model of the package).
// A model opts out with static constexpr bool kTeamSweep = false, as every
// custom model does (custom.cuh DensePattern: a generated model with
// m·n ≥ 32 keeps the one-thread sweep and iteration); the other models'
// dense sweeps take the team of their whole iteration where they have one
// (kSweepKind below), custom models' included.
template <class Model>
constexpr bool kTeamSweepRule = Model::M >= 4 &&
                                Model::M * Model::N >= 32 &&
                                Model::N + Model::M <= sweep_team::kTeam;
template <class Model, class = void>
struct TeamSweep {
  static constexpr bool value = kTeamSweepRule<Model>;
};
template <class Model>
struct TeamSweep<Model, std::void_t<decltype(Model::kTeamSweep)>> {
  static constexpr bool value = Model::kTeamSweep && kTeamSweepRule<Model>;
};

// The kernel of a model's merged sweep: the warp where TeamSweep picks it
// (m·n ≥ 32), the team of the model's whole iteration where it has one
// (TeamIteration; 16 threads a lane or 32, team::kTeamWidth) and the
// derivatives are dense (the stencils, the dual numbers: their sides,
// passes and Hessian pairs spread over the team), else the one-thread
// kernel: custom models outside custom::team_iteration's rule, and the
// closed forms (Analytic), of which the team spreads only Model::jac while
// each of its threads runs the whole Riccati step. Timed on an H100 (700 W) against the one-thread kernel, parent and
// change in turns, four passes each (tools/sweep_ab.py): the team's closed
// forms 0.48× on acrobot (B = 8192, T = 499: 1.31-1.40 ms against
// 0.61-0.71), 0.72-0.95× on the m = 2-3 models and pendulum, 1.11× on
// cartpole (B = 1024); its dense forms 1.34-3.79× but acrobot's jvp + RK4
// (0.98×, where one thread a lane already fills the card).
template <class Model, class Deriv>
constexpr int kSweepKind = TeamSweep<Model>::value ? 2
                           : TeamIteration<Model>::value && Deriv::kDense
                               ? 1
                               : 0;

template <class Model, bool kLimits, class Deriv>
constexpr auto sweep_kernel_of() {
  if constexpr (kSweepKind<Model, Deriv> == 2)
    return sweep_team::sweep_team_kernel<Model, kLimits, Deriv>;
  else if constexpr (kSweepKind<Model, Deriv> == 1)
    return team::sweep_small_team_kernel<Model, kLimits, Deriv,
                                         team::kTeamWidth<Model>>;
  else
    return sweep_kernel<Model, kLimits, Deriv>;
}

// The launch geometry of that kernel: threads and lanes a block, dynamic
// shared memory (with the allowance the warp kernel needs, set once);
// returns the status of that call
template <class Model, bool kLimits, class Deriv>
inline int sweep_geometry(int& threads, int& lanes, size_t& smem) {
  smem = 0;
  if constexpr (kSweepKind<Model, Deriv> == 2) {
    threads = sweep_team::kBlock;
    lanes = sweep_team::kLanes;
    return sweep_team::prepare<
        Model, sweep_team::sweep_team_kernel<Model, kLimits, Deriv>>(smem);
  } else if constexpr (kSweepKind<Model, Deriv> == 1) {
    threads = team::kBlock;
    lanes = team::kBlock / team::kTeamWidth<Model>;
  } else {
    threads = kBlock;
    lanes = kBlock;
  }
  return 0;
}

// The sweep launch of ILQR_SPLIT_LAUNCHERS, ILQR_FD_SWEEP_LAUNCHER and
// ILQR_JVP_SWEEP_LAUNCHER: the model's one kernel, chosen at compile time,
// with limits (the box QP) or without
template <class Model, class Deriv>
inline int launch_model_sweep(const void* params, int pstride, const void* xs,
                              const void* xterm, const void* us,
                              const void* lam, void* k, void* K, void* dv,
                              void* div, void* gnorm, int T, int B,
                              int use_limits, Deriv d, void* stream) {
  int threads = 0, lanes = 1;
  size_t smem = 0;
  const int err =
      use_limits ? sweep_geometry<Model, true, Deriv>(threads, lanes, smem)
                 : sweep_geometry<Model, false, Deriv>(threads, lanes, smem);
  if (err != 0) return err;
  const auto kernel = use_limits ? sweep_kernel_of<Model, true, Deriv>()
                                 : sweep_kernel_of<Model, false, Deriv>();
  kernel<<<(B + lanes - 1) / lanes, threads, smem, (cudaStream_t)stream>>>(
      (const float*)params, pstride, (const float*)xs, (const float*)xterm,
      (const float*)us, (const float*)lam, (float*)k, (float*)K, (float*)dv,
      (float*)div, (float*)gnorm, T, B, d);
  return (int)cudaGetLastError();
}

// Blocks an SM holds at once of the sweep kernel that launch_model_sweep
// launches (and the threads and dynamic shared memory bytes of each); -1
// where a CUDA call fails
template <class Model, class Deriv>
inline int sweep_blocks_per_sm(int use_limits, int* threads, int* smem_bytes) {
  int n = 0, lanes = 1;
  size_t smem = 0;
  const int err =
      use_limits ? sweep_geometry<Model, true, Deriv>(*threads, lanes, smem)
                 : sweep_geometry<Model, false, Deriv>(*threads, lanes, smem);
  if (err != 0) return -1;
  *smem_bytes = static_cast<int>(smem);
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n,
      use_limits ? sweep_kernel_of<Model, true, Deriv>()
                 : sweep_kernel_of<Model, false, Deriv>(),
      *threads, smem);
  return occ == cudaSuccess ? n : -1;
}

// Threads a lane of the sweep kernel that launch_model_sweep launches: 1
// (the one-thread kernel), 16 or 32 (the team), 32 (the warp)
template <class Model, class Deriv>
constexpr int sweep_lane_threads() {
  return kSweepKind<Model, Deriv> == 2   ? sweep_team::kTeam
         : kSweepKind<Model, Deriv> == 1 ? team::kTeamWidth<Model>
                                         : 1;
}

}  // namespace fused
