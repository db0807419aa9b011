// iteration_packed (one whole solver iteration) as a team of W threads per
// lane, for the models that opt in with Model::kTeamIteration: half a warp
// (W = 16) for acrobot, cartpole and pendulum (m = 1, n = 4, 4, 2), a whole
// warp (W = 32) for double_integrator, bicycle, power_mass (m = 2, n = 4)
// and point_mass_3d (m = 3, n = 6), whose stencil sides, Hessian pairs or
// gain entries a half warp does not hold (kTeamWidth), and every custom
// model (ops/codegen.py) inside custom.cuh's team_iteration rule (m·n < 32,
// 2(n + m) ≤ 32, m(n + 1) ≤ 32: the unicycle and unicycle_heading of
// examples/custom_model.py on half a warp). The one-thread
// iteration_kernel of kernels.cuh redesigned for this card. The models with
// m·n ≥ 32 take iteration_warp.cuh's warp per lane; a custom model outside
// the rule keeps the one-thread kernel. The same models' merged sweep
// (sweep_packed, the split iteration) in its stencil and dual-number forms
// is phase 0 below alone, on the same team (sweep_small_team_kernel, in
// place of kernels.cuh sweep_kernel, which their closed forms keep:
// sweep_team.cuh kSweepKind).
//
// Replaces: ilqr_tpu/ops/pallas_iter.py iteration_packed (_iter_kernel), as
// kernels.cuh iteration_kernel does, on the same inputs, outputs and gain
// buffer, with the same launcher names and signatures; and
// ilqr_tpu/ops/pallas_sweep.py sweep_packed (_kernel) for these models, as
// kernels.cuh sweep_kernel does.
// Bound on this card: as the one-thread kernel's, latency first. One thread
// per lane left two warps on an SM at B = 8192 (one block of 64 each), and
// used 16 of the 132 SMs at B = 1024, so every dependent instruction's
// latency was exposed, and a lane's independent work ran in series on its
// thread: the 2(n + m) stencil steps (under RK4 four dynamics calls each)
// and (n + m)(n + m + 1)/2 cost-Hessian pairs of every time step, and the A
// line-search candidates (the m = 2-3 models: 150-255 registers, bicycle
// spilling, point_mass_3d a 704 B stack).
// Design: a team of W threads serves one lane; a block of kBlock = 128
// threads serves 128 / W lanes (8 for W = 16, 4 for W = 32), so B = 1024 is
// 128 or 256 blocks. All exchange within a team is __shfl_sync over the
// team's part of the warp (width W): the team shares no memory and meets no
// block barrier (a __syncwarp over the team orders what one thread of it
// stores to device memory before another reads or overwrites it). A
// shuffle moves a value and never sums one, and each output element is
// computed by one thread with the one-thread kernel's operations in its
// order, so the results are that kernel's bit for bit.
//  - Phase 0, the merged linearize + backward sweep. Under FiniteDiff,
//    thread 2a evaluates the plus side of direction a (the perturbed step
//    and running cost) and thread 2a + 1 the minus side, and thread q takes
//    the Hessian pairs q, q + W, … (a, b ≥ a) of the running cost (two
//    rounds for point_mass_3d's 45 on a warp); under Jvp thread a takes
//    direction a's first-order dual pass and thread q the second-order
//    passes q, q + W, …. Every thread then gathers all entries by shuffles
//    and runs the Riccati step (sweep::step) on its own copy of the
//    V-carry, with no further exchange; thread q < m(n + 1) stores entry q
//    of the step's gains (k_t, then K_t row-major) into k_out and K_out.
//    V_T is computed by every thread, once. The team's limits: 2(n + m)
//    ≤ W stencil sides (acrobot and cartpole 10, pendulum 6, the m = 2
//    models 12, point_mass_3d 18) and m(n + 1) ≤ W gain entries (5, 3, 10,
//    21); Hessian pairs (15, 6, 21, 45) any number, in rounds.
//  - Phases 1-2, the line search of linesearch_team.cuh (team::line_search)
//    on the gains in k_out and K_out, its segment states in the gain buffer,
//    a scratch here (S ≤ W segments). Where the new gains are not kept, the
//    team copies the previous ones over them.
// The closed-form derivatives of phase 0 (Model::jac) do not depend on
// the V-carry, so they too are spread: thread r evaluates them for step
// t − r of each block of W steps t, t − 1, …, and each step gathers them.
// A team whose lane lies past B (the last block's) reads lane B − 1, runs
// no time step and writes nothing; it still meets every shuffle of its own
// team, and no thread returns early.
#pragma once

#include <type_traits>

#include "linesearch_team.cuh"

namespace team {

// Blocks an SM is to hold, for W = 16: registers capped at 128 a thread,
// which the analytic form fits without spills and the stencil and
// dual-number forms with a few dozen bytes. Timed on an H100 at B = 8192,
// T = 499 against 2, 3, 5, 6 and 8 blocks (acrobot): fewer leave the dense
// forms' latency exposed, more spill them heavily.
constexpr int kMinBlocks = 4;
// … and for W = 32 (the m = 2-3 models, B = 1024: 256 blocks, two an SM
// fill the card). Timed on an H100 (700 W) on the stencil rows at B = 1024,
// four readings each, 2 / 3 / 4 blocks: point_mass_3d 1.57-1.71 /
// 1.76-1.89 / 1.88-2.04 ms (more blocks spill its 255 registers' worth);
// double_integrator 0.61-0.64 / 0.53-0.60 / 0.59-0.73, bicycle 0.56-0.61 /
// 0.50-0.63 / 0.52-0.62, power_mass 0.60-0.66 / 0.58-0.72 / 0.59-0.67,
// overlapping. So 2.
constexpr int kMinBlocks32 = 2;
template <int W>
constexpr int kMinBlocksOf = W == kTeam ? kMinBlocks : kMinBlocks32;
// The split-sweep team kernel (sweep_small_team_kernel, below) takes the
// same two constants: it holds no line-search candidates, but phase 0 sets
// its registers. Timed on an H100 (700 W) at phase 3's shapes, two
// readings each, min blocks 2 / 3 / 4 / 5 / 6 at W = 16: acrobot fd (B =
// 8192) 4.14-4.23 / 4.20-4.30 / 3.42-3.57 / 3.62-3.63 / 4.01-4.10 ms,
// acrobot analytic 1.30-1.32 / 1.28-1.31 / 1.27-1.35 / 1.23-1.33 /
// 1.41-1.46, cartpole fd 0.72-0.81 / 0.75-0.80 / 0.79 / 0.80-0.88 /
// 0.86-0.89, cartpole jvp + RK4 1.27 / 1.29-1.34 / 1.40-1.41 / 1.42-1.51 /
// 1.50-1.52, pendulum fd 0.36-0.37 / 0.38 / 0.39-0.40 / 0.33-0.35 /
// 0.33-0.37; 1 / 2 / 3 at W = 32: point_mass_3d fd 1.26-1.35 / 1.27-1.49 /
// 1.53-1.56 (3 spills 468 B), its jvp + RK4 1.10-1.16 / 1.09-1.20 /
// 1.33-1.36, power_mass fd 0.40-0.43 / 0.41-0.45 / 0.42-0.43. No count
// wins every row beyond the others' spread; 4 and 2 take acrobot's fd row,
// the largest, and the rest overlap.

// The team of W threads of this thread: half a warp or the warp
template <int W>
__device__ __forceinline__ TeamOf<W> team_of() {
  if constexpr (W == kTeam)
    return half_warp();
  else
    return {static_cast<int>(threadIdx.x % 32), 0xffffffffu};
}

// The team width of a model's whole iteration: half a warp where it holds
// the model's stencil sides, Hessian pairs and gain entries one a thread,
// else the warp
template <class Model>
constexpr int kTeamWidth =
    2 * (Model::N + Model::M) <= kTeam
            && (Model::N + Model::M) * (Model::N + Model::M + 1) / 2 <= kTeam
            && Model::M * (Model::N + 1) <= kTeam
        ? kTeam
        : 32;

// The pair (a, b ≥ a) that is the q-th of fd.cuh's and jvp.cuh's loops
// over n + m = NZ directions
template <int NZ>
__device__ __forceinline__ void pair_of(int q, int& a, int& b) {
  a = 0;
  b = 0;
  int i = 0;
#pragma unroll
  for (int aa = 0; aa < NZ; ++aa)
#pragma unroll
    for (int bb = aa; bb < NZ; ++bb, ++i)
      if (i == q) {
        a = aa;
        b = bb;
      }
}

// Pair rounds of a team of W: thread r takes pairs r, r + W, …
template <class Model, int W>
constexpr int kRounds =
    ((Model::N + Model::M) * (Model::N + Model::M + 1) / 2 + W - 1) / W;

// Every team thread receives what its team computed: column a of (fx | fu)
// and entry a of (cx | cu) from thread a · stride, the Hessian of pair q
// from thread q mod W (its round q / W), placed and mirrored as
// fd::linearize places them.
template <class Model, int W>
__device__ __forceinline__ void gather(
    const TeamOf<W>& tm, int stride, const float col[Model::N], float dcol,
    const float h[kRounds<Model, W>], float fx[Model::N][Model::N],
    float fu[Model::N][Model::M], float cx[Model::N], float cu[Model::M],
    float cxx[Model::N][Model::N],
    float cxu[Model::N][Model::M], float cuu[Model::M][Model::M]) {
  constexpr int N = Model::N, M = Model::M, NZ = N + M;
#pragma unroll
  for (int a = 0; a < NZ; ++a) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float v = tm.from(col[r], a * stride);
      if (a < N)
        fx[r][a] = v;
      else
        fu[r][a - N] = v;
    }
    const float v = tm.from(dcol, a * stride);
    if (a < N)
      cx[a] = v;
    else
      cu[a - N] = v;
  }
  int q = 0;
#pragma unroll
  for (int a = 0; a < NZ; ++a)
#pragma unroll
    for (int b = a; b < NZ; ++b, ++q) {
      const float v = tm.from(h[q / W], q % W);
      if (b < N) {
        cxx[a][b] = v;
        cxx[b][a] = v;
      } else if (a < N) {
        cxu[a][b - N] = v;
      } else {
        cuu[a - N][b - N] = v;
        cuu[b - N][a - N] = v;
      }
    }
}

// sweep::FiniteDiff spread over the team (fd.cuh's arithmetic, term by term)
template <int W>
struct FiniteDiff {
  static constexpr bool kDense = true;
  sweep::FiniteDiff d;
  TeamOf<W> tm;

  template <class Model>
  __device__ __forceinline__ void linearize(
      const typename Model::Params& p, const float x[Model::N],
      const float u[Model::M], float fx[Model::N][Model::N],
      float fu[Model::N][Model::M], float cx[Model::N], float cu[Model::M],
      float cxx[Model::N][Model::N], float cxu[Model::N][Model::M],
      float cuu[Model::M][Model::M]) const {
    constexpr int N = Model::N, M = Model::M, NZ = N + M;
    constexpr int NP = NZ * (NZ + 1) / 2, R = kRounds<Model, W>;
    static_assert(2 * NZ <= W, "a team holds both sides of every direction");
    const fd::Stencil& s = d.s;
    // one side of direction a = rank / 2: z + eps·t_a on even ranks,
    // z − eps·t_a on odd ones
    float y[N], c = 0.0f;
#pragma unroll
    for (int r = 0; r < N; ++r) y[r] = 0.0f;
    if (tm.rank < 2 * NZ) {
      float xq[N], uq[M];
      fd::shift<Model>(x, u, tm.rank >> 1, -1, 0.0f, s.eps,
                       (tm.rank & 1) == 0, xq, uq);
      integrate::step<Model>(p, xq, uq, s.scheme, y);
      c = Model::cost(p, xq, uq);
    }
    // the plus side forms the difference quotients (odd ranks form
    // unused ones)
    const int minus = tm.rank | 1;
    float col[N];
#pragma unroll
    for (int r = 0; r < N; ++r)
      col[r] = (y[r] - tm.from(y[r], minus)) / s.den1;
    const float dcol = (c - tm.from(c, minus)) / s.den1;
    float h[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      h[r] = 0.0f;
      if (tm.rank + r * W < NP) {
        int a, b;
        pair_of<NZ>(tm.rank + r * W, a, b);
        h[r] = fd::second<Model, true>(p, x, u, a, b, s);
      }
    }
    gather<Model, W>(tm, 2, col, dcol, h, fx, fu, cx, cu, cxx, cxu, cuu);
  }
  template <class Model>
  __device__ __forceinline__ void terminal(
      const typename Model::Params& p, const float xT[Model::N],
      float vx[Model::N], float vxx[Model::N][Model::N]) const {
    d.template terminal<Model>(p, xT, vx, vxx);
  }
};

// sweep::Jvp spread over the team (jvp.cuh's arithmetic, term by term)
template <int W>
struct Jvp {
  static constexpr bool kDense = true;
  sweep::Jvp d;
  TeamOf<W> tm;

  template <class Model>
  __device__ __forceinline__ void linearize(
      const typename Model::Params& p, const float x[Model::N],
      const float u[Model::M], float fx[Model::N][Model::N],
      float fu[Model::N][Model::M], float cx[Model::N], float cu[Model::M],
      float cxx[Model::N][Model::N], float cxu[Model::N][Model::M],
      float cuu[Model::M][Model::M]) const {
    constexpr int N = Model::N, M = Model::M, NZ = N + M;
    constexpr int NP = NZ * (NZ + 1) / 2, R = kRounds<Model, W>;
    static_assert(NZ <= W, "a team holds every direction");
    float col[N], dcol = 0.0f;
#pragma unroll
    for (int r = 0; r < N; ++r) col[r] = 0.0f;
    if (tm.rank < NZ) {
      jvp::D1 xd[N], ud[M], y[N];
      jvp::seed1<Model>(x, u, tm.rank, xd, ud);
      integrate::step<Model, jvp::D1>(p, xd, ud, d.scheme, y);
      dcol = Model::cost(p, xd, ud).d;
#pragma unroll
      for (int r = 0; r < N; ++r) col[r] = y[r].d;
    }
    float h[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      h[r] = 0.0f;
      if (tm.rank + r * W < NP) {
        int a, b;
        pair_of<NZ>(tm.rank + r * W, a, b);
        jvp::D2 xd[N], ud[M];
        jvp::seed2<Model>(x, u, a, b, xd, ud);
        h[r] = Model::cost(p, xd, ud).d.d;
      }
    }
    gather<Model, W>(tm, 1, col, dcol, h, fx, fu, cx, cu, cxx, cxu, cuu);
  }
  template <class Model>
  __device__ __forceinline__ void terminal(
      const typename Model::Params& p, const float xT[Model::N],
      float vx[Model::N], float vxx[Model::N][Model::N]) const {
    d.template terminal<Model>(p, xT, vx, vxx);
  }
};

// sweep::Analytic with A and Bu evaluated ahead by another thread of the
// team (the kernel's phase 0): their live entries, row-major
struct Analytic {
  static constexpr bool kDense = false;
  const float* a;   // N × N
  const float* bu;  // N × M

  template <class Model>
  __device__ __forceinline__ void jac(const typename Model::Params&,
                                      const float*, const float*,
                                      float A[Model::N][Model::N],
                                      float Bu[Model::N][Model::M]) const {
    constexpr int N = Model::N, M = Model::M;
#pragma unroll
    for (int r = 0; r < N; ++r) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (Model::a_kind(r, i) == 'x') A[r][i] = a[r * N + i];
#pragma unroll
      for (int j = 0; j < M; ++j)
        if (Model::b_kind(r, j) == 'x') Bu[r][j] = bu[r * M + j];
    }
  }
};

// The derivative source of phase 0: the dense ones spread over the team,
// the closed forms as they are
template <int W>
__device__ __forceinline__ sweep::Analytic spread(sweep::Analytic d,
                                                  const TeamOf<W>&) {
  return d;
}
template <int W>
__device__ __forceinline__ FiniteDiff<W> spread(sweep::FiniteDiff d,
                                                const TeamOf<W>& tm) {
  return {d, tm};
}
template <int W>
__device__ __forceinline__ Jvp<W> spread(sweep::Jvp d, const TeamOf<W>& tm) {
  return {d, tm};
}

// Phase 0, the merged linearize + backward sweep of one lane, on its team:
// the gains of every step into k_out and K_out (thread q stores entry q of
// a row), V_T from xterm; returns the carry, the same on every thread of
// the team. A team that runs Tl = 0 steps (a lane past B) stores nothing.
// The whole-iteration team kernel and the split-sweep team kernel both run
// it.
template <class Model, bool kLimits, class Deriv, int W>
__device__ __forceinline__ sweep::Carry<Model> sweep_phase(
    const TeamOf<W>& tm, const typename Model::Params& p,
    const float* __restrict__ xs, const float* __restrict__ xterm,
    const float* __restrict__ us, float lm, int Tl, size_t B, int ln,
    float* __restrict__ k_out, float* __restrict__ K_out, const Deriv& d) {
  constexpr int N = Model::N, M = Model::M, G = M * (N + 1);
  static_assert(G <= W, "a team stores a gain row, one entry a thread");
  const auto dd = spread(d, tm);
  sweep::Carry<Model> c;
  {
    float xT[N];
#pragma unroll
    for (int i = 0; i < N; ++i) xT[i] = xterm[i * B + ln];
    sweep::terminal_init<Model>(p, xT, dd, c);
  }
  // (x_t, u_t) loaded one step ahead, as the rollouts load their rows
  float xn[N], un[M];
  auto load_xu = [&](int t, float xv[N], float uv[M]) {
#pragma unroll
    for (int i = 0; i < N; ++i) xv[i] = xs[(t * N + i) * B + ln];
#pragma unroll
    for (int j = 0; j < M; ++j) uv[j] = us[(t * M + j) * B + ln];
  };
  if (Tl > 0) load_xu(Tl - 1, xn, un);
  // under the closed forms, thread r evaluates Model::jac at step t − r
  // for each block of W steps t, t − 1, …, and each step takes the
  // live entries of its A and Bu from that thread (a discarded branch
  // under the dense forms, the only ones of a custom model, which has no
  // Model::jac)
  [[maybe_unused]] float a_own[N * N], bu_own[N * M];
  for (int t = Tl - 1; t >= 0; --t) {
    float x[N], u[M];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = xn[i];
#pragma unroll
    for (int j = 0; j < M; ++j) u[j] = un[j];
    if (t > 0) load_xu(t - 1, xn, un);
    float k[M], Kr[M][N];
    if constexpr (std::is_same_v<Deriv, sweep::Analytic>) {
      const int r = (Tl - 1 - t) % W;   // the step's place in its block
      if (r == 0 && t - tm.rank >= 0) {
        float xj[N], uj[M], A[N][N], Bu[N][M];
        load_xu(t - tm.rank, xj, uj);
        Model::jac(p, xj, uj, A, Bu);
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
          for (int j = 0; j < N; ++j)
            if (Model::a_kind(i, j) == 'x') a_own[i * N + j] = A[i][j];
#pragma unroll
          for (int j = 0; j < M; ++j)
            if (Model::b_kind(i, j) == 'x') bu_own[i * M + j] = Bu[i][j];
        }
      }
      float a[N * N], bu[N * M];
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j)
          if (Model::a_kind(i, j) == 'x')
            a[i * N + j] = tm.from(a_own[i * N + j], r);
#pragma unroll
        for (int j = 0; j < M; ++j)
          if (Model::b_kind(i, j) == 'x')
            bu[i * M + j] = tm.from(bu_own[i * M + j], r);
      }
      sweep::step<Model, kLimits>(p, x, u, lm, Analytic{a, bu}, c, k, Kr);
    } else {
      sweep::step<Model, kLimits>(p, x, u, lm, dd, c, k, Kr);
    }
    float v = 0.0f;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (tm.rank == j) v = k[j];
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (tm.rank == M + j * N + i) v = Kr[j][i];
    }
    if (tm.rank < M)
      k_out[(static_cast<size_t>(t) * M + tm.rank) * B + ln] = v;
    else if (tm.rank < G)
      K_out[(static_cast<size_t>(t) * M * N + tm.rank - M) * B + ln] = v;
  }
  return c;
}

template <class Model, bool kLimits, class Deriv, int W>
__global__ void __launch_bounds__(kBlock, kMinBlocksOf<W>)
iteration_team_kernel(const float* __restrict__ params, int pstride,
                      const float* __restrict__ x0,
                      const float* __restrict__ xs,
                      const float* __restrict__ xterm,
                      const float* __restrict__ us,
                      const float* __restrict__ Kold,
                      const float* __restrict__ kold,
                      const float* __restrict__ alphas, int A,
                      const float* __restrict__ lam,
                      const float* __restrict__ cprev,
                      const float* __restrict__ live,
                      float* __restrict__ xs_out, float* __restrict__ us_out,
                      float* __restrict__ xfin, float* __restrict__ k_out,
                      float* __restrict__ K_out, float* __restrict__ lscost,
                      float* __restrict__ alpha_sel, float* __restrict__ acc,
                      float* __restrict__ dcost,
                      float* __restrict__ expected,
                      float* __restrict__ div_out,
                      float* __restrict__ gnorm_out, float* gains,
                      float z_min, float tol_grad, float lam_grad_term, int T,
                      int B_, int clamp, int scheme, Deriv d) {
  constexpr int N = Model::N, M = Model::M, G = M * (N + 1);
  static_assert(fused::kMaxA <= W, "a team holds every candidate");
  const TeamOf<W> tm = team_of<W>();
  const int lane = blockIdx.x * (kBlock / W) + threadIdx.x / W;
  const bool valid = lane < B_;
  const int ln = valid ? lane : B_ - 1;  // where a team past B reads
  const int Tl = valid ? T : 0;          // … and the steps it runs
  const bool writer = valid && tm.rank == 0;
  const size_t B = B_;
  const typename Model::Params p = fused::load_lane<Model>(params, pstride,
                                                           ln);

  // phase 0: merged linearize + backward sweep, the gains into k_out, K_out
  const float lm = lam[ln];
  const sweep::Carry<Model> c = sweep_phase<Model, kLimits, Deriv, W>(
      tm, p, xs, xterm, us, lm, Tl, B, ln, k_out, K_out, d);
  // the gain rows the team stored, visible to every thread of it
  __syncwarp(tm.mask);
  const float gn = c.gacc * static_cast<float>(1.0 / T);
  if (writer) {
    div_out[lane] = c.div;
    gnorm_out[lane] = gn;
  }
  const float okf = 1.0f - c.div;
  const float gtf = okf * (gn < tol_grad ? 1.0f : 0.0f)
                    * (lm < lam_grad_term ? 1.0f : 0.0f);
  const float gate = okf * (1.0f - gtf) * live[ln];  // take-step gate
  const float keep = okf * live[ln];                 // gain-keep gate

  // phases 1-2: the line search on the new gains, the gain buffer its
  // scratch; the previous gains copied over the new ones where not kept
  const rollout::Selection s = line_search<Model>(
      tm, p, x0, us, xs, xterm,
      rollout::Gains<Model>{k_out, K_out, M * B, M * N * B, B}, kold, Kold,
      alphas, A, cprev[ln], c.dv0, c.dv1, z_min, gate, keep > 0.5f, T, B, ln,
      valid, clamp != 0, scheme, Segments(T, A, G, N, W), gains, xs_out,
      us_out, xfin, k_out, K_out);
  if (writer) {
    lscost[lane] = s.cost;
    alpha_sel[lane] = s.alpha;
    acc[lane] = s.accepted;
    dcost[lane] = s.dcost;
    expected[lane] = s.expected;
  }
}

// sweep_packed of the same models (their split iteration, iter_kernel=
// "split") with the stencils or the dual numbers: phase 0 alone, on the
// whole-iteration kernel's team and blocks, then dv, div and gnorm from
// thread 0 of each team. Replaces kernels.cuh sweep_kernel for these
// models and forms, on the same inputs and outputs, with the same launcher
// names and signatures (fused::launch_model_sweep, sweep_team.cuh).
template <class Model, bool kLimits, class Deriv, int W>
__global__ void __launch_bounds__(kBlock, kMinBlocksOf<W>)
sweep_small_team_kernel(const float* __restrict__ params, int pstride,
                        const float* __restrict__ xs,
                        const float* __restrict__ xterm,
                        const float* __restrict__ us,
                        const float* __restrict__ lam,
                        float* __restrict__ k_out, float* __restrict__ K_out,
                        float* __restrict__ dv, float* __restrict__ div,
                        float* __restrict__ gnorm, int T, int B_, Deriv d) {
  const TeamOf<W> tm = team_of<W>();
  const int lane = blockIdx.x * (kBlock / W) + threadIdx.x / W;
  const bool valid = lane < B_;
  const int ln = valid ? lane : B_ - 1;  // where a team past B reads
  const size_t B = B_;
  const typename Model::Params p = fused::load_lane<Model>(params, pstride,
                                                           ln);
  const sweep::Carry<Model> c = sweep_phase<Model, kLimits, Deriv, W>(
      tm, p, xs, xterm, us, lam[ln], valid ? T : 0, B, ln, k_out, K_out, d);
  if (valid && tm.rank == 0) {
    dv[lane] = c.dv0;
    dv[B + lane] = c.dv1;
    div[lane] = c.div;
    gnorm[lane] = c.gacc * static_cast<float>(1.0 / T);
  }
}

}  // namespace team

namespace fused {

// Whether a model's whole iteration is the team kernel: the model says so
// with a static constexpr bool kTeamIteration = true (acrobot.cuh,
// cartpole.cuh, pendulum.cuh on half a warp; double_integrator.cuh,
// bicycle.cuh, power_mass.cuh, point_mass_3d.cuh on a warp,
// team::kTeamWidth; a generated header by custom::team_iteration(N, M));
// the team's limits hold for it (above).
template <class Model, class = void>
struct TeamIteration {
  static constexpr bool value = false;
};
template <class Model>
struct TeamIteration<Model, std::void_t<decltype(Model::kTeamIteration)>> {
  static constexpr bool value = Model::kTeamIteration;
};

}  // namespace fused
