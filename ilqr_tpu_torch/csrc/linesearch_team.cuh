// linesearch_packed (the line search + iteration epilogue) as a team of
// kTeam = 16 threads per lane, for every model of the package and every
// custom model (ops/codegen.py): the line search's one kernel, in place of
// the one-thread kernel that earlier trees ran.
// The team's two phases (line_search below) are also phases 1-2 of both
// team whole-iteration kernels: iteration_team.cuh's 16 threads per lane
// and iteration_warp.cuh's warp per lane.
//
// Replaces: ilqr_tpu/ops/pallas_rollout.py linesearch_packed (_ls_kernel),
// on its inputs and outputs (launcher ilqr_<model>_linesearch).
// Bound on this card: latency. The one-thread design of earlier trees (one
// thread per lane in blocks of 64) used 16 of the 132 SMs at B = 1024 and
// advanced its lane's A = 11 candidates in series on that thread, all A
// states at once in its registers (the quadrotor's 1.5 KB of spills,
// ring24's 4 KB).
// Design: a team of kTeam threads, half a warp, serves one lane; a block of
// kBlock = 128 threads serves kLanes = 8 lanes, so B = 1024 is 128 blocks.
//  - Phase 1: thread a < A advances candidate a alone; the shared rows (u,
//    x̄, k, K) of a time step are read by the team at one address; the A
//    costs are gathered by __shfl_sync and every thread runs
//    rollout::select on them, with the plain version's strict <.
//    Each candidate stores its state at the start of each of S ≤ kTeam
//    segments of the horizon into a scratch.
//  - Phase 2: where a step is taken, thread s rolls out segment s of the
//    selected candidate again from its stored state and writes the state,
//    so the replay takes T / S steps, not T; where none is, the team copies
//    the current state. The gains are copied by the team: the new ones
//    where they are kept, the previous ones where not.
// The scratch of this kernel is xs_out itself: the segment states of all A
// candidates fit in its T·n floats per lane when S − 1 ≤ T / A, each thread
// loads its segment's start state into registers, and the team meets a
// __syncwarp before any thread writes a row. A scratch that the wrapper
// passed would change the launcher's signature for all 14 models and the
// custom models' libraries, and cost one more allocation per launch; xs_out
// costs neither. (The whole-iteration kernels use their gain buffer.)
// Every output value is computed by one thread with the plain version's
// operations in its order (ops/kernel_rollout.linesearch_plain;
// --fmad=false); no sum is split across threads, so the results are the
// plain version's bit for bit. A team whose lane lies past B
// (the last block's) reads lane B − 1, runs no time step and writes
// nothing; it still meets every shuffle of its own team.
#pragma once

#include "kernels.cuh"

namespace team {

constexpr int kTeam = 16;               // threads per lane: half a warp
constexpr int kBlock = 128;             // threads per block
constexpr int kLanes = kBlock / kTeam;  // lanes per block

static_assert(fused::kMaxA <= kTeam, "a team holds every candidate");

// W threads of a warp that serve one lane: kTeam (half a warp) or 32
template <int W>
struct TeamOf {
  int rank;       // the thread's place in its team, 0 … W − 1
  unsigned mask;  // the team's threads of the warp

  // v as team thread src holds it
  __device__ __forceinline__ float from(float v, int src) const {
    return __shfl_sync(mask, v, src, W);
  }
  // what a thread of the team stored, visible to every other
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};
using Team = TeamOf<kTeam>;

// This thread's half-warp team
__device__ __forceinline__ Team half_warp() {
  return {static_cast<int>(threadIdx.x % kTeam),
          0xffffu << (threadIdx.x & 16u)};
}

// The shared rows of one time step that a rollout reads: u_t, x̄_t and the
// gains k_t, K_t. Where two rows fit in registers beside the step (kAhead),
// the rollouts load row t + 1 while they step through row t, so that the
// loads' latency hides behind the step; the rings' rows (K_t alone 72-144
// floats) are loaded at their step.
template <class Model>
struct Row {
  static constexpr int N = Model::N, M = Model::M;
  static constexpr bool kAhead = M + N + M + M * N <= 72;
  float u[M], xsr[N], k[M], K[M][N];

  __device__ __forceinline__ void load(const float* __restrict__ us,
                                       const float* __restrict__ xs,
                                       const rollout::Gains<Model>& g, int t,
                                       size_t B, int lane) {
#pragma unroll
    for (int j = 0; j < M; ++j) u[j] = us[(t * M + j) * B + lane];
#pragma unroll
    for (int i = 0; i < N; ++i) xsr[i] = xs[(t * N + i) * B + lane];
    g.load(t, lane, k, K);
  }
};

// Steps t0 … t1 − 1 of a rollout at step size alpha from x (advanced in
// place), as rollout::emit and rollout::candidate_costs step: before(t, x)
// ahead of step t, after(t, u) behind it with its controls u. Returns the
// sum of the running costs.
template <class Model, int kScheme, class Before, class After>
__device__ __forceinline__ float roll(const typename Model::Params& p,
                                      float x[Model::N],
                                      const float* __restrict__ us,
                                      const float* __restrict__ xs,
                                      const rollout::Gains<Model>& g,
                                      float alpha, int t0, int t1, size_t B,
                                      int lane, bool clamp, Before before,
                                      After after) {
  constexpr int M = Model::M;
  float cost = 0.0f;
  Row<Model> next;
  if constexpr (Row<Model>::kAhead)
    if (t0 < t1) next.load(us, xs, g, t0, B, lane);
  for (int t = t0; t < t1; ++t) {
    Row<Model> r;
    if constexpr (Row<Model>::kAhead) {
      r = next;
      if (t + 1 < t1) next.load(us, xs, g, t + 1, B, lane);
    } else {
      r.load(us, xs, g, t, B, lane);
    }
    before(t, x);
    float uff[M], u[M];
#pragma unroll
    for (int j = 0; j < M; ++j) uff[j] = r.u[j] + alpha * r.k[j];
    cost = cost
           + rollout::step<Model, kScheme>(p, x, uff, r.xsr, r.K, clamp, u);
    after(t, u);
  }
  return cost;
}

// Where phase 1 leaves each candidate's state for phase 2: a scratch of
// per_t floats per lane and time step holds the state x_t at the start
// t = s·L of each segment s ≥ 1 of every candidate. S segments of L steps,
// as many as it holds (S − 1 states of n floats for each of the A
// candidates), at most one a team thread (max_s).
struct Segments {
  int S, L;

  __device__ __forceinline__ Segments(int T, int A, int per_t, int n,
                                      int max_s) {
    S = min(max_s, 1 + (T * per_t) / (A * n));
    L = (T + S - 1) / S;
  }
  // the scratch row of entry i of candidate a's state at segment s ≥ 1
  __device__ __forceinline__ int row(int a, int s, int i, int n) const {
    return (a * (S - 1) + s - 1) * n + i;
  }
};

// One line-search candidate's cost: rollout::candidate_costs for the one α,
// a; its state at the start of each segment s ≥ 1 stored to the scratch.
template <class Model, int kScheme>
__device__ __forceinline__ float candidate_as(
    const typename Model::Params& p, const float x0[Model::N],
    const float* __restrict__ us, const float* __restrict__ xs,
    const rollout::Gains<Model>& g, int a, float alpha, int T, size_t B,
    int lane, bool clamp, const Segments& seg, float* scratch) {
  constexpr int N = Model::N;
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = x0[i];
  int s = 1;   // the next segment whose start is stored
  const float cost = roll<Model, kScheme>(
      p, x, us, xs, g, alpha, 0, T, B, lane, clamp,
      [&](int t, const float* xt) {
        if (s < seg.S && t == s * seg.L) {
#pragma unroll
          for (int i = 0; i < N; ++i)
            scratch[seg.row(a, s, i, N) * B + lane] = xt[i];
          ++s;
        }
      },
      [](int, const float*) {});
  return cost + Model::final_cost(p, x);
}

// Phase 2 where a step is taken: segment s of the selected candidate, steps
// t0 … t1 − 1 from x (its stored start state), rolled out again as
// rollout::emit rolls out the whole horizon, with the state written; the
// last segment writes x_T.
template <class Model, int kScheme>
__device__ __forceinline__ void emit_as(
    const typename Model::Params& p, float x[Model::N],
    const float* __restrict__ us, const float* __restrict__ xs,
    const rollout::Gains<Model>& g, float alpha, int s, int T, size_t B,
    int lane, bool clamp, const Segments& seg, float* xs_out,
    float* __restrict__ us_out, float* __restrict__ xfin_out) {
  constexpr int N = Model::N, M = Model::M;
  const int t0 = s * seg.L, t1 = min(T, t0 + seg.L);
  roll<Model, kScheme>(
      p, x, us, xs, g, alpha, t0, t1, B, lane, clamp,
      [&](int t, const float* xt) {
#pragma unroll
        for (int i = 0; i < N; ++i) xs_out[(t * N + i) * B + lane] = xt[i];
      },
      [&](int t, const float* u) {
#pragma unroll
        for (int j = 0; j < M; ++j) us_out[(t * M + j) * B + lane] = u[j];
      });
  if (t1 == T) {
#pragma unroll
    for (int i = 0; i < N; ++i) xfin_out[i * B + lane] = x[i];
  }
}

// rows [0, n) of a lane's (n, B) block copied from src to dst by the team
template <int W>
__device__ __forceinline__ void copy_rows(const TeamOf<W>& tm,
                                          const float* src, float* dst,
                                          int n, size_t B, int lane) {
  for (int r = tm.rank; r < n; r += W) dst[r * B + lane] = src[r * B + lane];
}

// Phases 1-2 of a line search on a team of W threads that serves lane ln
// (valid: ln is the team's own lane, not the last lane read by a team past
// B): the A candidates at u + α_a·k with the gains of g, the selection,
// then the post-accept state — xs, us, x_T of the selected candidate where
// a step is taken (accepted · gate > 0.5), the current ones otherwise; the
// gains of g where keep, kold and Kold otherwise, copied to k_out and K_out
// unless they are there. The candidates' segment states go to scratch,
// which may be xs_out. Returns the selection, the same on every thread.
template <class Model, int W>
__device__ __forceinline__ rollout::Selection line_search(
    const TeamOf<W>& tm, const typename Model::Params& p,
    const float* __restrict__ x0, const float* __restrict__ us,
    const float* __restrict__ xs, const float* __restrict__ xterm,
    const rollout::Gains<Model>& g, const float* __restrict__ kold,
    const float* __restrict__ Kold, const float* __restrict__ alphas, int A,
    float cprev, float dv0, float dv1, float z_min, float gate, bool keep,
    int T, size_t B, int ln, bool valid, bool clamp, int scheme,
    const Segments& seg, float* scratch, float* xs_out, float* us_out,
    float* xfin, float* k_out, float* K_out) {
  constexpr int N = Model::N, M = Model::M, kMaxA = fused::kMaxA;
  float x0v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x0v[i] = x0[i * B + ln];

  // phase 1: candidate rank, costs only (its segment states stored); then
  // every thread holds all A
  float own = 0.0f;
  if (tm.rank < A) {
    const int Tl = valid ? T : 0;   // a team past B runs no step
    const float alpha = alphas[tm.rank];
    own = scheme == integrate::kRK4
              ? candidate_as<Model, integrate::kRK4>(
                    p, x0v, us, xs, g, tm.rank, alpha, Tl, B, ln, clamp, seg,
                    scratch)
              : candidate_as<Model, integrate::kEuler>(
                    p, x0v, us, xs, g, tm.rank, alpha, Tl, B, ln, clamp, seg,
                    scratch);
  }
  float al[kMaxA], cand[kMaxA];
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) {
    al[a] = (a < A) ? alphas[a] : 0.0f;
    cand[a] = tm.from(own, a);
  }
  const rollout::Selection s = rollout::select<kMaxA>(cand, al, A, cprev,
                                                      dv0, dv1, z_min);
  const bool take = s.accepted * gate > 0.5f;

  // phase 2: where a step is taken, the selected candidate rolled out
  // again, its S segments side by side on the team, from the states phase
  // 1 stored; where none is, the current state copied by the team
  tm.sync();   // the stored states before they are read
  const bool replay = take && valid && tm.rank < seg.S && tm.rank * seg.L < T;
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    x[i] = (replay && tm.rank > 0)
               ? scratch[seg.row(s.index, tm.rank, i, N) * B + ln]
               : x0v[i];
  tm.sync();   // every start state read before a row of xs_out is written
  if (replay) {
    if (scheme == integrate::kRK4)
      emit_as<Model, integrate::kRK4>(p, x, us, xs, g, s.alpha, tm.rank, T,
                                      B, ln, clamp, seg, xs_out, us_out,
                                      xfin);
    else
      emit_as<Model, integrate::kEuler>(p, x, us, xs, g, s.alpha, tm.rank, T,
                                        B, ln, clamp, seg, xs_out, us_out,
                                        xfin);
  } else if (valid && !take) {
    copy_rows(tm, xs, xs_out, T * N, B, ln);
    copy_rows(tm, us, us_out, T * M, B, ln);
    copy_rows(tm, xterm, xfin, N, B, ln);
  }
  // the gains: the new ones where kept, else the previous ones; nothing to
  // copy where the new ones are kept in k_out and K_out already
  tm.sync();   // the new gains read by the replay before they are replaced
  const float* ksrc = keep ? g.k : kold;
  const float* Ksrc = keep ? g.K : Kold;
  if (valid && ksrc != k_out) copy_rows(tm, ksrc, k_out, T * M, B, ln);
  if (valid && Ksrc != K_out) copy_rows(tm, Ksrc, K_out, T * M * N, B, ln);
  return s;
}

template <class Model>
__global__ void __launch_bounds__(kBlock)
linesearch_team_kernel(const float* __restrict__ params, int pstride,
                       const float* __restrict__ x0,
                       const float* __restrict__ us,
                       const float* __restrict__ xsr,
                       const float* __restrict__ xterm,
                       const float* __restrict__ K,
                       const float* __restrict__ k,
                       const float* __restrict__ Kold,
                       const float* __restrict__ kold,
                       const float* __restrict__ alphas, int A,
                       const float* __restrict__ dv,
                       const float* __restrict__ cprev,
                       const float* __restrict__ gate,
                       const float* __restrict__ keep, float* xs_out,
                       float* __restrict__ us_out, float* __restrict__ xfin,
                       float* __restrict__ k_out, float* __restrict__ K_out,
                       float* __restrict__ lscost,
                       float* __restrict__ alpha_sel,
                       float* __restrict__ acc, float* __restrict__ dcost,
                       float* __restrict__ expected, float z_min, int T,
                       int B_, int clamp, int scheme) {
  constexpr int N = Model::N, M = Model::M;
  const Team tm = half_warp();
  const int lane = blockIdx.x * kLanes + threadIdx.x / kTeam;
  const bool valid = lane < B_;
  const int ln = valid ? lane : B_ - 1;  // where a team past B reads
  const size_t B = B_;
  const typename Model::Params p = fused::load_lane<Model>(params, pstride,
                                                           ln);
  const rollout::Gains<Model> g{k, K, M * B, M * N * B, B};
  const rollout::Selection s = line_search<Model>(
      tm, p, x0, us, xsr, xterm, g, kold, Kold, alphas, A, cprev[ln], dv[ln],
      dv[B + ln], z_min, gate[ln], keep[ln] > 0.5f, T, B, ln, valid,
      clamp != 0, scheme, Segments(T, A, N, N, kTeam), xs_out, xs_out,
      us_out, xfin, k_out, K_out);
  if (valid && tm.rank == 0) {
    lscost[lane] = s.cost;
    alpha_sel[lane] = s.alpha;
    acc[lane] = s.accepted;
    dcost[lane] = s.dcost;
    expected[lane] = s.expected;
  }
}

}  // namespace team

namespace fused {

// The line-search launch of ILQR_ROLLOUT_LAUNCHERS: the team kernel
template <class Model, class... Args>
inline int launch_model_linesearch(int B, void* stream, Args... args) {
  team::linesearch_team_kernel<Model>
      <<<(B + team::kLanes - 1) / team::kLanes, team::kBlock, 0,
         (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// Blocks an SM holds at once of the line-search kernel that
// launch_model_linesearch launches (and the threads and dynamic shared
// memory bytes of each); -1 where the CUDA call fails
template <class Model>
inline int linesearch_blocks_per_sm(int* threads, int* smem_bytes) {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, team::linesearch_team_kernel<Model>, team::kBlock, 0);
  *threads = team::kBlock;
  *smem_bytes = 0;
  return err == cudaSuccess ? n : -1;
}

}  // namespace fused
