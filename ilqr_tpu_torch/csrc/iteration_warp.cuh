// iteration_packed (one whole solver iteration) as a warp per lane, for the
// models with m·n ≥ 32 (the quadrotor, n = 12, m = 4, and the m ≥ 5 models,
// n = 6, 5 ≤ m ≤ 24), whose merged sweep is sweep_team.cuh's: the
// one-thread iteration_kernel of kernels.cuh redesigned for this card. The
// solver reaches it through iter_kernel="merged" (iter_kernel="auto" takes
// the split iteration for these models, as the JAX package does). Also the
// launch that picks a model's whole-iteration kernel.
//
// Replaces: ilqr_tpu/ops/pallas_iter.py iteration_packed (_iter_kernel), as
// kernels.cuh iteration_kernel does, on the same inputs, outputs and gain
// buffer, with the same launcher names and signatures.
// Bound on this card: latency. The one-thread kernel kept the sweep's
// matrices in local memory (ring24's 11.7 KB stack, 3-12 KB of spills) and
// ran the sweep, then its lane's A candidates, in series on one thread of
// the 16 blocks of 64 that B = 1024 fills.
// Design: a warp serves one lane, kLanes = 4 lanes a block of 128 threads,
// as sweep_team.cuh's sweep does.
//  - Phase 0: sweep_team::sweep_lane, the lane's state in dynamic shared
//    memory; the gains of each step go to k_out and K_out.
//  - The gates (div, gnorm, tol_grad, λ): thread 0's accumulators passed to
//    the warp by shuffles, the gates formed on every thread.
//  - Phases 1-2: linesearch_team.cuh's line search on the warp's 32
//    threads: thread a < A advances candidate a, the selected one is
//    replayed in up to 32 segments whose start states the gain buffer holds
//    as a scratch; the previous gains are copied over the new ones where
//    they are not kept.
// Every output value is computed by one thread with the one-thread kernel's
// operations in its order (--fmad=false); no sum is split across threads, so
// the results are that kernel's bit for bit. A warp whose lane lies past B
// (in the last block) returns after the block's one barrier, before it
// reads or writes anything.
#pragma once

#include "iteration_team.cuh"
#include "linesearch_team.cuh"
#include "sweep_team.cuh"

namespace sweep_team {

template <class Model, bool kLimits, class Deriv>
__global__ void __launch_bounds__(kBlock)
iteration_warp_kernel(const float* __restrict__ params, int pstride,
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
  static_assert(fused::kMaxA <= kTeam, "a warp holds every candidate");
  extern __shared__ float4 smem[];
  __shared__ KindStore<Model, Deriv> kinds;
  if (threadIdx.x == 0) fill_kinds<Model, Deriv>(kinds);
  __syncthreads();
  const int rank = threadIdx.x % kTeam;
  const int lane = blockIdx.x * kLanes + threadIdx.x / kTeam;
  if (lane >= B_) return;   // the whole warp: no barrier follows
  Lane<Model>& s = reinterpret_cast<Lane<Model>*>(smem)[threadIdx.x / kTeam];
  const size_t B = B_;

  // phase 0: merged linearize + backward sweep, the gains into k_out, K_out
  const float lm = lam[lane];
  const Acc a0 = sweep_lane<Model, kLimits>(
      s, Kinds<Model, Deriv>{&kinds}, params, pstride, xs, xterm, us, lm, T,
      B, lane, d, rank, k_out, K_out);
  const float dv0 = __shfl_sync(kFull, a0.dv0, 0);
  const float dv1 = __shfl_sync(kFull, a0.dv1, 0);
  const float dvg = __shfl_sync(kFull, a0.div, 0);
  const float gn =
      __shfl_sync(kFull, a0.gacc, 0) * static_cast<float>(1.0 / T);
  if (rank == 0) {
    div_out[lane] = dvg;
    gnorm_out[lane] = gn;
  }
  const float okf = 1.0f - dvg;
  const float gtf = okf * (gn < tol_grad ? 1.0f : 0.0f)
                    * (lm < lam_grad_term ? 1.0f : 0.0f);
  const float gate = okf * (1.0f - gtf) * live[lane];  // take-step gate
  const float keep = okf * live[lane];                 // gain-keep gate
  __syncwarp();   // the gain rows the warp stored, visible to all of it

  // phases 1-2: the line search on the new gains, the gain buffer its
  // scratch; the previous gains copied over the new ones where not kept
  const rollout::Selection sel = team::line_search<Model>(
      team::TeamOf<kTeam>{rank, kFull}, s.p, x0, us, xs, xterm,
      rollout::Gains<Model>{k_out, K_out, M * B, M * N * B, B}, kold, Kold,
      alphas, A, cprev[lane], dv0, dv1, z_min, gate, keep > 0.5f, T, B, lane,
      true, clamp != 0, scheme, team::Segments(T, A, G, N, kTeam), gains,
      xs_out, us_out, xfin, k_out, K_out);
  if (rank == 0) {
    lscost[lane] = sel.cost;
    alpha_sel[lane] = sel.alpha;
    acc[lane] = sel.accepted;
    dcost[lane] = sel.dcost;
    expected[lane] = sel.expected;
  }
}

}  // namespace sweep_team

namespace fused {

// The kernel of a model's whole iteration: the team where the model asks
// for it (TeamIteration; 16 threads a lane or 32, team::kTeamWidth), the
// warp where its merged sweep is the warp's (TeamSweep: m·n ≥ 32, custom
// models excepted), else the one-thread kernel (a custom model outside
// custom::team_iteration's rule)
template <class Model>
constexpr int kIterationKind = TeamIteration<Model>::value ? 1
                               : TeamSweep<Model>::value   ? 2
                                                           : 0;

template <class Model, bool kLimits, class Deriv>
constexpr auto iteration_kernel_of() {
  if constexpr (kIterationKind<Model> == 1)
    return team::iteration_team_kernel<Model, kLimits, Deriv,
                                       team::kTeamWidth<Model>>;
  else if constexpr (kIterationKind<Model> == 2)
    return sweep_team::iteration_warp_kernel<Model, kLimits, Deriv>;
  else
    return iteration_kernel<Model, kLimits, Deriv>;
}

// The launch geometry of that kernel: threads and lanes a block, dynamic
// shared memory (with the allowance the warp kernel needs, set once);
// returns the status of that call
template <class Model, bool kLimits, class Deriv>
inline int iteration_geometry(int& threads, int& lanes, size_t& smem) {
  smem = 0;
  if constexpr (kIterationKind<Model> == 1) {
    threads = team::kBlock;
    lanes = team::kBlock / team::kTeamWidth<Model>;
  } else if constexpr (kIterationKind<Model> == 2) {
    threads = sweep_team::kBlock;
    lanes = sweep_team::kLanes;
    return sweep_team::prepare<
        Model, sweep_team::iteration_warp_kernel<Model, kLimits, Deriv>>(smem);
  } else {
    threads = kBlock;
    lanes = kBlock;
  }
  return 0;
}

// The whole-iteration launch of ILQR_ITERATION_LAUNCHER,
// ILQR_FD_ITERATION_LAUNCHER and ILQR_JVP_ITERATION_LAUNCHER: the model's
// one kernel, chosen at compile time, with limits (the box QP) or without
template <class Model, class Deriv>
inline int launch_whole_iteration(
    const void* params, int pstride, const void* x0, const void* xs,
    const void* xterm, const void* us, const void* Kold, const void* kold,
    const void* alphas, int A, const void* lam, const void* cprev,
    const void* live, void* xs_out, void* us_out, void* xfin, void* k_out,
    void* K_out, void* lscost, void* alpha_sel, void* acc, void* dcost,
    void* expected, void* div, void* gnorm, void* gains, float z_min,
    float tol_grad, float lam_grad_term, int T, int B, int clamp,
    int use_limits, int scheme, Deriv d, void* stream) {
  int threads = 0, lanes = 1;
  size_t smem = 0;
  const int err =
      use_limits
          ? iteration_geometry<Model, true, Deriv>(threads, lanes, smem)
          : iteration_geometry<Model, false, Deriv>(threads, lanes, smem);
  if (err != 0) return err;
  const auto kernel = use_limits ? iteration_kernel_of<Model, true, Deriv>()
                                 : iteration_kernel_of<Model, false, Deriv>();
  kernel<<<(B + lanes - 1) / lanes, threads, smem, (cudaStream_t)stream>>>(
      (const float*)params, pstride, (const float*)x0, (const float*)xs,
      (const float*)xterm, (const float*)us, (const float*)Kold,
      (const float*)kold, (const float*)alphas, A, (const float*)lam,
      (const float*)cprev, (const float*)live, (float*)xs_out,
      (float*)us_out, (float*)xfin, (float*)k_out, (float*)K_out,
      (float*)lscost, (float*)alpha_sel, (float*)acc, (float*)dcost,
      (float*)expected, (float*)div, (float*)gnorm, (float*)gains, z_min,
      tol_grad, lam_grad_term, T, B, clamp, scheme, d);
  return (int)cudaGetLastError();
}

// Blocks an SM holds at once of the whole-iteration kernel that
// launch_whole_iteration launches (and the threads and dynamic shared
// memory bytes of each); -1 where a CUDA call fails
template <class Model, class Deriv>
inline int iteration_blocks_per_sm(int use_limits, int* threads,
                                   int* smem_bytes) {
  int n = 0, lanes = 1;
  size_t smem = 0;
  const int err =
      use_limits ? iteration_geometry<Model, true, Deriv>(*threads, lanes, smem)
                 : iteration_geometry<Model, false, Deriv>(*threads, lanes,
                                                           smem);
  if (err != 0) return -1;
  *smem_bytes = static_cast<int>(smem);
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n,
      use_limits ? iteration_kernel_of<Model, true, Deriv>()
                 : iteration_kernel_of<Model, false, Deriv>(),
      *threads, smem);
  return occ == cudaSuccess ? n : -1;
}

// Threads a lane of the whole-iteration kernel that launch_whole_iteration
// launches: 1 (the one-thread kernel), 16 or 32 (the team), 32 (the warp)
template <class Model>
constexpr int iteration_lane_threads() {
  return kIterationKind<Model> == 1   ? team::kTeamWidth<Model>
         : kIterationKind<Model> == 2 ? sweep_team::kTeam
                                      : 1;
}

}  // namespace fused
