// The fused solver's four kernels for Hopper (sm_90a), templated on the
// model (a traits struct, see acrobot.cuh Model). Each model's own source,
// csrc/kernels*.cu, instantiates them and defines its extern "C" launchers
// with ILQR_FUSED_LAUNCHERS, so that the models compile in parallel.
//
// Layout: one thread per lane (problem), the lane index last in every array
// — (T, n, B), (T, m, n, B), … — so a warp's loads and stores at one
// timestep are contiguous. This is the JAX package's packed (…, NB, 8, 128)
// layout flattened. Each thread walks its own time loop; the carries (x, the
// V-carry, dV, the divergence latch, the gnorm sum, the A candidate states)
// stay in registers, or in local memory where a large model (the quadrotor,
// n = 12, m = 4) needs more than the 255 registers a thread may hold. Lanes
// are independent, so no block waits for another. Three kernels no longer
// follow this layout:
//  - the line search (linesearch_packed) of every model, custom ones too,
//    is a team of 16 threads per lane (linesearch_team.cuh);
//  - the whole iteration (iteration_packed) of acrobot, cartpole and
//    pendulum is a team of 16 threads per lane (iteration_team.cuh), that
//    of double_integrator, bicycle, power_mass and point_mass_3d (m = 2-3)
//    the same team at 32 threads per lane, that of the models with
//    m·n ≥ 32 (the quadrotor and the m ≥ 5 models) a warp per lane running
//    sweep_team.cuh's sweep (iteration_warp.cuh); a custom model
//    (ops/codegen.py) takes the team at 16 or 32 threads where its n and m
//    fit it (custom.cuh team_iteration), else iteration_kernel below;
//  - the merged sweep (sweep_packed) of the models with m·n ≥ 32 is a warp
//    per lane (sweep_team.cuh), the stencil and dual-number sweeps of the
//    models with a team iteration (m·n < 32, custom ones included) the same
//    team as their whole iteration, its phase 0 alone (iteration_team.cuh
//    sweep_small_team_kernel); their closed-form sweeps (faster on one
//    thread a lane, sweep_team.cuh kSweepKind) and the custom models
//    outside the team's rule keep sweep_kernel.
//
// The integrator (Euler or RK4, integrate.cuh) is a runtime argument of
// every kernel. The sweep and whole-iteration kernels are templates on the
// derivative source (sweep_step.cuh): Analytic (the model's closed-form
// derivatives, Euler only), FiniteDiff (the reference's stencils of the
// Euler or RK4 step) or Jvp (exact dual-number derivatives of the Euler or
// RK4 step), each model's FiniteDiff and Jvp instantiations in sources of
// their own (csrc/kernels_<model>_fd.cu, csrc/kernels_<model>_jvp.cu).
//
// Launchers take PyTorch's current stream and return cudaGetLastError().
// They allocate nothing: the Python wrappers pass every output and scratch
// buffer.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (ops/_build.py). --fmad=false keeps every a*b+c as two rounded
// operations, as the plain PyTorch versions compute them, and no
// --use_fast_math, so division is IEEE and sincosf the full-accuracy one.
#pragma once

#include <cuda_runtime.h>

#include "rollout_step.cuh"
#include "sweep_step.cuh"

namespace fused {

constexpr int kBlock = 64;  // 128 blocks cover B = 8192 in one wave
constexpr int kMaxA = 11;   // line-search candidates held in registers

__device__ __forceinline__ int lane_index() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}

// The params of one lane: shared params (pstride 0) are one vector every
// lane reads; per-problem params (pstride P) are one row of P floats per
// lane, (B, P), read by that lane alone (ops/kernel_rollout.py
// pack_params_batched). Each lane reads its params once per launch, so the
// uncoalesced row read is paid once against the whole time loop.
template <class Model>
__device__ __forceinline__ typename Model::Params load_lane(
    const float* __restrict__ params, int pstride, int lane) {
  return Model::load(params + static_cast<size_t>(lane) * pstride);
}

// ---------------------------------------------------------------------------
// rollout_packed (full-output mode)
//
// Replaces: ilqr_tpu/ops/pallas_rollout.py rollout_packed (_kernel).
// Bound on this card: device-memory bytes — per lane-step it reads u_ff, x̄
// and K ((m + n + m·n)·4 B) and writes x and u against a few dozen flops of
// model math per state dim; the serial time loop makes a single launch
// latency-bound at the batch sizes the solver runs.
// Design: one thread per lane with the state in registers; every load of a
// timestep is independent of the carry, so loads are placed ahead of the
// dependent model math.
// ---------------------------------------------------------------------------
template <class Model, int kScheme>
__device__ __forceinline__ void rollout_lane(
    const typename Model::Params& p, const float* __restrict__ x0,
    const float* __restrict__ uff, const float* __restrict__ xsr,
    const float* __restrict__ K, float* __restrict__ xs,
    float* __restrict__ us, float* __restrict__ xfin,
    float* __restrict__ cost, int T, size_t B, int lane, bool clamp) {
  constexpr int N = Model::N, M = Model::M;
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = x0[i * B + lane];
  float c = 0.0f;
  for (int t = 0; t < T; ++t) {
    float xr[N], Kr[M][N], ur[M], u[M];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      xr[i] = xsr[(t * N + i) * B + lane];
      xs[(t * N + i) * B + lane] = x[i];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      ur[j] = uff[(t * M + j) * B + lane];
#pragma unroll
      for (int i = 0; i < N; ++i)
        Kr[j][i] = K[((t * M + j) * N + i) * B + lane];
    }
    const float ci = rollout::step<Model, kScheme>(p, x, ur, xr, Kr, clamp, u);
#pragma unroll
    for (int j = 0; j < M; ++j) us[(t * M + j) * B + lane] = u[j];
    c = c + ci;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) xfin[i * B + lane] = x[i];
  cost[lane] = c + Model::final_cost(p, x);
}

template <class Model>
__global__ void __launch_bounds__(kBlock)
rollout_kernel(const float* __restrict__ params, int pstride,
               const float* __restrict__ x0, const float* __restrict__ uff,
               const float* __restrict__ xsr, const float* __restrict__ K,
               float* __restrict__ xs, float* __restrict__ us,
               float* __restrict__ xfin, float* __restrict__ cost, int T,
               int B_, int clamp, int scheme) {
  const int lane = lane_index();
  if (lane >= B_) return;
  const typename Model::Params p = load_lane<Model>(params, pstride, lane);
  if (scheme == integrate::kRK4)
    rollout_lane<Model, integrate::kRK4>(p, x0, uff, xsr, K, xs, us, xfin,
                                         cost, T, B_, lane, clamp != 0);
  else
    rollout_lane<Model, integrate::kEuler>(p, x0, uff, xsr, K, xs, us, xfin,
                                           cost, T, B_, lane, clamp != 0);
}

// ---------------------------------------------------------------------------
// rollout_packed, its other modes: costs_only, candidates, alpha_lanes
//
// Replaces: ilqr_tpu/ops/pallas_rollout.py rollout_packed (_kernel with
// costs_only, candidates > 1 and alpha_mode "scalar" / "lane").
// Bound on this card: device-memory bytes for most models; the
// operations for acrobot's A-fold sweeps (sincosf per candidate step).
// The least traffic reads the shared x̄, K and k once for all A
// candidates (JAX's grid indexes them modulo NB); this design reads them
// once per candidate, A times, mostly from L2. Like the full-output mode
// the launch is latency-bound at the solver's batch sizes (the serial
// time loop), so the A-fold grid costs about what one rollout does.
// Design: one thread per (candidate a, lane b), thread g = a·B + b, so the
// output (cost (A·B,), candidate-major) is written contiguously; every
// input but a materialized u_ff is read at lane b = g mod B, the params row
// too. The mode is a runtime argument, uniform over the launch:
//   uff_wide    u_ff is (T, m, A·B), one column per candidate (else
//               (T, m, B), shared by the candidates);
//   alpha_mode  0 none, 1 α = alpha[a] (the candidates' steps), 2 α =
//               alpha[b] (one α per lane); with an α the thread forms
//               u_ff + α·k before the feedback, as the JAX kernel does;
//   costs_only  the cost alone; otherwise (A = 1) xs, us and x_T too.
// ---------------------------------------------------------------------------
template <class Model, int kScheme>
__device__ __forceinline__ void rollout_modes_lane(
    const typename Model::Params& p, const float* __restrict__ x0,
    const float* __restrict__ uff, const float* __restrict__ xsr,
    const float* __restrict__ K, const float* __restrict__ k, float alpha,
    bool has_alpha, float* __restrict__ xs, float* __restrict__ us,
    float* __restrict__ xfin, float* __restrict__ cost, int T, size_t B,
    size_t lane, size_t g, size_t uff_stride, size_t uff_col,
    bool costs_only, bool clamp) {
  constexpr int N = Model::N, M = Model::M;
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = x0[i * B + lane];
  float c = 0.0f;
  for (int t = 0; t < T; ++t) {
    const size_t tn = static_cast<size_t>(t) * N;
    const size_t tm = static_cast<size_t>(t) * M;
    float xr[N], Kr[M][N], ur[M], u[M];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      xr[i] = xsr[(tn + i) * B + lane];
      if (!costs_only) xs[(tn + i) * B + lane] = x[i];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float uf = uff[(tm + j) * uff_stride + uff_col];
      if (has_alpha) uf = uf + alpha * k[(tm + j) * B + lane];
      ur[j] = uf;
#pragma unroll
      for (int i = 0; i < N; ++i) Kr[j][i] = K[((tm + j) * N + i) * B + lane];
    }
    const float ci = rollout::step<Model, kScheme>(p, x, ur, xr, Kr, clamp, u);
    if (!costs_only) {
#pragma unroll
      for (int j = 0; j < M; ++j) us[(tm + j) * B + lane] = u[j];
    }
    c = c + ci;
  }
  if (!costs_only) {
#pragma unroll
    for (int i = 0; i < N; ++i) xfin[i * B + lane] = x[i];
  }
  cost[g] = c + Model::final_cost(p, x);
}

template <class Model>
__global__ void __launch_bounds__(kBlock)
rollout_modes_kernel(const float* __restrict__ params, int pstride,
                     const float* __restrict__ x0,
                     const float* __restrict__ uff,
                     const float* __restrict__ xsr,
                     const float* __restrict__ K,
                     const float* __restrict__ k,
                     const float* __restrict__ alpha, float* __restrict__ xs,
                     float* __restrict__ us, float* __restrict__ xfin,
                     float* __restrict__ cost, int T, int B_, int A,
                     int uff_wide, int alpha_mode, int costs_only, int clamp,
                     int scheme) {
  const size_t g = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t B = static_cast<size_t>(B_);
  if (g >= static_cast<size_t>(A) * B) return;
  const size_t a = g / B, lane = g % B;
  const typename Model::Params p = load_lane<Model>(params, pstride,
                                                    static_cast<int>(lane));
  const float al = alpha_mode == 1 ? alpha[a]
                   : alpha_mode == 2 ? alpha[lane] : 0.0f;
  const size_t uff_stride = uff_wide ? static_cast<size_t>(A) * B : B;
  const size_t uff_col = uff_wide ? g : lane;
  if (scheme == integrate::kRK4)
    rollout_modes_lane<Model, integrate::kRK4>(
        p, x0, uff, xsr, K, k, al, alpha_mode != 0, xs, us, xfin, cost, T, B,
        lane, g, uff_stride, uff_col, costs_only != 0, clamp != 0);
  else
    rollout_modes_lane<Model, integrate::kEuler>(
        p, x0, uff, xsr, K, k, al, alpha_mode != 0, xs, us, xfin, cost, T, B,
        lane, g, uff_stride, uff_col, costs_only != 0, clamp != 0);
}

// Backward phase shared by the sweep and the whole-iteration kernels:
// reverse time from V_T, gains stored through (k_ptr, K_ptr) with the given
// per-timestep strides (rows B apart). Returns the carry's accumulators.
template <class Model, bool kLimits, class Deriv>
__device__ __forceinline__ sweep::Carry<Model> backward_phase(
    const typename Model::Params& p, const Deriv& d,
    const float* __restrict__ xs, const float* __restrict__ xterm,
    const float* __restrict__ us, float lam, int T, size_t B, int lane,
    float* k_ptr, float* K_ptr, size_t k_tstride, size_t K_tstride) {
  constexpr int N = Model::N, M = Model::M;
  sweep::Carry<Model> c;
  float xT[N];
#pragma unroll
  for (int i = 0; i < N; ++i) xT[i] = xterm[i * B + lane];
  sweep::terminal_init<Model>(p, xT, d, c);
  for (int t = T - 1; t >= 0; --t) {
    float x[N], u[M];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = xs[(t * N + i) * B + lane];
#pragma unroll
    for (int j = 0; j < M; ++j) u[j] = us[(t * M + j) * B + lane];
    float k[M], Kr[M][N];
    sweep::step<Model, kLimits>(p, x, u, lam, d, c, k, Kr);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      k_ptr[t * k_tstride + j * B + lane] = k[j];
#pragma unroll
      for (int i = 0; i < N; ++i)
        K_ptr[t * K_tstride + (j * N + i) * B + lane] = Kr[j][i];
    }
  }
  return c;
}

// ---------------------------------------------------------------------------
// sweep_packed (merged linearize + backward, analytic derivatives or the
// stencils; the box QP with limits, the Newton step without)
//
// Replaces: ilqr_tpu/ops/pallas_sweep.py sweep_packed (_kernel +
// _sweep_step, _qp_m1 … _qp_m4, _qp_newton, _free_solve_rows,
// _terminal_init).
// Bound on this card: by bytes it is small (per lane-step it reads x, u and
// writes k, K); by operations the Riccati algebra (O(n³) per step, plus
// 3^m QP candidates) runs in one serial chain per lane, so it is
// latency-bound: each step waits on the V-carry of the step before.
// The stencils add (n + m)(n + m + 3)/2·4 cost and 2(n + m) step
// evaluations per step, all on the same serial chain.
// Design: the whole V-carry stays with the thread; the linearization never
// leaves it; Vxx is updated as an exactly symmetric upper triangle; the QP's
// candidates and free subsets are unrolled at compile time (qp.cuh).
// ---------------------------------------------------------------------------
template <class Model, bool kLimits, class Deriv>
__global__ void __launch_bounds__(kBlock)
sweep_kernel(const float* __restrict__ params, int pstride,
             const float* __restrict__ xs,
             const float* __restrict__ xterm, const float* __restrict__ us,
             const float* __restrict__ lam, float* __restrict__ k_out,
             float* __restrict__ K_out, float* __restrict__ dv,
             float* __restrict__ div, float* __restrict__ gnorm, int T,
             int B_, Deriv d) {
  constexpr int N = Model::N, M = Model::M;
  const int lane = lane_index();
  if (lane >= B_) return;
  const size_t B = B_;
  const typename Model::Params p = load_lane<Model>(params, pstride, lane);
  const sweep::Carry<Model> c = backward_phase<Model, kLimits>(
      p, d, xs, xterm, us, lam[lane], T, B, lane, k_out, K_out, M * B,
      M * N * B);
  dv[lane] = c.dv0;
  dv[B + lane] = c.dv1;
  div[lane] = c.div;
  gnorm[lane] = c.gacc * static_cast<float>(1.0 / T);
}

// ---------------------------------------------------------------------------
// iteration_packed (one whole solver iteration)
//
// Replaces: ilqr_tpu/ops/pallas_iter.py iteration_packed (_iter_kernel).
// Bound on this card: at least one read of xs, us, k_old, K_old and one write
// of xs, us, k, K; this design streams the (T, m(n+1), B) gain buffer three
// times, and the serial per-lane chains make it latency-bound before either.
// Design: the gains of all T steps do not fit on chip for a useful number of
// lanes, so phase 0 writes them to a device-memory buffer the wrapper
// allocates; phase 1 reads each gain row once per timestep for all A
// candidates; phase 2 selects α and emits the post-accept state. The
// take/keep gates are computed in registers between the phases. Lanes with
// live = 0 re-emit their state.
// ---------------------------------------------------------------------------
template <class Model, bool kLimits, class Deriv>
__global__ void __launch_bounds__(kBlock)
iteration_kernel(const float* __restrict__ params, int pstride,
                 const float* __restrict__ x0, const float* __restrict__ xs,
                 const float* __restrict__ xterm,
                 const float* __restrict__ us,
                 const float* __restrict__ Kold,
                 const float* __restrict__ kold,
                 const float* __restrict__ alphas, int A,
                 const float* __restrict__ lam,
                 const float* __restrict__ cprev,
                 const float* __restrict__ live, float* __restrict__ xs_out,
                 float* __restrict__ us_out, float* __restrict__ xfin,
                 float* __restrict__ k_out, float* __restrict__ K_out,
                 float* __restrict__ lscost, float* __restrict__ alpha_sel,
                 float* __restrict__ acc, float* __restrict__ dcost,
                 float* __restrict__ expected, float* __restrict__ div_out,
                 float* __restrict__ gnorm_out, float* gains, float z_min,
                 float tol_grad, float lam_grad_term, int T, int B_,
                 int clamp, int scheme, Deriv d) {
  constexpr int N = Model::N, M = Model::M;
  const int lane = lane_index();
  if (lane >= B_) return;
  const size_t B = B_;
  const typename Model::Params p = load_lane<Model>(params, pstride, lane);
  const size_t G = M * (N + 1) * B;  // gain-buffer row stride: k then K

  // phase 0: merged linearize + backward sweep into the gain buffer
  const float lm = lam[lane];
  const sweep::Carry<Model> c = backward_phase<Model, kLimits>(
      p, d, xs, xterm, us, lm, T, B, lane, gains, gains + M * B, G, G);
  const float gn = c.gacc * static_cast<float>(1.0 / T);
  div_out[lane] = c.div;
  gnorm_out[lane] = gn;
  const float okf = 1.0f - c.div;
  const float gtf = okf * (gn < tol_grad ? 1.0f : 0.0f)
                    * (lm < lam_grad_term ? 1.0f : 0.0f);
  const float gate = okf * (1.0f - gtf) * live[lane];  // take-step gate
  const float keep = okf * live[lane];                 // gain-keep gate

  // phase 1: every α-candidate, costs only
  float al[kMaxA];
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) al[a] = (a < A) ? alphas[a] : 0.0f;
  float x0v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x0v[i] = x0[i * B + lane];
  const rollout::Gains<Model> g{gains, gains + M * B, G, G, B};
  float cand[kMaxA];
  rollout::candidate_costs<Model, kMaxA>(p, x0v, us, xs, g, al, A, T, B,
                                         lane, clamp != 0, scheme, cand);

  // phase 2: select the first accepted α and emit
  const rollout::Selection s = rollout::select<kMaxA>(
      cand, al, A, cprev[lane], c.dv0, c.dv1, z_min);
  const bool take = s.accepted * gate > 0.5f;
  rollout::emit<Model>(scheme, p, x0v, us, xs, xterm, g, kold, Kold,
                       s.alpha, take, keep > 0.5f, T, B, lane, clamp != 0,
                       xs_out, us_out, k_out, K_out, xfin);
  lscost[lane] = s.cost;
  alpha_sel[lane] = s.alpha;
  acc[lane] = s.accepted;
  dcost[lane] = s.dcost;
  expected[lane] = s.expected;
}

inline dim3 grid_for(int B) { return dim3((B + kBlock - 1) / kBlock); }

// Launches kernel on B lanes; returns the launch's error.
template <class Kernel, class... Args>
inline int launch(Kernel kernel, int B, void* stream, Args... args) {
  kernel<<<grid_for(B), kBlock, 0, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace fused

// The line search as a team of 16 threads per lane and its launch; the
// whole iteration as a team of 16 or 32 threads per lane
// (Model::kTeamIteration); the merged sweep as a warp per
// lane (the models with m·n ≥ 32, fused::TeamSweep) and the launch that
// picks a model's sweep kernel; the whole iteration of those models as a
// warp per lane and the launch that picks a model's whole-iteration kernel
#include "linesearch_team.cuh"
#include "iteration_team.cuh"
#include "sweep_team.cuh"
#include "iteration_warp.cuh"

// The extern "C" launchers of one model, ilqr_<NAME>_<kernel>, with the
// signatures ops/_build.py binds. The sweep and iteration launchers pick the
// kernel with control limits (the box QP) or without (the Newton step). The
// rollout and line-search launchers take the integrator (0 Euler, 1 RK4);
// the analytic sweep and iteration run the Euler step (the JAX kernel's
// use_analytic), the stencil ones (_fd) take the integrator and the
// stencil's eps and denominators.
// Each launcher instantiates the model's one kernel for its work, chosen at
// compile time (fused::launch_model_linesearch, launch_model_sweep,
// launch_whole_iteration): the line search's team kernel
// (linesearch_team.cuh) for every model; the sweep's warp kernel of
// sweep_team.cuh where fused::TeamSweep picks it (m·n ≥ 32, custom models
// excepted), the team kernel of iteration_team.cuh
// (sweep_small_team_kernel) for the stencils and dual numbers where the
// model has kTeamIteration, else sweep_kernel (the closed forms of those
// models, custom models outside the team's rule; fused::kSweepKind); the
// whole iteration's team kernel of iteration_team.cuh where the model has
// kTeamIteration (16 threads a lane for acrobot, cartpole, pendulum; 32
// for double_integrator, bicycle, power_mass, point_mass_3d; 16 or 32 for
// a custom model inside custom::team_iteration's rule), the warp kernel of
// iteration_warp.cuh where TeamSweep picks it, else iteration_kernel (the
// custom models outside the team's rule). Beside each stand
// ilqr_<NAME>_linesearch_blocks_per_sm(int* threads, int* smem_bytes) and
// ilqr_<NAME>_{sweep,iteration}[_fd|_jvp]_blocks_per_sm(use_limits,
// int* threads, int* smem_bytes): the blocks of that kernel an SM holds,
// and the threads and dynamic shared memory of each; -1 where a CUDA call
// fails; and ilqr_<NAME>_{sweep,iteration}[_fd|_jvp]_lane_threads(): the
// threads a lane of that kernel (1, 16 or 32).
// ILQR_FUSED_LAUNCHERS instantiates the four analytic kernels; a model
// whose kernels take nvcc minutes (the quadrotor's 81-candidate QP) puts
// ILQR_SPLIT_LAUNCHERS (rollout, sweep, line search) and
// ILQR_ITERATION_LAUNCHER in two sources, which compile in parallel.
// ILQR_ROLLOUT_LAUNCHERS instantiates the rollout (both kernels: the full
// output, ilqr_<NAME>_rollout, and the other modes,
// ilqr_<NAME>_rollout_modes) and the line search alone: a custom model
// (ops/codegen.py) has no closed-form derivatives, so its sweep and
// iteration come from the dense policies only.
// ILQR_FD_LAUNCHERS instantiates the stencil sweep and iteration kernels,
// ilqr_<NAME>_sweep_fd and ilqr_<NAME>_iteration_fd, in a source of their
// own (ILQR_FD_SWEEP_LAUNCHER and ILQR_FD_ITERATION_LAUNCHER apart for the
// quadrotor). ILQR_JVP_LAUNCHERS likewise instantiates the dual-number
// sweep and iteration kernels, ilqr_<NAME>_sweep_jvp and
// ilqr_<NAME>_iteration_jvp, which take their analytic twins' arguments
// and then the integrator (the quadrotor's apart as for fd).
#define ILQR_FUSED_LAUNCHERS(NAME, MODEL) \
  ILQR_SPLIT_LAUNCHERS(NAME, MODEL)       \
  ILQR_ITERATION_LAUNCHER(NAME, MODEL)

#define ILQR_FD_LAUNCHERS(NAME, MODEL) \
  ILQR_FD_SWEEP_LAUNCHER(NAME, MODEL)  \
  ILQR_FD_ITERATION_LAUNCHER(NAME, MODEL)

#define ILQR_JVP_LAUNCHERS(NAME, MODEL) \
  ILQR_JVP_SWEEP_LAUNCHER(NAME, MODEL)  \
  ILQR_JVP_ITERATION_LAUNCHER(NAME, MODEL)

#define ILQR_SWEEP_PARAMS                                                  \
  const void* params, int pstride, const void* xs, const void* xterm,      \
      const void* us, const void* lam, void* k, void* K, void* dv,         \
      void* div, void* gnorm, int T, int B, int use_limits
#define ILQR_SWEEP_ARGS \
  params, pstride, xs, xterm, us, lam, k, K, dv, div, gnorm, T, B, use_limits
#define ILQR_ITERATION_PARAMS                                                 \
  const void* params, int pstride, const void* x0, const void* xs,           \
      const void* xterm, const void* us, const void* Kold, const void* kold, \
      const void* alphas, int A, const void* lam, const void* cprev,         \
      const void* live, void* xs_out, void* us_out, void* xfin, void* k_out, \
      void* K_out, void* lscost, void* alpha_sel, void* acc, void* dcost,    \
      void* expected, void* div, void* gnorm, void* gains, float z_min,      \
      float tol_grad, float lam_grad_term, int T, int B, int clamp,          \
      int use_limits
#define ILQR_ITERATION_ARGS                                                  \
  params, pstride, x0, xs, xterm, us, Kold, kold, alphas, A, lam, cprev,     \
      live, xs_out, us_out, xfin, k_out, K_out, lscost, alpha_sel, acc,      \
      dcost, expected, div, gnorm, gains, z_min, tol_grad, lam_grad_term, T, \
      B, clamp, use_limits

#define ILQR_ROLLOUT_LAUNCHERS(NAME, MODEL)                                    \
  extern "C" {                                                                 \
  int ilqr_##NAME##_rollout(const void* params, int pstride, const void* x0,   \
                            const void* uff, const void* xsr, const void* K,   \
                            void* xs, void* us, void* xfin, void* cost, int T, \
                            int B, int clamp, int scheme, void* stream) {      \
    return fused::launch(                                                      \
        fused::rollout_kernel<MODEL>, B, stream, (const float*)params,         \
        pstride, (const float*)x0, (const float*)uff, (const float*)xsr,       \
        (const float*)K, (float*)xs, (float*)us, (float*)xfin, (float*)cost,   \
        T, B, clamp, scheme);                                                  \
  }                                                                            \
  int ilqr_##NAME##_rollout_modes(                                             \
      const void* params, int pstride, const void* x0, const void* uff,        \
      const void* xsr, const void* K, const void* k, const void* alpha,        \
      void* xs, void* us, void* xfin, void* cost, int T, int B, int A,         \
      int uff_wide, int alpha_mode, int costs_only, int clamp, int scheme,     \
      void* stream) {                                                          \
    return fused::launch(                                                      \
        fused::rollout_modes_kernel<MODEL>, A * B, stream,                     \
        (const float*)params, pstride, (const float*)x0, (const float*)uff,    \
        (const float*)xsr, (const float*)K, (const float*)k,                   \
        (const float*)alpha, (float*)xs, (float*)us, (float*)xfin,             \
        (float*)cost, T, B, A, uff_wide, alpha_mode, costs_only, clamp,        \
        scheme);                                                               \
  }                                                                            \
  int ilqr_##NAME##_linesearch(                                                \
      const void* params, int pstride, const void* x0, const void* us,         \
      const void* xsr, const void* xterm, const void* K, const void* k,        \
      const void* Kold, const void* kold, const void* alphas, int A,           \
      const void* dv, const void* cprev, const void* gate, const void* keep,   \
      void* xs_out, void* us_out, void* xfin, void* k_out, void* K_out,        \
      void* lscost, void* alpha_sel, void* acc, void* dcost, void* expected,   \
      float z_min, int T, int B, int clamp, int scheme, void* stream) {        \
    return fused::launch_model_linesearch<MODEL>(                              \
        B, stream, (const float*)params, pstride, (const float*)x0,            \
        (const float*)us, (const float*)xsr, (const float*)xterm,              \
        (const float*)K, (const float*)k, (const float*)Kold,                  \
        (const float*)kold, (const float*)alphas, A, (const float*)dv,         \
        (const float*)cprev, (const float*)gate, (const float*)keep,           \
        (float*)xs_out, (float*)us_out, (float*)xfin, (float*)k_out,           \
        (float*)K_out, (float*)lscost, (float*)alpha_sel, (float*)acc,         \
        (float*)dcost, (float*)expected, z_min, T, B, clamp, scheme);          \
  }                                                                            \
  int ilqr_##NAME##_linesearch_blocks_per_sm(int* threads, int* smem_bytes) {  \
    return fused::linesearch_blocks_per_sm<MODEL>(threads, smem_bytes);        \
  }                                                                            \
  }

#define ILQR_SWEEP_BLOCKS_PER_SM(NAME, MODEL, SUFFIX, DERIV)                \
  extern "C" int ilqr_##NAME##_sweep##SUFFIX##_blocks_per_sm(                \
      int use_limits, int* threads, int* smem_bytes) {                       \
    return fused::sweep_blocks_per_sm<MODEL, DERIV>(use_limits, threads,     \
                                                    smem_bytes);             \
  }                                                                          \
  extern "C" int ilqr_##NAME##_sweep##SUFFIX##_lane_threads() {              \
    return fused::sweep_lane_threads<MODEL, DERIV>();                        \
  }

#define ILQR_SPLIT_LAUNCHERS(NAME, MODEL)                                      \
  ILQR_ROLLOUT_LAUNCHERS(NAME, MODEL)                                          \
  extern "C" int ilqr_##NAME##_sweep(ILQR_SWEEP_PARAMS, void* stream) {        \
    return fused::launch_model_sweep<MODEL, sweep::Analytic>(                  \
        ILQR_SWEEP_ARGS, sweep::Analytic{}, stream);                           \
  }                                                                            \
  ILQR_SWEEP_BLOCKS_PER_SM(NAME, MODEL, , sweep::Analytic)

#define ILQR_ITERATION_BLOCKS_PER_SM(NAME, MODEL, SUFFIX, DERIV)            \
  extern "C" int ilqr_##NAME##_iteration##SUFFIX##_blocks_per_sm(            \
      int use_limits, int* threads, int* smem_bytes) {                       \
    return fused::iteration_blocks_per_sm<MODEL, DERIV>(use_limits, threads, \
                                                        smem_bytes);         \
  }                                                                          \
  extern "C" int ilqr_##NAME##_iteration##SUFFIX##_lane_threads() {          \
    return fused::iteration_lane_threads<MODEL>();                           \
  }

#define ILQR_ITERATION_LAUNCHER(NAME, MODEL)                                 \
  extern "C" int ilqr_##NAME##_iteration(ILQR_ITERATION_PARAMS,              \
                                         void* stream) {                     \
    return fused::launch_whole_iteration<MODEL, sweep::Analytic>(            \
        ILQR_ITERATION_ARGS, integrate::kEuler, sweep::Analytic{}, stream);  \
  }                                                                          \
  ILQR_ITERATION_BLOCKS_PER_SM(NAME, MODEL, , sweep::Analytic)

#define ILQR_FD_SWEEP_LAUNCHER(NAME, MODEL)                              \
  extern "C" int ilqr_##NAME##_sweep_fd(ILQR_SWEEP_PARAMS, int scheme,   \
                                        float eps, float den1,           \
                                        float den2, void* stream) {      \
    return fused::launch_model_sweep<MODEL, sweep::FiniteDiff>(          \
        ILQR_SWEEP_ARGS,                                                 \
        sweep::FiniteDiff{fd::Stencil{eps, den1, den2, scheme}}, stream); \
  }                                                                      \
  ILQR_SWEEP_BLOCKS_PER_SM(NAME, MODEL, _fd, sweep::FiniteDiff)

#define ILQR_FD_ITERATION_LAUNCHER(NAME, MODEL)                              \
  extern "C" int ilqr_##NAME##_iteration_fd(ILQR_ITERATION_PARAMS,           \
                                            int scheme, float eps,           \
                                            float den1, float den2,          \
                                            void* stream) {                  \
    return fused::launch_whole_iteration<MODEL, sweep::FiniteDiff>(          \
        ILQR_ITERATION_ARGS, scheme,                                         \
        sweep::FiniteDiff{fd::Stencil{eps, den1, den2, scheme}}, stream);    \
  }                                                                          \
  ILQR_ITERATION_BLOCKS_PER_SM(NAME, MODEL, _fd, sweep::FiniteDiff)

#define ILQR_JVP_SWEEP_LAUNCHER(NAME, MODEL)                                \
  extern "C" int ilqr_##NAME##_sweep_jvp(ILQR_SWEEP_PARAMS, int scheme,     \
                                         void* stream) {                    \
    return fused::launch_model_sweep<MODEL, sweep::Jvp>(                    \
        ILQR_SWEEP_ARGS, sweep::Jvp{scheme}, stream);                       \
  }                                                                         \
  ILQR_SWEEP_BLOCKS_PER_SM(NAME, MODEL, _jvp, sweep::Jvp)

#define ILQR_JVP_ITERATION_LAUNCHER(NAME, MODEL)                             \
  extern "C" int ilqr_##NAME##_iteration_jvp(ILQR_ITERATION_PARAMS,          \
                                             int scheme, void* stream) {     \
    return fused::launch_whole_iteration<MODEL, sweep::Jvp>(                 \
        ILQR_ITERATION_ARGS, scheme, sweep::Jvp{scheme}, stream);            \
  }                                                                          \
  ILQR_ITERATION_BLOCKS_PER_SM(NAME, MODEL, _jvp, sweep::Jvp)
