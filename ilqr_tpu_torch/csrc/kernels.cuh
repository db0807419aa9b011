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
// are independent, so no block waits for another.
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
// linesearch_packed (line search + iteration epilogue)
//
// Replaces: ilqr_tpu/ops/pallas_rollout.py linesearch_packed (_ls_kernel).
// Bound on this card: operations — A = 11 candidate model steps per
// lane-step against one read of the shared rows; the emit pass adds one
// write of the post-accept state.
// Design: the TPU's (A+1, T) grid becomes one thread looping over its two
// phases; the A candidate states stay with the thread, so every shared row
// (u, x̄, k, K) is read once per timestep for all candidates.
// ---------------------------------------------------------------------------
template <class Model>
__global__ void __launch_bounds__(kBlock)
linesearch_kernel(const float* __restrict__ params, int pstride,
                  const float* __restrict__ x0, const float* __restrict__ us,
                  const float* __restrict__ xsr,
                  const float* __restrict__ xterm,
                  const float* __restrict__ K, const float* __restrict__ k,
                  const float* __restrict__ Kold,
                  const float* __restrict__ kold,
                  const float* __restrict__ alphas, int A,
                  const float* __restrict__ dv,
                  const float* __restrict__ cprev,
                  const float* __restrict__ gate,
                  const float* __restrict__ keep, float* __restrict__ xs_out,
                  float* __restrict__ us_out, float* __restrict__ xfin,
                  float* __restrict__ k_out, float* __restrict__ K_out,
                  float* __restrict__ lscost, float* __restrict__ alpha_sel,
                  float* __restrict__ acc, float* __restrict__ dcost,
                  float* __restrict__ expected, float z_min, int T, int B_,
                  int clamp, int scheme) {
  constexpr int N = Model::N, M = Model::M;
  const int lane = lane_index();
  if (lane >= B_) return;
  const size_t B = B_;
  const typename Model::Params p = load_lane<Model>(params, pstride, lane);
  float al[kMaxA];
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) al[a] = (a < A) ? alphas[a] : 0.0f;
  float x0v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x0v[i] = x0[i * B + lane];
  const rollout::Gains<Model> g{k, K, M * B, M * N * B, B};

  float cand[kMaxA];
  rollout::candidate_costs<Model, kMaxA>(p, x0v, us, xsr, g, al, A, T, B,
                                         lane, clamp != 0, scheme, cand);
  const rollout::Selection s = rollout::select<kMaxA>(
      cand, al, A, cprev[lane], dv[lane], dv[B + lane], z_min);
  // the step is taken only through the outer gate (back_ok & ~grad_term &
  // live, computed by the solver from the sweep's outputs)
  const bool take = s.accepted * gate[lane] > 0.5f;
  const bool keepm = keep[lane] > 0.5f;
  rollout::emit<Model>(scheme, p, x0v, us, xsr, xterm, g, kold, Kold,
                       s.alpha, take, keepm, T, B, lane, clamp != 0, xs_out,
                       us_out, k_out, K_out, xfin);
  lscost[lane] = s.cost;
  alpha_sel[lane] = s.alpha;
  acc[lane] = s.accepted;
  dcost[lane] = s.dcost;
  expected[lane] = s.expected;
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

template <class Model, class Deriv>
inline int launch_sweep(const void* params, int pstride, const void* xs,
                        const void* xterm, const void* us, const void* lam,
                        void* k, void* K, void* dv, void* div, void* gnorm,
                        int T, int B, int use_limits, Deriv d,
                        void* stream) {
  return launch(use_limits ? sweep_kernel<Model, true, Deriv>
                           : sweep_kernel<Model, false, Deriv>,
                B, stream, (const float*)params, pstride, (const float*)xs,
                (const float*)xterm, (const float*)us, (const float*)lam,
                (float*)k, (float*)K, (float*)dv, (float*)div, (float*)gnorm,
                T, B, d);
}

template <class Model, class Deriv>
inline int launch_iteration(
    const void* params, int pstride, const void* x0, const void* xs,
    const void* xterm, const void* us, const void* Kold, const void* kold,
    const void* alphas, int A, const void* lam, const void* cprev,
    const void* live, void* xs_out, void* us_out, void* xfin, void* k_out,
    void* K_out, void* lscost, void* alpha_sel, void* acc, void* dcost,
    void* expected, void* div, void* gnorm, void* gains, float z_min,
    float tol_grad, float lam_grad_term, int T, int B, int clamp,
    int use_limits, int scheme, Deriv d, void* stream) {
  return launch(
      use_limits ? iteration_kernel<Model, true, Deriv>
                 : iteration_kernel<Model, false, Deriv>,
      B, stream, (const float*)params, pstride, (const float*)x0,
      (const float*)xs, (const float*)xterm, (const float*)us,
      (const float*)Kold, (const float*)kold, (const float*)alphas, A,
      (const float*)lam, (const float*)cprev, (const float*)live,
      (float*)xs_out, (float*)us_out, (float*)xfin, (float*)k_out,
      (float*)K_out, (float*)lscost, (float*)alpha_sel, (float*)acc,
      (float*)dcost, (float*)expected, (float*)div, (float*)gnorm,
      (float*)gains, z_min, tol_grad, lam_grad_term, T, B, clamp, scheme, d);
}

}  // namespace fused

// The extern "C" launchers of one model, ilqr_<NAME>_<kernel>, with the
// signatures ops/_build.py binds. The sweep and iteration launchers pick the
// kernel with control limits (the box QP) or without (the Newton step). The
// rollout and line-search launchers take the integrator (0 Euler, 1 RK4);
// the analytic sweep and iteration run the Euler step (the JAX kernel's
// use_analytic), the stencil ones (_fd) take the integrator and the
// stencil's eps and denominators.
// ILQR_FUSED_LAUNCHERS instantiates the four analytic kernels; a model
// whose kernels take nvcc minutes (the quadrotor's 81-candidate QP) puts
// ILQR_SPLIT_LAUNCHERS (rollout, sweep, line search) and
// ILQR_ITERATION_LAUNCHER in two sources, which compile in parallel.
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

#define ILQR_SPLIT_LAUNCHERS(NAME, MODEL)                                      \
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
  int ilqr_##NAME##_linesearch(                                                \
      const void* params, int pstride, const void* x0, const void* us,         \
      const void* xsr, const void* xterm, const void* K, const void* k,        \
      const void* Kold, const void* kold, const void* alphas, int A,           \
      const void* dv, const void* cprev, const void* gate, const void* keep,   \
      void* xs_out, void* us_out, void* xfin, void* k_out, void* K_out,        \
      void* lscost, void* alpha_sel, void* acc, void* dcost, void* expected,   \
      float z_min, int T, int B, int clamp, int scheme, void* stream) {        \
    return fused::launch(                                                      \
        fused::linesearch_kernel<MODEL>, B, stream, (const float*)params,      \
        pstride, (const float*)x0, (const float*)us, (const float*)xsr,        \
        (const float*)xterm, (const float*)K, (const float*)k,                 \
        (const float*)Kold, (const float*)kold, (const float*)alphas, A,       \
        (const float*)dv, (const float*)cprev, (const float*)gate,             \
        (const float*)keep, (float*)xs_out, (float*)us_out, (float*)xfin,      \
        (float*)k_out, (float*)K_out, (float*)lscost, (float*)alpha_sel,       \
        (float*)acc, (float*)dcost, (float*)expected, z_min, T, B, clamp,      \
        scheme);                                                               \
  }                                                                            \
  int ilqr_##NAME##_sweep(ILQR_SWEEP_PARAMS, void* stream) {                   \
    return fused::launch_sweep<MODEL>(ILQR_SWEEP_ARGS, sweep::Analytic{},      \
                                      stream);                                 \
  }                                                                            \
  }

#define ILQR_ITERATION_LAUNCHER(NAME, MODEL)                                \
  extern "C" int ilqr_##NAME##_iteration(ILQR_ITERATION_PARAMS,             \
                                         void* stream) {                    \
    return fused::launch_iteration<MODEL>(                                  \
        ILQR_ITERATION_ARGS, integrate::kEuler, sweep::Analytic{}, stream); \
  }

#define ILQR_FD_SWEEP_LAUNCHER(NAME, MODEL)                              \
  extern "C" int ilqr_##NAME##_sweep_fd(ILQR_SWEEP_PARAMS, int scheme,   \
                                        float eps, float den1,           \
                                        float den2, void* stream) {      \
    return fused::launch_sweep<MODEL>(                                   \
        ILQR_SWEEP_ARGS,                                                 \
        sweep::FiniteDiff{fd::Stencil{eps, den1, den2, scheme}}, stream); \
  }

#define ILQR_FD_ITERATION_LAUNCHER(NAME, MODEL)                             \
  extern "C" int ilqr_##NAME##_iteration_fd(ILQR_ITERATION_PARAMS,          \
                                            int scheme, float eps,          \
                                            float den1, float den2,         \
                                            void* stream) {                 \
    return fused::launch_iteration<MODEL>(                                  \
        ILQR_ITERATION_ARGS, scheme,                                        \
        sweep::FiniteDiff{fd::Stencil{eps, den1, den2, scheme}}, stream);   \
  }

#define ILQR_JVP_SWEEP_LAUNCHER(NAME, MODEL)                                \
  extern "C" int ilqr_##NAME##_sweep_jvp(ILQR_SWEEP_PARAMS, int scheme,     \
                                         void* stream) {                    \
    return fused::launch_sweep<MODEL>(ILQR_SWEEP_ARGS, sweep::Jvp{scheme},  \
                                      stream);                              \
  }

#define ILQR_JVP_ITERATION_LAUNCHER(NAME, MODEL)                            \
  extern "C" int ilqr_##NAME##_iteration_jvp(ILQR_ITERATION_PARAMS,         \
                                             int scheme, void* stream) {    \
    return fused::launch_iteration<MODEL>(ILQR_ITERATION_ARGS, scheme,      \
                                          sweep::Jvp{scheme}, stream);      \
  }
