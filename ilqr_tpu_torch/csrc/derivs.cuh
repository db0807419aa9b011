// The linearization kernel for Hopper (sm_90a), a template on the model:
// one derivs_<model>.cu per model instantiates it with
// ILQR_DERIVS_LAUNCHER, so that the models compile in parallel, one nvcc
// each; a custom model's library instantiates it the same way.
//
// Replaces: ilqr_tpu/ops/pallas_derivs.py derivs_packed (_kernel). For every
// (timestep, lane) it writes fx, fu, cx, cu, cxx, cxu, cuu of the discrete
// step (Euler or RK4, a runtime argument) and the running cost, and at
// t == T the terminal row cx[T], cxx[T] of the final cost; "jvp" mode
// differentiates exactly in forward mode (jvp.cuh, the dual numbers of
// dual.cuh, through every RK4 stage), "fd" mode takes the reference's
// 2-point and 4-point central stencils (fd.cuh). Both are the merged
// sweep's derivative policies (sweep_step.cuh Jvp and FiniteDiff), so an
// entry here is the same IEEE computation as the sweep's step at that
// (t, lane).
//
// Bound on this card: by the counted bytes and operations, device-memory
// bytes. Per (t, lane) it reads n + m floats and writes n(n+m) + (n+m) +
// (n+m)² ones (46 for acrobot, ~0.84 GB at B = 8192, T = 499). The
// evaluations behind them, dozens of dependent instructions each with the
// models' trig, take longer: the launch is instruction-bound (below).
// Design: one thread per (t, lane), in blocks of 256 lanes of one time
// step (the lane fastest, so a warp's loads and stores are 32 contiguous
// floats of one entry), each thread running fd.cuh's and jvp.cuh's loops
// over its (t, lane): direction a of (x, u) gives column a of (fx | fu) and
// entry a of (cx | cu) (one first-order dual pass, or the plus and minus
// sides of the stencil); pair (a, b ≥ a) gives one entry of the cost's
// Hessian, mirrored on the symmetric blocks; at t == T, direction a of the
// final cost gives cx[T][a] and its pairs cxx[T]. Each entry is stored as
// soon as it is made (sweep_step.cuh's direction, second and
// final_direction), so no thread holds an array indexed by a runtime
// direction: the kernel this replaces kept a (t, lane)'s 46 (acrobot) to
// 1 200 (thruster_ring24) entries in local arrays and stored them at the
// end (a stack on every model: acrobot 192 B, quadrotor 1 696,
// thruster_ring24 3 904); here only sincosf's slow-path argument reduction
// takes local memory (32 B on the models with trig). Each entry is
// computed with the one-thread kernel's operations in their order
// (--fmad=false), so the outputs are bit for bit the plain version's.
// Acrobot's fd + RK4 row runs 40 dynamics and 70 cost evaluations a
// (t, lane); more threads a (t, lane) repeat each thread's params, x and u
// loads and index arithmetic without shortening that work. Timed on an
// H100 (700 W) at phase 3's shapes, ms of acrobot's rows (B = 8192,
// T = 499) jvp Euler / fd Euler / jvp RK4 / fd RK4:
//  - this design 0.44-0.49 / 0.86-0.90 / 0.86-0.93 / 1.27-1.37, the kernel
//    it replaces 0.60-0.64 / 0.90-0.95 / 0.80-0.94 / 1.31-1.42, and one
//    loop over a flat entry index (a pair's (a, b) worked out from it, a
//    branch per entry) 0.50-0.54 / 0.92-1.02 / 0.89-0.96 / 1.39-1.47, four
//    readings each in turns in one call;
//  - that flat loop split over k threads a (t, lane), thread y taking
//    entries y, y + k, … (blocks of 256 / k lanes), two readings each:
//    k = 1 0.49-0.50 / 0.92-0.96 / 0.96-0.97 / 1.36-1.41; k = 2 0.54-0.55 /
//    0.95-1.04 / 0.92-0.98 / 1.38-1.46; k = 4 0.61-0.65 / 1.08-1.11 /
//    1.04-1.09 / 1.51-1.54; k = 8 0.76-0.78 / 1.22-1.24 / 1.19-1.24 /
//    1.80-1.81;
//  - one thread per (entry, t, lane), blocks of 32 lanes by 8 entries:
//    1.15-1.21 / 1.46-1.55 / 1.43-1.56 / 1.93-2.05; by 16 entries
//    1.48-1.56 / 1.96-2.01 / 1.99 / 2.55-2.61; with streaming stores
//    (__stcs) 1.20-1.24 / 1.52-1.57 / 1.48-1.55 / 1.93-1.96, no gain (the
//    same bytes reach memory); with 16-byte stores over four lanes a
//    thread 0.71-0.73 / 1.55-1.66 / 2.05-2.12 / 5.06-5.19 (four lanes'
//    chains in series, 80 registers);
//  - a team per (t, lane) with shuffles: not built; there is no carry to
//    share, and each thread of a team would store its entries a (t, lane)
//    apart, uncoalesced.
// At the small batches the designs overlap (cartpole jvp Euler, B = 1024,
// T = 299: 0.10-0.18 ms in every one), except the pendulum's (B = 1024,
// T = 199), 0.07 ms one thread per entry against 0.08-0.12 here.
//
// Params: one shared vector (pstride 0) or one row of P per lane, (B, P),
// which every thread of that lane reads (pstride P).
//
// Layout (lane last): xs (T+1, n, B), us (T, m, B) → fx (T, n, n, B),
// fu (T, n, m, B), cx (T+1, n, B), cu (T, m, B), cxx (T+1, n, n, B),
// cxu (T, n, m, B), cuu (T, m, m, B).

#pragma once

#include <cuda_runtime.h>

#include "sweep_step.cuh"

namespace derivs {

constexpr int kBlock = 256;   // lanes a block, all of one time step

template <class Model, class Deriv>
__global__ void __launch_bounds__(kBlock)
derivs_entry_kernel(const float* __restrict__ params, int pstride,
                    const float* __restrict__ xs,
                    const float* __restrict__ us, float* __restrict__ fx,
                    float* __restrict__ fu, float* __restrict__ cx,
                    float* __restrict__ cu, float* __restrict__ cxx,
                    float* __restrict__ cxu, float* __restrict__ cuu, int T,
                    int B_, Deriv d) {
  constexpr int N = Model::N, M = Model::M, NZ = N + M;
  const size_t B = B_;
  const size_t lane = static_cast<size_t>(blockIdx.x) * kBlock + threadIdx.x;
  const size_t t = blockIdx.y;
  if (lane >= B) return;
  // shared params (pstride 0), or lane's own row of P (pstride P)
  const typename Model::Params p = Model::load(params + lane * pstride);
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xs[(t * N + i) * B + lane];
  if (t == static_cast<size_t>(T)) {   // the T-row outputs have no row T
    float u0[M];
#pragma unroll
    for (int j = 0; j < M; ++j) u0[j] = 0.0f;
#pragma unroll 1
    for (int a = 0; a < N; ++a)
      cx[(t * N + a) * B + lane] = d.template final_direction<Model>(p, x, a);
#pragma unroll 1
    for (int a = 0; a < N; ++a)
#pragma unroll 1
      for (int b = a; b < N; ++b) {
        const float h = d.template second<Model, false>(p, x, u0, a, b);
        cxx[((t * N + a) * N + b) * B + lane] = h;
        cxx[((t * N + b) * N + a) * B + lane] = h;
      }
    return;
  }
  float u[M];
#pragma unroll
  for (int j = 0; j < M; ++j) u[j] = us[(t * M + j) * B + lane];
  // direction a: column a of (fx | fu), entry a of (cx | cu)
#pragma unroll 1
  for (int a = 0; a < NZ; ++a) {
    float col[N];
    const float dc = d.template direction<Model>(p, x, u, a, col);
    if (a < N) {
#pragma unroll
      for (int r = 0; r < N; ++r)
        fx[((t * N + r) * N + a) * B + lane] = col[r];
      cx[(t * N + a) * B + lane] = dc;
    } else {
#pragma unroll
      for (int r = 0; r < N; ++r)
        fu[((t * N + r) * M + a - N) * B + lane] = col[r];
      cu[(t * M + a - N) * B + lane] = dc;
    }
  }
  // pair (a, b ≥ a) of the cost's Hessian, mirrored where symmetric
#pragma unroll 1
  for (int a = 0; a < NZ; ++a)
#pragma unroll 1
    for (int b = a; b < NZ; ++b) {
      const float h = d.template second<Model, true>(p, x, u, a, b);
      if (b < N) {
        cxx[((t * N + a) * N + b) * B + lane] = h;
        cxx[((t * N + b) * N + a) * B + lane] = h;
      } else if (a < N) {
        cxu[((t * N + a) * M + b - N) * B + lane] = h;
      } else {
        cuu[((t * M + a - N) * M + b - N) * B + lane] = h;
        cuu[((t * M + b - N) * M + a - N) * B + lane] = h;
      }
    }
}

// Lane blocks by time steps (T + 1 ≤ 65 535, the grid's y limit; a launch
// past it fails and the wrapper raises)
inline dim3 grid_for(int T, int B) {
  return dim3((B + kBlock - 1) / kBlock, T + 1);
}

template <class Model>
int launch_derivs(const void* params, int pstride, const void* xs,
                  const void* us, void* fx, void* fu, void* cx, void* cu,
                  void* cxx, void* cxu, void* cuu, int fd, int scheme,
                  float eps, float den1, float den2, int T, int B,
                  void* stream) {
  const dim3 grid = grid_for(T, B), block(kBlock);
  const float* p = (const float*)params;
  const float* x = (const float*)xs;
  const float* u = (const float*)us;
  cudaStream_t st = (cudaStream_t)stream;
  if (fd)
    derivs_entry_kernel<Model, sweep::FiniteDiff><<<grid, block, 0, st>>>(
        p, pstride, x, u, (float*)fx, (float*)fu, (float*)cx, (float*)cu,
        (float*)cxx, (float*)cxu, (float*)cuu, T, B,
        sweep::FiniteDiff{fd::Stencil{eps, den1, den2, scheme}});
  else
    derivs_entry_kernel<Model, sweep::Jvp><<<grid, block, 0, st>>>(
        p, pstride, x, u, (float*)fx, (float*)fu, (float*)cx, (float*)cu,
        (float*)cxx, (float*)cxu, (float*)cuu, T, B, sweep::Jvp{scheme});
  return (int)cudaGetLastError();
}

// Blocks of the kernel an SM holds at once (fd: the stencil form), and the
// threads and dynamic shared memory bytes of each; -1 where the CUDA call
// fails
template <class Model>
int derivs_blocks_per_sm(int fd, int* threads, int* smem_bytes) {
  int n = 0;
  const cudaError_t err =
      fd ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &n, derivs_entry_kernel<Model, sweep::FiniteDiff>, kBlock, 0)
         : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &n, derivs_entry_kernel<Model, sweep::Jvp>, kBlock, 0);
  *threads = kBlock;
  *smem_bytes = 0;
  return err == cudaSuccess ? n : -1;
}

}  // namespace derivs

// ilqr_<NAME>_derivs: fd selects the stencils (eps and the denominators
// 2·eps, 4·eps² rounded once to f32 on the host) over the dual numbers;
// scheme is the step differentiated (0 Euler, 1 RK4).
// ilqr_<NAME>_derivs_blocks_per_sm(fd, int* threads, int* smem_bytes): the
// kernel's blocks an SM holds in that mode, and their threads and dynamic
// shared memory.
#define ILQR_DERIVS_LAUNCHER(NAME, MODEL)                                   \
  extern "C" int ilqr_##NAME##_derivs(                                      \
      const void* params, int pstride, const void* xs, const void* us,      \
      void* fx, void* fu, void* cx, void* cu, void* cxx, void* cxu,         \
      void* cuu, int fd, int scheme, float eps, float den1, float den2,     \
      int T, int B, void* stream) {                                         \
    return derivs::launch_derivs<MODEL>(params, pstride, xs, us, fx, fu,    \
                                        cx, cu, cxx, cxu, cuu, fd, scheme,  \
                                        eps, den1, den2, T, B, stream);     \
  }                                                                         \
  extern "C" int ilqr_##NAME##_derivs_blocks_per_sm(int fd, int* threads,   \
                                                    int* smem_bytes) {      \
    return derivs::derivs_blocks_per_sm<MODEL>(fd, threads, smem_bytes);    \
  }
