// The linearization kernel for Hopper (sm_90a), a template on the model:
// one derivs_<model>.cu per model instantiates it with
// ILQR_DERIVS_LAUNCHER, so that the models compile in parallel, one nvcc
// each (the quadrotor's dense 12 x 12 steps alone take minutes).
//
// Replaces: ilqr_tpu/ops/pallas_derivs.py derivs_packed (_kernel). For every
// (timestep, lane) it writes fx, fu, cx, cu, cxx, cxu, cuu of the discrete
// step (Euler or RK4, a runtime argument) and the running cost, and at
// t == T the terminal row cx[T], cxx[T] of the final cost; "jvp" mode
// differentiates exactly in forward mode (jvp.cuh, the dual numbers of
// dual.cuh, through every RK4 stage), "fd" mode takes the reference's
// 2-point and 4-point central stencils (fd.cuh). Both are the merged
// sweep's derivative policies (sweep_step.cuh Jvp and FiniteDiff), so a
// row here is the same IEEE computation as the sweep's step at that
// (t, lane).
//
// Bound on this card: device-memory bytes. Per (t, lane) it reads n + m
// floats and writes n(n+m) + (n+m) + (n+m)² ones (46 for acrobot, ~0.84 GB
// at B = 8192, T = 499); the dual arithmetic or stencil evaluations per
// (t, lane) stay below the f32 rate.
// Design: every (t, lane) is independent, so one thread per (t, lane) — not
// one per lane as in the recursions — with the lane index fastest, so a
// warp's loads and stores are contiguous; (T+1)·B ≈ 4.1 M threads fill the
// card. Each thread evaluates its n+m first-order directions and the upper
// triangle of second-order pairs into local arrays (the symmetric entries
// mirrored, as the TPU kernel does) and stores them.
//
// Params: one shared vector (pstride 0) or one row of P per lane, (B, P),
// which every (t, lane) thread of that lane reads (pstride P).
//
// Layout (lane last): xs (T+1, n, B), us (T, m, B) → fx (T, n, n, B),
// fu (T, n, m, B), cx (T+1, n, B), cu (T, m, B), cxx (T+1, n, n, B),
// cxu (T, n, m, B), cuu (T, m, m, B).

#pragma once

#include <cuda_runtime.h>

#include "sweep_step.cuh"

namespace {

constexpr int kBlock = 256;

template <class Model, class Deriv>
__global__ void __launch_bounds__(kBlock)
derivs_kernel(const float* __restrict__ params, int pstride,
              const float* __restrict__ xs, const float* __restrict__ us,
              float* __restrict__ fx, float* __restrict__ fu,
              float* __restrict__ cx, float* __restrict__ cu,
              float* __restrict__ cxx, float* __restrict__ cxu,
              float* __restrict__ cuu, int T, int B_, Deriv d) {
  constexpr int N = Model::N, M = Model::M;
  const size_t B = B_;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= (static_cast<size_t>(T) + 1) * B) return;
  const size_t t = idx / B;
  const size_t lane = idx - t * B;
  // shared params (pstride 0), or lane's own row of P (pstride P)
  const typename Model::Params p = Model::load(params + lane * pstride);
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xs[(t * N + i) * B + lane];
  if (t == static_cast<size_t>(T)) {
    // the terminal row; the T-row outputs have no row T
    float vx[N], vxx[N][N];
    d.template terminal<Model>(p, x, vx, vxx);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cx[(t * N + i) * B + lane] = vx[i];
#pragma unroll
      for (int j = 0; j < N; ++j)
        cxx[((t * N + i) * N + j) * B + lane] = vxx[i][j];
    }
    return;
  }
  float u[M];
#pragma unroll
  for (int j = 0; j < M; ++j) u[j] = us[(t * M + j) * B + lane];
  float f[N][N], g[N][M], c1[N], c2[M], h[N][N], hu[N][M], huu[M][M];
  d.template linearize<Model>(p, x, u, f, g, c1, c2, h, hu, huu);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cx[(t * N + i) * B + lane] = c1[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      fx[((t * N + i) * N + j) * B + lane] = f[i][j];
      cxx[((t * N + i) * N + j) * B + lane] = h[i][j];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      fu[((t * N + i) * M + j) * B + lane] = g[i][j];
      cxu[((t * N + i) * M + j) * B + lane] = hu[i][j];
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    cu[(t * M + i) * B + lane] = c2[i];
#pragma unroll
    for (int j = 0; j < M; ++j)
      cuu[((t * M + i) * M + j) * B + lane] = huu[i][j];
  }
}

template <class Model>
int launch_derivs(const void* params, int pstride, const void* xs,
                  const void* us, void* fx, void* fu, void* cx, void* cu,
                  void* cxx, void* cxu, void* cuu, int fd, int scheme,
                  float eps, float den1, float den2, int T, int B,
                  void* stream) {
  const size_t threads = (static_cast<size_t>(T) + 1) * B;
  const dim3 grid(static_cast<unsigned>((threads + kBlock - 1) / kBlock));
  const float* p = (const float*)params;
  const float* x = (const float*)xs;
  const float* u = (const float*)us;
  cudaStream_t st = (cudaStream_t)stream;
  if (fd)
    derivs_kernel<Model, sweep::FiniteDiff><<<grid, kBlock, 0, st>>>(
        p, pstride, x, u, (float*)fx, (float*)fu, (float*)cx, (float*)cu,
        (float*)cxx, (float*)cxu, (float*)cuu, T, B,
        sweep::FiniteDiff{fd::Stencil{eps, den1, den2, scheme}});
  else
    derivs_kernel<Model, sweep::Jvp><<<grid, kBlock, 0, st>>>(
        p, pstride, x, u, (float*)fx, (float*)fu, (float*)cx, (float*)cu,
        (float*)cxx, (float*)cxu, (float*)cuu, T, B, sweep::Jvp{scheme});
  return (int)cudaGetLastError();
}

}  // namespace

// ilqr_<NAME>_derivs: fd selects the stencils (eps and the denominators
// 2·eps, 4·eps² rounded once to f32 on the host) over the dual numbers;
// scheme is the step differentiated (0 Euler, 1 RK4).
#define ILQR_DERIVS_LAUNCHER(NAME, MODEL)                                   \
  extern "C" int ilqr_##NAME##_derivs(                                      \
      const void* params, int pstride, const void* xs, const void* us,      \
      void* fx, void* fu, void* cx, void* cu, void* cxx, void* cxu,         \
      void* cuu, int fd, int scheme, float eps, float den1, float den2,     \
      int T, int B, void* stream) {                                         \
    return launch_derivs<MODEL>(params, pstride, xs, us, fx, fu, cx, cu,    \
                                cxx, cxu, cuu, fd, scheme, eps, den1, den2, \
                                T, B, stream);                              \
  }
