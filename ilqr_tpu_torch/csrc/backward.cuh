// The m = 1 backward recursion from precomputed derivatives, for Hopper
// (sm_90a), a template on the state dimension N: backward.cu instantiates
// it for N = 2 (pendulum) and N = 4 (acrobot, cartpole), a custom model's
// library (ops/_build.py build_model) for its own n.
//
// Replaces: ilqr_tpu/ops/pallas_backward.py backward_sweep_packed (_kernel).
// Per lane, in reverse time: the Q-terms from fx, fu, cx, cu, cxx, cxu, cuu
// and V_{t+1}, QuuF = Quu + λ, the closed-form box QP clamp(−Qu/QuuF) on
// [lo, hi], K zeroed on a clamped control or a divergent step, dV, the V
// update and a latched divergence flag (ref src/ilqr_core.cpp:350-401).
//
// This is not the merged sweep's step (sweep_step.cuh): it follows the TPU
// kernel's own arithmetic — the dense fx, all n×n entries of Qxx and Vxx
// computed independently (so Vxx is not exactly symmetric), the divisions
// −Qu/q and −Qux_j/q, dV[1] as 0.5·k·Quu·k, and the accumulation order of
// pallas_backward.py:72-153.
//
// Bound on this card: per lane-step it reads 2n² + 3n + 4 floats of
// derivatives and limits and writes n + 1 (48 and 5 at n = 4, ~0.87 GB at
// B = 8192, T = 499) against ~330 flops at n = 4 in one serial chain per
// lane, so a launch is latency-bound: each step waits on the V-carry of the
// step before.
// Design: one thread per lane walks t = T−1 … 0 with Vx and Vxx (n + n²
// floats) in registers; every load of a step is independent of the carry,
// so the loads are issued ahead of the dependent algebra.
//
// Layout (lane last): fx (T, n, n, B), fu/cx/cxu (T, n, B),
// cu/cuu/lo/hi (T, B), lam (B,), cxT (n, B), cxxT (n, n, B) → k (T, B),
// K (T, n, B), dv (2, B), diverged (B,) f32 0/1.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;  // 128 blocks cover B = 8192 in one wave

// jnp.maximum / jnp.minimum / jnp.clip: NaN-propagating
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

template <int N>
__global__ void __launch_bounds__(kBlock)
backward_kernel(const float* __restrict__ fx, const float* __restrict__ fu,
                const float* __restrict__ cx, const float* __restrict__ cu,
                const float* __restrict__ cxx, const float* __restrict__ cxu,
                const float* __restrict__ cuu, const float* __restrict__ lo,
                const float* __restrict__ hi, const float* __restrict__ lam,
                const float* __restrict__ cxT, const float* __restrict__ cxxT,
                float* __restrict__ k_out, float* __restrict__ K_out,
                float* __restrict__ dv_out, float* __restrict__ div_out,
                int T, int B_) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B_) return;
  const size_t B = B_;

  float vx[N], vxx[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    vx[i] = cxT[i * B + lane];
#pragma unroll
    for (int j = 0; j < N; ++j) vxx[i][j] = cxxT[(i * N + j) * B + lane];
  }
  float dv0 = 0.0f, dv1 = 0.0f, div = 0.0f;
  const float lm = lam[lane];

  for (int t = T - 1; t >= 0; --t) {
    const size_t tn = static_cast<size_t>(t) * N;
    float f[N][N], fuv[N], cxv[N], cxx_t[N][N], cxuv[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      fuv[i] = fu[(tn + i) * B + lane];
      cxv[i] = cx[(tn + i) * B + lane];
      cxuv[i] = cxu[(tn + i) * B + lane];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        f[i][j] = fx[((tn + i) * N + j) * B + lane];
        cxx_t[i][j] = cxx[((tn + i) * N + j) * B + lane];
      }
    }
    const float cu_t = cu[t * B + lane];
    const float cuu_t = cuu[t * B + lane];
    const float lo_t = lo[t * B + lane];
    const float hi_t = hi[t * B + lane];

    // --- Q-terms (ref ilqr_core.cpp:359-367)
    float fvv[N];  // (fuᵀ Vxx)_j
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = fuv[0] * vxx[0][j];
#pragma unroll
      for (int i = 1; i < N; ++i) acc = acc + fuv[i] * vxx[i][j];
      fvv[j] = acc;
    }
    float qu = cu_t;
#pragma unroll
    for (int i = 0; i < N; ++i) qu = qu + fuv[i] * vx[i];
    float quu = cuu_t;
#pragma unroll
    for (int j = 0; j < N; ++j) quu = quu + fvv[j] * fuv[j];
    const float quuF = quu + lm;

    float qux[N], qx[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = cxuv[j];
#pragma unroll
      for (int i = 0; i < N; ++i) acc = acc + fvv[i] * f[i][j];
      qux[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = cxv[j];
#pragma unroll
      for (int i = 0; i < N; ++i) acc = acc + f[i][j] * vx[i];
      qx[j] = acc;
    }
    float w[N][N];  // Vxx fx
#pragma unroll
    for (int kk = 0; kk < N; ++kk)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float acc = vxx[kk][0] * f[0][j];
#pragma unroll
        for (int l = 1; l < N; ++l) acc = acc + vxx[kk][l] * f[l][j];
        w[kk][j] = acc;
      }
    float qxx[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float acc = cxx_t[i][j];
#pragma unroll
        for (int kk = 0; kk < N; ++kk) acc = acc + f[kk][i] * w[kk][j];
        qxx[i][j] = acc;
      }

    // --- closed-form 1-D box QP; a NaN QuuF is not "bad", exactly as the
    // JAX comparison quuF <= 0 reads it
    const bool bad = quuF <= 0.0f;
    const float q_safe = bad ? 1.0f : quuF;
    const float x1 = nan_min(nan_max(-qu / q_safe, lo_t), hi_t);
    const float gk = quuF * x1 + qu;
    const bool clamped = (x1 <= lo_t && gk > 0.0f) || (x1 >= hi_t && gk < 0.0f);
    const float k = bad ? 0.0f : x1;
    const bool zero_K = clamped || bad;
    float Kr[N];
#pragma unroll
    for (int j = 0; j < N; ++j) Kr[j] = zero_K ? 0.0f : -qux[j] / q_safe;

    div = nan_max(div, bad ? 1.0f : 0.0f);
    dv0 = dv0 + k * qu;
    dv1 = dv1 + 0.5f * k * quu * k;

    // --- V update (ref :391-393), every entry computed on its own
    const float kq = k * quu;
#pragma unroll
    for (int j = 0; j < N; ++j)
      vx[j] = qx[j] + Kr[j] * kq + Kr[j] * qu + qux[j] * k;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j)
        vxx[i][j] = qxx[i][j] + Kr[i] * quu * Kr[j] + Kr[i] * qux[j]
                    + qux[i] * Kr[j];

    k_out[t * B + lane] = k;
#pragma unroll
    for (int j = 0; j < N; ++j) K_out[(tn + j) * B + lane] = Kr[j];
  }
  dv_out[lane] = dv0;
  dv_out[B + lane] = dv1;
  div_out[lane] = div;
}

}  // namespace

// ilqr_backward_n<N>: the instantiation for n = N
#define ILQR_BACKWARD_LAUNCHER(N)                                           \
  extern "C" int ilqr_backward_n##N(                                        \
      const void* fx, const void* fu, const void* cx, const void* cu,       \
      const void* cxx, const void* cxu, const void* cuu, const void* lo,    \
      const void* hi, const void* lam, const void* cxT, const void* cxxT,   \
      void* k, void* K, void* dv, void* div, int T, int B, void* stream) {  \
    backward_kernel<N><<<(B + kBlock - 1) / kBlock, kBlock, 0,              \
                         (cudaStream_t)stream>>>(                           \
        (const float*)fx, (const float*)fu, (const float*)cx,               \
        (const float*)cu, (const float*)cxx, (const float*)cxu,             \
        (const float*)cuu, (const float*)lo, (const float*)hi,              \
        (const float*)lam, (const float*)cxT, (const float*)cxxT,           \
        (float*)k, (float*)K, (float*)dv, (float*)div, T, B);               \
    return (int)cudaGetLastError();                                         \
  }
