// The linearization kernel for Hopper (sm_90a), acrobot (n=4, m=1).
//
// Replaces: ilqr_tpu/ops/pallas_derivs.py derivs_packed (_kernel). For every
// (timestep, lane) it writes fx, fu, cx, cu, cxx, cxu, cuu of the Euler step
// and the running cost, and at t == T the terminal row cx[T], cxx[T] of the
// final cost; "jvp" mode differentiates exactly in forward mode (dual.cuh),
// "fd" mode takes the reference's 2-point and 4-point central stencils.
//
// Bound on this card: device-memory bytes. Per (t, lane) it reads 5 floats
// and writes 46 (~0.84 GB at B = 8192, T = 499); the ~1.5-3 k flops of dual
// arithmetic or stencil evaluations per (t, lane) stay below the f32 rate.
// Design: every (t, lane) is independent, so one thread per (t, lane) — not
// one per lane as in the recursions — with the lane index fastest, so a
// warp's loads and stores are contiguous; (T+1)·B ≈ 4.1 M threads fill the
// card. Each thread evaluates its n+m first-order directions and the upper
// triangle of second-order pairs in registers and mirrors the symmetric
// entries, as the TPU kernel does.
//
// Layout (lane last): xs (T+1, n, B), us (T, m, B) → fx (T, n, n, B),
// fu (T, n, m, B), cx (T+1, n, B), cu (T, m, B), cxx (T+1, n, n, B),
// cxu (T, n, m, B), cuu (T, m, m, B).

#include <cuda_runtime.h>

#include "acrobot.cuh"
#include "dual.cuh"

namespace {

constexpr int kBlock = 256;
using acrobot::M;
using acrobot::N;
using acrobot::Params;
constexpr int NZ = N + M;  // directions: the n states, then the m controls

using D1 = dual::Dual<float>;
using D2 = dual::Dual<D1>;

// tangent of input component c (states 0..n-1, control n) along direction a
__device__ __forceinline__ float basis(int c, int a) {
  return c == a ? 1.0f : 0.0f;
}

// the discrete Euler step x + f(x, u)·dt
template <class S>
__device__ __forceinline__ void euler_step(const Params& p, const S x[N],
                                           const S& u, S out[N]) {
  S dx[N];
  acrobot::dynamics(p, x, u, dx);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = x[i] + dx[i] * p.dt;
}

// Output pointers of one (t, lane) row, already offset to (t, ·, lane);
// entries of a row are B apart.
struct Row {
  float* fx;
  float* fu;
  float* cx;
  float* cu;
  float* cxx;
  float* cxu;
  float* cuu;
  size_t B;
};

// Second-order pairs in the TPU kernel's order: (i, j ≥ i) over the states,
// (state i, control) and (control, control). The value is mirrored where
// the block is symmetric.
__device__ __forceinline__ void store_pair(const Row& o, int a, int b,
                                           float h) {
  const size_t B = o.B;
  if (a < N && b < N) {
    o.cxx[(a * N + b) * B] = h;
    if (a != b) o.cxx[(b * N + a) * B] = h;
  } else if (a < N) {
    o.cxu[a * B] = h;
  } else {
    o.cuu[0] = h;
  }
}

// ---- "jvp": exact forward mode
__device__ __forceinline__ void running_jvp(const Params& p, const float x[N],
                                            float u, const Row& o) {
  const size_t B = o.B;
#pragma unroll
  for (int a = 0; a < NZ; ++a) {
    D1 xd[N];
#pragma unroll
    for (int c = 0; c < N; ++c) xd[c] = {x[c], basis(c, a)};
    const D1 ud{u, basis(N, a)};
    D1 y[N];
    euler_step(p, xd, ud, y);
    const D1 c = acrobot::cost(p, xd, ud);
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (a < N)
        o.fx[(r * N + a) * B] = y[r].d;
      else
        o.fu[r * B] = y[r].d;
    }
    if (a < N)
      o.cx[a * B] = c.d;
    else
      o.cu[0] = c.d;
  }
#pragma unroll
  for (int a = 0; a < NZ; ++a) {
#pragma unroll
    for (int b = a; b < NZ; ++b) {
      // inner direction a (ti), outer direction b (tj): JVP-of-JVP
      D2 xd[N];
#pragma unroll
      for (int c = 0; c < N; ++c)
        xd[c] = {{x[c], basis(c, b)}, {basis(c, a), 0.0f}};
      const D2 ud{{u, basis(N, b)}, {basis(N, a), 0.0f}};
      store_pair(o, a, b, acrobot::cost(p, xd, ud).d.d);
    }
  }
}

__device__ __forceinline__ void terminal_jvp(const Params& p, const float x[N],
                                             const Row& o) {
  const size_t B = o.B;
#pragma unroll
  for (int a = 0; a < N; ++a) {
    D1 xd[N];
#pragma unroll
    for (int c = 0; c < N; ++c) xd[c] = {x[c], basis(c, a)};
    o.cx[a * B] = acrobot::final_cost(p, xd).d;
  }
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int b = a; b < N; ++b) {
      D2 xd[N];
#pragma unroll
      for (int c = 0; c < N; ++c)
        xd[c] = {{x[c], basis(c, b)}, {basis(c, a), 0.0f}};
      store_pair(o, a, b, acrobot::final_cost(p, xd).d.d);
    }
  }
}

// ---- "fd": the reference's central stencils (finite_diff.h:22-86) with
// the JAX kernel's arithmetic: x ± eps·t for a tangent t of 0/±1/±2
// entries, (f₊ − f₋)/(2 eps) and (f₊₊ − f₊₋ − f₋₊ + f₋₋)/(4 eps²). The two
// denominators come from the host, rounded once to f32 from double.
struct Stencil {
  float eps, den1, den2;
};

// z ± eps·t over the (x, u) components
__device__ __forceinline__ void shift(const float x[N], float u,
                                      const float t[NZ], float eps, float sgn,
                                      float xs[N], float* us) {
#pragma unroll
  for (int c = 0; c < N; ++c)
    xs[c] = sgn > 0.0f ? x[c] + eps * t[c] : x[c] - eps * t[c];
  *us = sgn > 0.0f ? u + eps * t[N] : u - eps * t[N];
}

template <bool kRunning>
__device__ __forceinline__ float fd_cost(const Params& p, const float x[N],
                                         float u) {
  if (kRunning) return acrobot::cost(p, x, u);
  return acrobot::final_cost(p, x);
}

template <bool kRunning>
__device__ __forceinline__ void fd_second(const Params& p, const float x[N],
                                          float u, const Stencil& s,
                                          const Row& o) {
  constexpr int kDirs = kRunning ? NZ : N;
#pragma unroll
  for (int a = 0; a < kDirs; ++a) {
#pragma unroll
    for (int b = a; b < kDirs; ++b) {
      float tsum[NZ], tdif[NZ];
#pragma unroll
      for (int c = 0; c < NZ; ++c) {
        tsum[c] = basis(c, a) + basis(c, b);
        tdif[c] = basis(c, a) - basis(c, b);
      }
      float xq[N], uq;
      shift(x, u, tsum, s.eps, 1.0f, xq, &uq);
      const float fpp = fd_cost<kRunning>(p, xq, uq);
      shift(x, u, tdif, s.eps, 1.0f, xq, &uq);
      const float fpm = fd_cost<kRunning>(p, xq, uq);
      shift(x, u, tdif, s.eps, -1.0f, xq, &uq);
      const float fmp = fd_cost<kRunning>(p, xq, uq);
      shift(x, u, tsum, s.eps, -1.0f, xq, &uq);
      const float fmm = fd_cost<kRunning>(p, xq, uq);
      store_pair(o, a, b, (fpp - fpm - fmp + fmm) / s.den2);
    }
  }
}

__device__ __forceinline__ void running_fd(const Params& p, const float x[N],
                                           float u, const Stencil& s,
                                           const Row& o) {
  const size_t B = o.B;
#pragma unroll
  for (int a = 0; a < NZ; ++a) {
    float t[NZ];
#pragma unroll
    for (int c = 0; c < NZ; ++c) t[c] = basis(c, a);
    float xp[N], up, xm[N], um;
    shift(x, u, t, s.eps, 1.0f, xp, &up);
    shift(x, u, t, s.eps, -1.0f, xm, &um);
    float yp[N], ym[N];
    euler_step(p, xp, up, yp);
    euler_step(p, xm, um, ym);
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float d = (yp[r] - ym[r]) / s.den1;
      if (a < N)
        o.fx[(r * N + a) * B] = d;
      else
        o.fu[r * B] = d;
    }
    const float dc =
        (acrobot::cost(p, xp, up) - acrobot::cost(p, xm, um)) / s.den1;
    if (a < N)
      o.cx[a * B] = dc;
    else
      o.cu[0] = dc;
  }
  fd_second<true>(p, x, u, s, o);
}

__device__ __forceinline__ void terminal_fd(const Params& p, const float x[N],
                                            const Stencil& s, const Row& o) {
  const size_t B = o.B;
#pragma unroll
  for (int a = 0; a < N; ++a) {
    float t[NZ];
#pragma unroll
    for (int c = 0; c < NZ; ++c) t[c] = basis(c, a);
    float xp[N], xm[N], up, um;
    shift(x, 0.0f, t, s.eps, 1.0f, xp, &up);
    shift(x, 0.0f, t, s.eps, -1.0f, xm, &um);
    o.cx[a * B] =
        (acrobot::final_cost(p, xp) - acrobot::final_cost(p, xm)) / s.den1;
  }
  fd_second<false>(p, x, 0.0f, s, o);
}

template <bool kFD>
__global__ void __launch_bounds__(kBlock)
derivs_kernel(const float* __restrict__ params, const float* __restrict__ xs,
              const float* __restrict__ us, float* __restrict__ fx,
              float* __restrict__ fu, float* __restrict__ cx,
              float* __restrict__ cu, float* __restrict__ cxx,
              float* __restrict__ cxu, float* __restrict__ cuu, Stencil s,
              int T, int B_) {
  const size_t B = B_;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= (static_cast<size_t>(T) + 1) * B) return;
  const size_t t = idx / B;
  const size_t lane = idx - t * B;
  const Params p = acrobot::load_params(params);
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xs[(t * N + i) * B + lane];
  // t == T writes only the terminal row; the T-row outputs have no row T
  const size_t tr = t < static_cast<size_t>(T) ? t : 0;
  const Row o{fx + tr * N * N * B + lane, fu + tr * N * M * B + lane,
              cx + t * N * B + lane,      cu + tr * M * B + lane,
              cxx + t * N * N * B + lane, cxu + tr * N * M * B + lane,
              cuu + tr * M * M * B + lane, B};
  if (t == static_cast<size_t>(T)) {
    if (kFD)
      terminal_fd(p, x, s, o);
    else
      terminal_jvp(p, x, o);
    return;
  }
  const float u = us[t * B + lane];
  if (kFD)
    running_fd(p, x, u, s, o);
  else
    running_jvp(p, x, u, o);
}

}  // namespace

extern "C" {

int ilqr_derivs(const void* params, const void* xs, const void* us, void* fx,
                void* fu, void* cx, void* cu, void* cxx, void* cxu, void* cuu,
                int fd, float eps, float den1, float den2, int T, int B,
                void* stream) {
  const size_t threads = (static_cast<size_t>(T) + 1) * B;
  const dim3 grid(static_cast<unsigned>((threads + kBlock - 1) / kBlock));
  const Stencil s{eps, den1, den2};
  const float* p = (const float*)params;
  const float* x = (const float*)xs;
  const float* u = (const float*)us;
  cudaStream_t st = (cudaStream_t)stream;
  if (fd)
    derivs_kernel<true><<<grid, kBlock, 0, st>>>(
        p, x, u, (float*)fx, (float*)fu, (float*)cx, (float*)cu, (float*)cxx,
        (float*)cxu, (float*)cuu, s, T, B);
  else
    derivs_kernel<false><<<grid, kBlock, 0, st>>>(
        p, x, u, (float*)fx, (float*)fu, (float*)cx, (float*)cu, (float*)cxx,
        (float*)cxu, (float*)cuu, s, T, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
