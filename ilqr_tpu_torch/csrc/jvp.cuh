// Exact forward-mode derivatives for any model given as a traits struct
// (acrobot.cuh Model), per lane: counterpart of
// ilqr_tpu/ops/pallas_sweep.py _model_closures make_dops in "jvp" mode, as
// _sweep_step and _terminal_init use it when the closed forms do not apply
// (the RK4 step). They differentiate the DISCRETE step (integrate.cuh,
// Euler or RK4, through all its stages) and the running and final costs
// over the n + m directions of (x, u), the states first, with the dual
// numbers of dual.cuh:
//  - fx, fu columns and cx, cu: one first-order dual pass (Dual<float>)
//    per basis direction a, the tangent 1 on component a and 0 elsewhere;
//  - cxx, cxu, cuu: one second-order pass (Dual<Dual<float>>) per pair
//    (a, b ≥ a), inner direction a and outer direction b as JAX nests
//    jvp(jvp(f, t_a), t_b), mirrored on the symmetric blocks;
//  - V_T: the same for the final cost over the n state directions.
//
// Every entry is live, so the sweep step folds nothing under this policy
// (sweep_step.cuh Jvp). As in fd.cuh the loops over directions and pairs
// stay loops: unrolled they emit (n + m)² model evaluations per step,
// which changes code size and compile time, not the order of any
// operation. Results indexed by a runtime direction live in local memory.
#pragma once

#include "dual.cuh"
#include "integrate.cuh"

namespace jvp {

using D1 = dual::Dual<float>;
using D2 = dual::Dual<D1>;

// tangent of input component c along direction a
__device__ __forceinline__ float basis(int c, int a) {
  return c == a ? 1.0f : 0.0f;
}

// (x, u) seeded along direction a
template <class Model>
__device__ __forceinline__ void seed1(const float x[Model::N],
                                      const float u[Model::M], int a,
                                      D1 xd[Model::N], D1 ud[Model::M]) {
  constexpr int N = Model::N, M = Model::M;
#pragma unroll
  for (int c = 0; c < N; ++c) xd[c] = {x[c], basis(c, a)};
#pragma unroll
  for (int j = 0; j < M; ++j) ud[j] = {u[j], basis(N + j, a)};
}

// (x, u) seeded along the pair (a, b): inner direction a, outer b
template <class Model>
__device__ __forceinline__ void seed2(const float x[Model::N],
                                      const float u[Model::M], int a, int b,
                                      D2 xd[Model::N], D2 ud[Model::M]) {
  constexpr int N = Model::N, M = Model::M;
#pragma unroll
  for (int c = 0; c < N; ++c)
    xd[c] = {{x[c], basis(c, b)}, {basis(c, a), 0.0f}};
#pragma unroll
  for (int j = 0; j < M; ++j)
    ud[j] = {{u[j], basis(N + j, b)}, {basis(N + j, a), 0.0f}};
}

// Direction a of (x, u), the states first: column a of the discrete step's
// Jacobian (fx | fu) into col, and entry a of the running cost's gradient
// (cx | cu) returned, from one first-order dual pass
template <class Model>
__device__ __forceinline__ float direction(const typename Model::Params& p,
                                           const float x[Model::N],
                                           const float u[Model::M], int a,
                                           int scheme, float col[Model::N]) {
  constexpr int N = Model::N, M = Model::M;
  D1 xd[N], ud[M], y[N];
  seed1<Model>(x, u, a, xd, ud);
  integrate::step<Model, D1>(p, xd, ud, scheme, y);
  const float dc = Model::cost(p, xd, ud).d;
#pragma unroll
  for (int r = 0; r < N; ++r) col[r] = y[r].d;
  return dc;
}

// The second derivative of the running cost (or, kRunning false, the final
// cost, which ignores u) along the pair (a, b): one second-order pass
template <class Model, bool kRunning>
__device__ __forceinline__ float second(const typename Model::Params& p,
                                        const float x[Model::N],
                                        const float u[Model::M], int a,
                                        int b) {
  constexpr int N = Model::N, M = Model::M;
  D2 xd[N], ud[M];
  seed2<Model>(x, u, a, b, xd, ud);
  if constexpr (kRunning) return Model::cost(p, xd, ud).d.d;
  return Model::final_cost(p, xd).d.d;
}

// Entry a of the final cost's gradient at x_T, with u_T = 0
template <class Model>
__device__ __forceinline__ float final_direction(
    const typename Model::Params& p, const float xT[Model::N], int a) {
  constexpr int N = Model::N, M = Model::M;
  float u0[M];
#pragma unroll
  for (int j = 0; j < M; ++j) u0[j] = 0.0f;
  D1 xd[N], ud[M];
  seed1<Model>(xT, u0, a, xd, ud);
  return Model::final_cost(p, xd).d;
}

// fx, fu of the discrete step and cx, cu, cxx, cxu, cuu of the running cost
// at (x, u), every entry written (the symmetric blocks mirrored).
template <class Model>
__device__ __forceinline__ void linearize(
    const typename Model::Params& p, const float x[Model::N],
    const float u[Model::M], int scheme, float fx[Model::N][Model::N],
    float fu[Model::N][Model::M], float cx[Model::N], float cu[Model::M],
    float cxx[Model::N][Model::N], float cxu[Model::N][Model::M],
    float cuu[Model::M][Model::M]) {
  constexpr int N = Model::N, M = Model::M, NZ = N + M;
#pragma unroll 1
  for (int a = 0; a < NZ; ++a) {
    float col[N];
    const float dc = direction<Model>(p, x, u, a, scheme, col);
    if (a < N) {
#pragma unroll
      for (int r = 0; r < N; ++r) fx[r][a] = col[r];
      cx[a] = dc;
    } else {
#pragma unroll
      for (int r = 0; r < N; ++r) fu[r][a - N] = col[r];
      cu[a - N] = dc;
    }
  }
#pragma unroll 1
  for (int a = 0; a < NZ; ++a) {
#pragma unroll 1
    for (int b = a; b < NZ; ++b) {
      const float h = second<Model, true>(p, x, u, a, b);
      if (b < N) {
        cxx[a][b] = h;
        cxx[b][a] = h;
      } else if (a < N) {
        cxu[a][b - N] = h;
      } else {
        cuu[a - N][b - N] = h;
        cuu[b - N][a - N] = h;
      }
    }
  }
}

// V_T: the final cost's gradient and its dense Hessian at x_T, with u_T = 0
// (pallas_sweep._terminal_init, non-analytic branch)
template <class Model>
__device__ __forceinline__ void terminal(const typename Model::Params& p,
                                         const float xT[Model::N],
                                         float vx[Model::N],
                                         float vxx[Model::N][Model::N]) {
  constexpr int N = Model::N, M = Model::M;
  float u0[M];
#pragma unroll
  for (int j = 0; j < M; ++j) u0[j] = 0.0f;
#pragma unroll 1
  for (int a = 0; a < N; ++a) vx[a] = final_direction<Model>(p, xT, a);
#pragma unroll 1
  for (int a = 0; a < N; ++a) {
#pragma unroll 1
    for (int b = a; b < N; ++b) {
      const float h = second<Model, false>(p, xT, u0, a, b);
      vxx[a][b] = h;
      vxx[b][a] = h;
    }
  }
}

}  // namespace jvp
