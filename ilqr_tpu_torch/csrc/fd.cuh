// The reference's central stencils (finite_diff.h:22-86) for any model given
// as a traits struct (acrobot.cuh Model), per lane: counterpart of
// ilqr_tpu/ops/pallas_sweep.py _model_closures make_dops in "fd" mode, as
// _sweep_step and _terminal_init use it. They differentiate the DISCRETE
// step (integrate.cuh, Euler or RK4) and the running and final costs over
// the n + m directions of (x, u), the states first.
//
// Arithmetic, as the JAX kernel's: each perturbed point is z ± eps·t over
// every component of (x, u), for a tangent t of 0/±1/±2 entries (x + eps·t
// and x − eps·t as written, so that a zero tangent leaves a component as
// JAX leaves it); the first derivative is (F₊ − F₋) / den1, the second
// (f₊₊ − f₊₋ − f₋₊ + f₋₋) / den2, with den1 = f32(2·eps) and den2 =
// f32(4·eps²) rounded once from double on the host as JAX rounds the Python
// floats. A diagonal pair (a, a) takes t_a + t_a = 2 and t_a − t_a = 0.
//
// Every entry is live, so the sweep step folds nothing under this policy
// (sweep_step.cuh FiniteDiff). The loops over directions and pairs stay
// loops: unrolled they emit (n + m)² model evaluations per step, which
// changes code size and compile time, not the order of any operation.
// Results indexed by a runtime direction live in local memory.
#pragma once

#include "integrate.cuh"

namespace fd {

// eps, the two denominators, and the integrator the stencils differentiate
struct Stencil {
  float eps, den1, den2;
  int scheme;
};

// Tangent component c of the point (a, b, tb): [c == a] + tb·[c == b], with
// tb = +1 for t_a + t_b, −1 for t_a − t_b, 0 for the first-order basis t_a.
__device__ __forceinline__ float tangent(int c, int a, int b, float tb) {
  return (c == a ? 1.0f : 0.0f) + tb * (c == b ? 1.0f : 0.0f);
}

// (xq, uq) = (x, u) + eps·t (plus) or − eps·t, t the tangent (a, b, tb)
template <class Model>
__device__ __forceinline__ void shift(const float x[Model::N],
                                      const float u[Model::M], int a, int b,
                                      float tb, float eps, bool plus,
                                      float xq[Model::N], float uq[Model::M]) {
  constexpr int N = Model::N, M = Model::M;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const float st = eps * tangent(c, a, b, tb);
    xq[c] = plus ? x[c] + st : x[c] - st;
  }
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float st = eps * tangent(N + j, a, b, tb);
    uq[j] = plus ? u[j] + st : u[j] - st;
  }
}

// The running cost, or the final cost (which ignores u)
template <class Model, bool kRunning>
__device__ __forceinline__ float cost_at(const typename Model::Params& p,
                                         const float x[Model::N],
                                         const float u[Model::M]) {
  if constexpr (kRunning) return Model::cost(p, x, u);
  return Model::final_cost(p, x);
}

// The second derivative of a cost along the pair (a, b):
// (f(z + eps·(t_a + t_b)) − f(z + eps·(t_a − t_b)) − f(z − eps·(t_a − t_b))
//  + f(z − eps·(t_a + t_b))) / den2
template <class Model, bool kRunning>
__device__ __forceinline__ float second(const typename Model::Params& p,
                                        const float x[Model::N],
                                        const float u[Model::M], int a, int b,
                                        const Stencil& s) {
  float xq[Model::N], uq[Model::M];
  shift<Model>(x, u, a, b, 1.0f, s.eps, true, xq, uq);
  const float fpp = cost_at<Model, kRunning>(p, xq, uq);
  shift<Model>(x, u, a, b, -1.0f, s.eps, true, xq, uq);
  const float fpm = cost_at<Model, kRunning>(p, xq, uq);
  shift<Model>(x, u, a, b, -1.0f, s.eps, false, xq, uq);
  const float fmp = cost_at<Model, kRunning>(p, xq, uq);
  shift<Model>(x, u, a, b, 1.0f, s.eps, false, xq, uq);
  const float fmm = cost_at<Model, kRunning>(p, xq, uq);
  return (fpp - fpm - fmp + fmm) / s.den2;
}

// Direction a of (x, u), the states first: column a of the discrete step's
// Jacobian (fx | fu) into col, and entry a of the running cost's gradient
// (cx | cu) returned, each (F₊ − F₋) / den1
template <class Model>
__device__ __forceinline__ float direction(const typename Model::Params& p,
                                           const float x[Model::N],
                                           const float u[Model::M], int a,
                                           const Stencil& s,
                                           float col[Model::N]) {
  constexpr int N = Model::N, M = Model::M;
  float xp[N], up[M], xm[N], um[M], yp[N], ym[N];
  shift<Model>(x, u, a, -1, 0.0f, s.eps, true, xp, up);
  shift<Model>(x, u, a, -1, 0.0f, s.eps, false, xm, um);
  integrate::step<Model>(p, xp, up, s.scheme, yp);
  integrate::step<Model>(p, xm, um, s.scheme, ym);
  const float dc = (Model::cost(p, xp, up) - Model::cost(p, xm, um))
                   / s.den1;
#pragma unroll
  for (int r = 0; r < N; ++r) col[r] = (yp[r] - ym[r]) / s.den1;
  return dc;
}

// Entry a of the final cost's gradient at x_T, with u_T = 0
template <class Model>
__device__ __forceinline__ float final_direction(
    const typename Model::Params& p, const float xT[Model::N], int a,
    const Stencil& s) {
  constexpr int N = Model::N, M = Model::M;
  float u0[M], xp[N], up[M], xm[N], um[M];
#pragma unroll
  for (int j = 0; j < M; ++j) u0[j] = 0.0f;
  shift<Model>(xT, u0, a, -1, 0.0f, s.eps, true, xp, up);
  shift<Model>(xT, u0, a, -1, 0.0f, s.eps, false, xm, um);
  return (Model::final_cost(p, xp) - Model::final_cost(p, xm)) / s.den1;
}

// fx, fu of the discrete step and cx, cu, cxx, cxu, cuu of the running cost
// at (x, u), every entry written (the symmetric blocks mirrored).
template <class Model>
__device__ __forceinline__ void linearize(
    const typename Model::Params& p, const float x[Model::N],
    const float u[Model::M], const Stencil& s, float fx[Model::N][Model::N],
    float fu[Model::N][Model::M], float cx[Model::N], float cu[Model::M],
    float cxx[Model::N][Model::N], float cxu[Model::N][Model::M],
    float cuu[Model::M][Model::M]) {
  constexpr int N = Model::N, M = Model::M, NZ = N + M;
#pragma unroll 1
  for (int a = 0; a < NZ; ++a) {
    float col[N];
    const float dc = direction<Model>(p, x, u, a, s, col);
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
      const float h = second<Model, true>(p, x, u, a, b, s);
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
// (pallas_sweep._terminal_init, stencil branch)
template <class Model>
__device__ __forceinline__ void terminal(const typename Model::Params& p,
                                         const float xT[Model::N],
                                         const Stencil& s, float vx[Model::N],
                                         float vxx[Model::N][Model::N]) {
  constexpr int N = Model::N, M = Model::M;
  float u0[M];
#pragma unroll
  for (int j = 0; j < M; ++j) u0[j] = 0.0f;
#pragma unroll 1
  for (int a = 0; a < N; ++a) vx[a] = final_direction<Model>(p, xT, a, s);
#pragma unroll 1
  for (int a = 0; a < N; ++a) {
#pragma unroll 1
    for (int b = a; b < N; ++b) {
      const float h = second<Model, false>(p, xT, u0, a, b, s);
      vxx[a][b] = h;
      vxx[b][a] = h;
    }
  }
}

}  // namespace fd
