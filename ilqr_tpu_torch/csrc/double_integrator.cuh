// 2D double integrator device functions (counterpart of the SoA functions
// of ilqr_tpu/models/double_integrator.py and
// ilqr_tpu_torch/models/double_integrator.py), as the fused kernels take a
// model (see acrobot.cuh Model). Every expression keeps the operation order
// of the Python SoA code.
#pragma once

#include "cost_pattern.cuh"
#include "dual.cuh"

namespace double_integrator {

struct Model : cost::DiagonalHessians {
  static constexpr int N = 4;  // [x, y, vx, vy]
  static constexpr int M = 2;  // [Fx, Fy]
  // The whole iteration runs as a team of 32 threads per lane
  // (iteration_team.cuh, team::kTeamWidth): its 12 stencil sides
  // and 10 gain entries fit a warp, its 21 cost-Hessian pairs
  // take one round
  static constexpr bool kTeamIteration = true;

  // Packed params (ops/kernel_rollout.pack_params): the params leaves in
  // field order, then dt.
  struct Params {
    float goal[N], mass, hx[N], hu[M], fs, u_min[M], u_max[M], dt;
  };

  // Structural pattern of jac(): '.' zero, '1' one, 'x' live (see
  // acrobot.cuh Model).
  __host__ __device__ static constexpr char a_kind(int r, int i) {
    return "..1."
           "...1"
           "...."
           "...."[r * N + i];
  }
  __host__ __device__ static constexpr char b_kind(int r, int j) {
    return ".."
           ".."
           "x."
           ".x"[r * M + j];
  }

  __device__ __forceinline__ static Params load(const float* __restrict__ p) {
    Params q;
    for (int i = 0; i < N; ++i) q.goal[i] = p[i];
    q.mass = p[4];
    for (int i = 0; i < N; ++i) q.hx[i] = p[5 + i];
    for (int j = 0; j < M; ++j) q.hu[j] = p[9 + j];
    q.fs = p[11];
    for (int j = 0; j < M; ++j) q.u_min[j] = p[12 + j];
    for (int j = 0; j < M; ++j) q.u_max[j] = p[14 + j];
    q.dt = p[16];
    return q;
  }
  __device__ __forceinline__ static float u_lo(const Params& p, int j) {
    return p.u_min[j];
  }
  __device__ __forceinline__ static float u_hi(const Params& p, int j) {
    return p.u_max[j];
  }

  template <class S>
  __device__ __forceinline__ static void dynamics(const Params& p,
                                                  const S x[N], const S u[M],
                                                  S dx[N]) {
    dx[0] = x[2];
    dx[1] = x[3];
    dx[2] = u[0] / p.mass;
    dx[3] = u[1] / p.mass;
  }
  template <class S>
  __device__ __forceinline__ static S state_err_sq(const Params& p,
                                                   const S x[N]) {
    S acc{};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const S e = p.goal[i] - x[i];
      const S term = p.hx[i] * e * e;
      acc = i == 0 ? term : acc + term;
    }
    return acc;
  }
  template <class S>
  __device__ __forceinline__ static S cost(const Params& p, const S x[N],
                                           const S u[M]) {
    return state_err_sq(p, x) + p.hu[0] * u[0] * u[0]
           + p.hu[1] * u[1] * u[1];
  }
  template <class S>
  __device__ __forceinline__ static S final_cost(const Params& p,
                                                 const S x[N]) {
    return p.fs * state_err_sq(p, x);
  }

  // A is all structural; Bu's live entries are 1/mass
  __device__ __forceinline__ static void jac(const Params& p, const float*,
                                             const float*, float A[N][N],
                                             float Bu[N][M]) {
    const float inv_m = 1.0f / p.mass;
    A[0][2] = 1.0f;
    A[1][3] = 1.0f;
    Bu[2][0] = inv_m;
    Bu[3][1] = inv_m;
  }
  __device__ __forceinline__ static void cost_derivs(
      const Params& p, const float x[N], const float u[M], float cx[N],
      float cu[M], float cxx[N][N], float /*cxu*/[N][M],
      float cuu[M][M]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cx[i] = -2.0f * p.hx[i] * (p.goal[i] - x[i]);
      cxx[i][i] = 2.0f * p.hx[i];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      cu[j] = 2.0f * p.hu[j] * u[j];
      cuu[j][j] = 2.0f * p.hu[j];
    }
  }
  __device__ __forceinline__ static void final_cost_derivs(
      const Params& p, const float x[N], float cx[N], float cxx[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cx[i] = -2.0f * p.fs * p.hx[i] * (p.goal[i] - x[i]);
      cxx[i] = 2.0f * p.fs * p.hx[i];
    }
  }
};

}  // namespace double_integrator
