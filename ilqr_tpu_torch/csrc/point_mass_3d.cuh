// 3D point mass device functions (counterpart of the SoA functions of
// ilqr_tpu/models/point_mass_3d.py and
// ilqr_tpu_torch/models/point_mass_3d.py), as the fused kernels take a
// model (see acrobot.cuh Model). Every expression keeps the operation order
// of the Python SoA code.
#pragma once

#include "cost_pattern.cuh"

namespace point_mass_3d {

struct Model : cost::DiagonalHessians {
  static constexpr int N = 6;  // [x, y, z, vx, vy, vz]
  static constexpr int M = 3;  // [Fx, Fy, Fz]

  // Packed params: the params leaves in field order, then dt.
  struct Params {
    float goal[N], mass, hx[N], hu[M], fs, u_min[M], u_max[M], dt;
  };

  // Structural pattern of jac(): '.' zero, '1' one, 'x' live.
  __host__ __device__ static constexpr char a_kind(int r, int i) {
    return "...1.."
           "....1."
           ".....1"
           "......"
           "......"
           "......"[r * N + i];
  }
  __host__ __device__ static constexpr char b_kind(int r, int j) {
    return "..."
           "..."
           "..."
           "x.."
           ".x."
           "..x"[r * M + j];
  }

  __device__ __forceinline__ static Params load(const float* __restrict__ p) {
    Params q;
    for (int i = 0; i < N; ++i) q.goal[i] = p[i];
    q.mass = p[6];
    for (int i = 0; i < N; ++i) q.hx[i] = p[7 + i];
    for (int j = 0; j < M; ++j) q.hu[j] = p[13 + j];
    q.fs = p[16];
    for (int j = 0; j < M; ++j) q.u_min[j] = p[17 + j];
    for (int j = 0; j < M; ++j) q.u_max[j] = p[20 + j];
    q.dt = p[23];
    return q;
  }
  __device__ __forceinline__ static float u_lo(const Params& p, int j) {
    return p.u_min[j];
  }
  __device__ __forceinline__ static float u_hi(const Params& p, int j) {
    return p.u_max[j];
  }

  __device__ __forceinline__ static void dynamics(const Params& p,
                                                  const float x[N],
                                                  const float u[M],
                                                  float dx[N]) {
    const float inv_m = 1.0f / p.mass;
    dx[0] = x[3];
    dx[1] = x[4];
    dx[2] = x[5];
    dx[3] = u[0] * inv_m;
    dx[4] = u[1] * inv_m;
    dx[5] = u[2] * inv_m;
  }
  __device__ __forceinline__ static float state_err_sq(const Params& p,
                                                       const float x[N]) {
    float acc = (p.goal[0] - x[0]) * p.hx[0] * (p.goal[0] - x[0]);
#pragma unroll
    for (int i = 1; i < N; ++i) {
      const float e = p.goal[i] - x[i];
      acc = acc + e * p.hx[i] * e;
    }
    return acc;
  }
  __device__ __forceinline__ static float cost(const Params& p,
                                               const float x[N],
                                               const float u[M]) {
    float acc = state_err_sq(p, x);
#pragma unroll
    for (int j = 0; j < M; ++j) acc = acc + u[j] * p.hu[j] * u[j];
    return acc;
  }
  __device__ __forceinline__ static float final_cost(const Params& p,
                                                     const float x[N]) {
    return p.fs * state_err_sq(p, x);
  }

  // A is all structural; Bu's live entries are 1/mass
  __device__ __forceinline__ static void jac(const Params& p, const float*,
                                             const float*, float A[N][N],
                                             float Bu[N][M]) {
    const float inv_m = 1.0f / p.mass;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      A[i][i + 3] = 1.0f;
      Bu[i + 3][i] = inv_m;
    }
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

}  // namespace point_mass_3d
