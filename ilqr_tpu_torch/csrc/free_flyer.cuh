// Free-flyer (8 cube-corner thrusters) device functions (counterpart of the
// SoA functions of ilqr_tpu/models/free_flyer.py and
// ilqr_tpu_torch/models/free_flyer.py), as the fused kernels take a model
// (see acrobot.cuh Model). Every expression keeps the operation order of
// the Python SoA code.
#pragma once

#include "cost_pattern.cuh"

namespace free_flyer {

struct Model : cost::DiagonalHessians {
  static constexpr int N = 6;  // [px, py, pz, vx, vy, vz]
  static constexpr int M = 8;  // thrusts along the cube diagonals

  // 1/√3 rounded to f32, as the JAX package rounds the Python constant
  static constexpr float kInvSqrt3 = 0.57735026f;

  // Packed params: the params leaves in field order, then dt.
  struct Params {
    float goal[N], mass, drag, w_state[N], w_control[M], w_fuel, w_final[N],
        u_min[M], u_max[M], dt;
  };

  // sign of thruster j on axis a: bit a of j
  __host__ __device__ static constexpr float sign(int j, int a) {
    return ((j >> a) & 1) ? 1.0f : -1.0f;
  }

  // Structural pattern of jac(): '.' zero, '1' one, 'x' live.
  __host__ __device__ static constexpr char a_kind(int r, int i) {
    return "...1.."
           "....1."
           ".....1"
           "...x.."
           "....x."
           ".....x"[r * N + i];
  }
  __host__ __device__ static constexpr char b_kind(int r, int j) {
    return "........"
           "........"
           "........"
           "xxxxxxxx"
           "xxxxxxxx"
           "xxxxxxxx"[r * M + j];
  }

  __device__ __forceinline__ static Params load(const float* __restrict__ p) {
    Params q;
    for (int i = 0; i < N; ++i) q.goal[i] = p[i];
    q.mass = p[6];
    q.drag = p[7];
    for (int i = 0; i < N; ++i) q.w_state[i] = p[8 + i];
    for (int j = 0; j < M; ++j) q.w_control[j] = p[14 + j];
    q.w_fuel = p[22];
    for (int i = 0; i < N; ++i) q.w_final[i] = p[23 + i];
    for (int j = 0; j < M; ++j) q.u_min[j] = p[29 + j];
    for (int j = 0; j < M; ++j) q.u_max[j] = p[37 + j];
    q.dt = p[45];
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
    const float scale = kInvSqrt3 / p.mass;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float s = sign(0, a) * u[0];
#pragma unroll
      for (int j = 1; j < M; ++j) s = s + sign(j, a) * u[j];
      const float v = x[3 + a];
      dx[a] = v;
      dx[3 + a] = scale * s - p.drag * fabsf(v) * v;
    }
  }
  __device__ __forceinline__ static float weighted_sq(const Params& p,
                                                      const float w[N],
                                                      const float x[N]) {
    float e = p.goal[0] - x[0];
    float acc = e * w[0] * e;
#pragma unroll
    for (int i = 1; i < N; ++i) {
      e = p.goal[i] - x[i];
      acc = acc + e * w[i] * e;
    }
    return acc;
  }
  __device__ __forceinline__ static float cost(const Params& p,
                                               const float x[N],
                                               const float u[M]) {
    float acc = weighted_sq(p, p.w_state, x);
#pragma unroll
    for (int j = 0; j < M; ++j)
      acc = acc + u[j] * (p.w_control[j] * u[j] + p.w_fuel);
    return acc;
  }
  __device__ __forceinline__ static float final_cost(const Params& p,
                                                     const float x[N]) {
    return weighted_sq(p, p.w_final, x);
  }

  // Continuous-time Jacobians (jac_soa); only the entries a_kind/b_kind
  // mark live are set. d|v|·v/dv = 2|v|.
  __device__ __forceinline__ static void jac(const Params& p,
                                             const float x[N],
                                             const float*, float A[N][N],
                                             float Bu[N][M]) {
    const float scale = kInvSqrt3 / p.mass;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      A[3 + a][3 + a] = -2.0f * p.drag * fabsf(x[3 + a]);
#pragma unroll
      for (int j = 0; j < M; ++j) Bu[3 + a][j] = sign(j, a) * scale;
    }
  }
  __device__ __forceinline__ static void cost_derivs(
      const Params& p, const float x[N], const float u[M], float cx[N],
      float cu[M], float cxx[N][N], float /*cxu*/[N][M],
      float cuu[M][M]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cx[i] = -2.0f * p.w_state[i] * (p.goal[i] - x[i]);
      cxx[i][i] = 2.0f * p.w_state[i];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      cu[j] = 2.0f * p.w_control[j] * u[j] + p.w_fuel;
      cuu[j][j] = 2.0f * p.w_control[j];
    }
  }
  __device__ __forceinline__ static void final_cost_derivs(
      const Params& p, const float x[N], float cx[N], float cxx[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cx[i] = -2.0f * p.w_final[i] * (p.goal[i] - x[i]);
      cxx[i] = 2.0f * p.w_final[i];
    }
  }
};

}  // namespace free_flyer
