// Power-limited planar point mass device functions (counterpart of the SoA
// functions of ilqr_tpu/models/power_mass.py and
// ilqr_tpu_torch/models/power_mass.py), as the fused kernels take a model
// (see acrobot.cuh Model). Every expression keeps the operation order of
// the Python SoA code.
//
// The mechanical-power penalty w_power·(v·u)² makes the running cost's
// Hessians live beyond the diagonal: cxx's velocity block gains
// 2·w_power·u uᵀ, cuu = 2·w_control·I + 2·w_power·v vᵀ is full, and cxu's
// velocity rows are 2·w_power·(u_a·v_j + δ_aj·s), s = v·u. Its patterns
// below (cost_pattern.cuh) make the sweep start Qxx, Qux and Quu at those
// entries.
#pragma once

#include "cost_pattern.cuh"

namespace power_mass {

struct Model {
  static constexpr int N = 4;  // [px, py, vx, vy]
  static constexpr int M = 2;  // [ux, uy]

  // Packed params (ops/kernel_rollout.pack_params): the params leaves in
  // field order, then dt.
  struct Params {
    float goal[N], mass, drag, w_state[N], w_control[M], w_power,
        w_final[N], u_min[M], u_max[M], dt;
  };

  // Structural pattern of jac(): '.' zero, '1' one, 'x' live (see
  // acrobot.cuh Model).
  __host__ __device__ static constexpr char a_kind(int r, int i) {
    return "..1."
           "...1"
           "..x."
           "...x"[r * N + i];
  }
  __host__ __device__ static constexpr char b_kind(int r, int j) {
    return ".."
           ".."
           "x."
           ".x"[r * M + j];
  }
  // Structural patterns of cost_derivs (cost_pattern.cuh): '.' zero,
  // 'x' live.
  __host__ __device__ static constexpr char cxx_kind(int r, int i) {
    return "x..."
           ".x.."
           "..xx"
           "..xx"[r * N + i];
  }
  __host__ __device__ static constexpr char cxu_kind(int r, int j) {
    return ".."
           ".."
           "xx"
           "xx"[r * M + j];
  }
  __host__ __device__ static constexpr char cuu_kind(int r, int j) {
    return "xx"
           "xx"[r * M + j];
  }

  __device__ __forceinline__ static Params load(const float* __restrict__ p) {
    Params q;
    for (int i = 0; i < N; ++i) q.goal[i] = p[i];
    q.mass = p[4];
    q.drag = p[5];
    for (int i = 0; i < N; ++i) q.w_state[i] = p[6 + i];
    for (int j = 0; j < M; ++j) q.w_control[j] = p[10 + j];
    q.w_power = p[12];
    for (int i = 0; i < N; ++i) q.w_final[i] = p[13 + i];
    for (int j = 0; j < M; ++j) q.u_min[j] = p[17 + j];
    for (int j = 0; j < M; ++j) q.u_max[j] = p[19 + j];
    q.dt = p[21];
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
    dx[0] = x[2];
    dx[1] = x[3];
    dx[2] = u[0] * inv_m - p.drag * x[2];
    dx[3] = u[1] * inv_m - p.drag * x[3];
  }
  __device__ __forceinline__ static float power(const float x[N],
                                                const float u[M]) {
    return x[2] * u[0] + x[3] * u[1];
  }
  __device__ __forceinline__ static float weighted_err(const Params& p,
                                                       const float w[N],
                                                       const float x[N]) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float e = p.goal[i] - x[i];
      const float term = e * w[i] * e;
      acc = i == 0 ? term : acc + term;
    }
    return acc;
  }
  __device__ __forceinline__ static float cost(const Params& p,
                                               const float x[N],
                                               const float u[M]) {
    float acc = weighted_err(p, p.w_state, x);
#pragma unroll
    for (int j = 0; j < M; ++j) acc = acc + u[j] * p.w_control[j] * u[j];
    const float s = power(x, u);
    return acc + p.w_power * s * s;
  }
  __device__ __forceinline__ static float final_cost(const Params& p,
                                                     const float x[N]) {
    return weighted_err(p, p.w_final, x);
  }

  // Continuous-time Jacobians (jac_soa); only the entries a_kind/b_kind
  // mark live are set.
  __device__ __forceinline__ static void jac(const Params& p, const float*,
                                             const float*, float A[N][N],
                                             float Bu[N][M]) {
    const float inv_m = 1.0f / p.mass;
    A[2][2] = -p.drag;
    A[3][3] = -p.drag;
    Bu[2][0] = inv_m;
    Bu[3][1] = inv_m;
  }
  // The live entries of the patterns above, each in the order of
  // cost_derivs_soa: the diagonal of cxx's velocity block is 2·w_state
  // plus its power term, cuu's diagonal its power term plus 2·w_control.
  __device__ __forceinline__ static void cost_derivs(
      const Params& p, const float x[N], const float u[M], float cx[N],
      float cu[M], float cxx[N][N], float cxu[N][M], float cuu[M][M]) {
    const float s = power(x, u);
    const float two_wp = 2.0f * p.w_power;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cx[i] = -2.0f * p.w_state[i] * (p.goal[i] - x[i]);
      cxx[i][i] = 2.0f * p.w_state[i];
    }
    cx[2] = cx[2] + two_wp * s * u[0];
    cx[3] = cx[3] + two_wp * s * u[1];
    cu[0] = 2.0f * p.w_control[0] * u[0] + two_wp * s * x[2];
    cu[1] = 2.0f * p.w_control[1] * u[1] + two_wp * s * x[3];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float extra = two_wp * u[a] * u[b];
        cxx[2 + a][2 + b] = a == b ? cxx[2 + a][2 + b] + extra : extra;
      }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < M; ++j)
        cxu[2 + a][j] = two_wp * (u[a] * x[2 + j] + (a == j ? s : 0.0f));
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) cuu[i][j] = two_wp * x[2 + i] * x[2 + j];
#pragma unroll
    for (int j = 0; j < M; ++j)
      cuu[j][j] = cuu[j][j] + 2.0f * p.w_control[j];
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

}  // namespace power_mass
