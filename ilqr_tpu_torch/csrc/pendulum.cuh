// Pendulum device functions (counterpart of the SoA functions of
// ilqr_tpu/models/pendulum.py and ilqr_tpu_torch/models/pendulum.py), as
// the fused kernels take a model (see acrobot.cuh Model). Every expression
// keeps the operation order of the Python SoA code; sinf/cosf are the
// full-accuracy ones (no fast math), as torch.sin/cos on the card.
#pragma once

#include "cost_pattern.cuh"

namespace pendulum {

struct Model : cost::DiagonalHessians {
  static constexpr int N = 2;  // [θ, θ̇]
  static constexpr int M = 1;  // [torque]

  // Packed params (ops/kernel_rollout.pack_params): the params leaves in
  // field order, then dt.
  struct Params {
    float goal[N], mass, length, damping, gravity, w_state[N], w_control,
        w_final[N], u_min, u_max, dt;
  };

  // Structural pattern of jac(): '.' zero, '1' one, 'x' live (see
  // acrobot.cuh Model).
  __host__ __device__ static constexpr char a_kind(int r, int i) {
    return ".1"
           "xx"[r * N + i];
  }
  __host__ __device__ static constexpr char b_kind(int r, int j) {
    return "."
           "x"[r * M + j];
  }

  __device__ __forceinline__ static Params load(const float* __restrict__ p) {
    Params q;
    q.goal[0] = p[0];
    q.goal[1] = p[1];
    q.mass = p[2];
    q.length = p[3];
    q.damping = p[4];
    q.gravity = p[5];
    q.w_state[0] = p[6];
    q.w_state[1] = p[7];
    q.w_control = p[8];
    q.w_final[0] = p[9];
    q.w_final[1] = p[10];
    q.u_min = p[11];
    q.u_max = p[12];
    q.dt = p[13];
    return q;
  }
  __device__ __forceinline__ static float u_lo(const Params& p, int) {
    return p.u_min;
  }
  __device__ __forceinline__ static float u_hi(const Params& p, int) {
    return p.u_max;
  }

  __device__ __forceinline__ static void dynamics(const Params& p,
                                                  const float x[N],
                                                  const float u[M],
                                                  float dx[N]) {
    const float inertia = p.mass * p.length * p.length;
    dx[0] = x[1];
    dx[1] = (u[0] - p.damping * x[1]
             - p.mass * p.gravity * p.length * sinf(x[0])) / inertia;
  }
  __device__ __forceinline__ static float cost(const Params& p,
                                               const float x[N],
                                               const float u[M]) {
    const float e0 = p.goal[0] - x[0];
    const float e1 = p.goal[1] - x[1];
    return p.w_state[0] * e0 * e0 + p.w_state[1] * e1 * e1
           + p.w_control * u[0] * u[0];
  }
  __device__ __forceinline__ static float final_cost(const Params& p,
                                                     const float x[N]) {
    const float e0 = p.goal[0] - x[0];
    const float e1 = p.goal[1] - x[1];
    return p.w_final[0] * e0 * e0 + p.w_final[1] * e1 * e1;
  }

  // Continuous-time Jacobians (jac_soa); only the entries a_kind/b_kind
  // mark live are set.
  __device__ __forceinline__ static void jac(const Params& p,
                                             const float x[N], const float*,
                                             float A[N][N], float Bu[N][M]) {
    const float inertia = p.mass * p.length * p.length;
    A[1][0] = -p.gravity / p.length * cosf(x[0]);
    A[1][1] = -p.damping / inertia;
    Bu[1][0] = 1.0f / inertia;
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
    cu[0] = 2.0f * p.w_control * u[0];
    cuu[0][0] = 2.0f * p.w_control;
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

}  // namespace pendulum
