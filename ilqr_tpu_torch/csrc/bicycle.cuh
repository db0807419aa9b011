// Kinematic bicycle device functions (counterpart of the SoA functions of
// ilqr_tpu/models/bicycle.py and ilqr_tpu_torch/models/bicycle.py), as the
// fused kernels take a model (see acrobot.cuh Model). Every expression
// keeps the operation order of the Python SoA code; sincosf and tanf are
// the full-accuracy ones (no fast math), as torch.sin/cos/tan on the card.
// The box is asymmetric (u_lo/u_hi per control).
#pragma once

#include "cost_pattern.cuh"
#include "dual.cuh"

namespace bicycle {

struct Model : cost::DiagonalHessians {
  static constexpr int N = 4;  // [px, py, ψ, v]
  static constexpr int M = 2;  // [a, δ]
  // The whole iteration runs as a team of 32 threads per lane
  // (iteration_team.cuh, team::kTeamWidth): its 12 stencil sides
  // and 10 gain entries fit a warp, its 21 cost-Hessian pairs
  // take one round
  static constexpr bool kTeamIteration = true;

  // Packed params (ops/kernel_rollout.pack_params): the params leaves in
  // field order, then dt.
  struct Params {
    float goal[N], wheelbase, w_state[N], w_control[M], w_final[N],
        u_min[M], u_max[M], dt;
  };

  // Structural pattern of jac(): '.' zero, '1' one, 'x' live (see
  // acrobot.cuh Model); ∂v̇/∂a is a structural one.
  __host__ __device__ static constexpr char a_kind(int r, int i) {
    return "..xx"
           "..xx"
           "...x"
           "...."[r * N + i];
  }
  __host__ __device__ static constexpr char b_kind(int r, int j) {
    return ".."
           ".."
           ".x"
           "1."[r * M + j];
  }

  __device__ __forceinline__ static Params load(const float* __restrict__ p) {
    Params q;
    for (int i = 0; i < N; ++i) q.goal[i] = p[i];
    q.wheelbase = p[4];
    for (int i = 0; i < N; ++i) q.w_state[i] = p[5 + i];
    for (int j = 0; j < M; ++j) q.w_control[j] = p[9 + j];
    for (int i = 0; i < N; ++i) q.w_final[i] = p[11 + i];
    for (int j = 0; j < M; ++j) q.u_min[j] = p[15 + j];
    for (int j = 0; j < M; ++j) q.u_max[j] = p[17 + j];
    q.dt = p[19];
    return q;
  }
  __device__ __forceinline__ static float u_lo(const Params& p, int j) {
    return p.u_min[j];
  }
  __device__ __forceinline__ static float u_hi(const Params& p, int j) {
    return p.u_max[j];
  }

  // dynamics, cost and final_cost: templates on the scalar (acrobot.cuh)
  template <class S>
  __device__ __forceinline__ static void dynamics(const Params& p,
                                                  const S x[N], const S u[M],
                                                  S dx[N]) {
    const S v = x[3];
    const float inv_L = 1.0f / p.wheelbase;
    S sp, cp;
    dual::sincos_of(x[2], &sp, &cp);
    dx[0] = v * cp;
    dx[1] = v * sp;
    dx[2] = v * dual::tan_of(u[1]) * inv_L;
    dx[3] = u[0] + 0.0f * v;
  }
  template <class S>
  __device__ __forceinline__ static S weighted_err(const Params& p,
                                                   const float w[N],
                                                   const S x[N]) {
    S acc{};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const S e = p.goal[i] - x[i];
      const S term = e * w[i] * e;
      acc = i == 0 ? term : acc + term;
    }
    return acc;
  }
  template <class S>
  __device__ __forceinline__ static S cost(const Params& p, const S x[N],
                                           const S u[M]) {
    S acc = weighted_err(p, p.w_state, x);
#pragma unroll
    for (int j = 0; j < M; ++j) acc = acc + u[j] * p.w_control[j] * u[j];
    return acc;
  }
  template <class S>
  __device__ __forceinline__ static S final_cost(const Params& p,
                                                 const S x[N]) {
    return weighted_err(p, p.w_final, x);
  }

  // Continuous-time Jacobians (jac_soa); only the entries a_kind/b_kind
  // mark live are set.
  __device__ __forceinline__ static void jac(const Params& p,
                                             const float x[N],
                                             const float u[M], float A[N][N],
                                             float Bu[N][M]) {
    const float v = x[3];
    float sp, cp;
    sincosf(x[2], &sp, &cp);
    const float inv_L = 1.0f / p.wheelbase;
    const float td = tanf(u[1]);
    const float sec2 = 1.0f + td * td;
    A[0][2] = -v * sp;
    A[0][3] = cp;
    A[1][2] = v * cp;
    A[1][3] = sp;
    A[2][3] = td * inv_L;
    Bu[2][1] = v * sec2 * inv_L;
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
      cu[j] = 2.0f * p.w_control[j] * u[j];
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

}  // namespace bicycle
