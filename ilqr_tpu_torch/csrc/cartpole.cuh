// Cart-pole device functions (counterpart of the SoA functions of
// ilqr_tpu/models/cartpole.py and ilqr_tpu_torch/models/cartpole.py), as
// the fused kernels take a model (see acrobot.cuh Model). Every expression
// keeps the operation order of the Python SoA code; the trig is the
// full-accuracy sincosf (no fast math), as in acrobot.cuh. 4/3 is the f32
// constant the JAX and PyTorch code round the Python float 4.0 / 3.0 to.
#pragma once

#include "cost_pattern.cuh"
#include "dual.cuh"

namespace cartpole {

struct Model : cost::DiagonalHessians {
  static constexpr int N = 4;  // [p, θ, ṗ, θ̇]
  static constexpr int M = 1;  // [cart force]
  // The whole iteration runs as a team of 16 threads per lane
  // (iteration_team.cuh): its 5 directions and 15 cost-Hessian pairs fit a
  // team
  static constexpr bool kTeamIteration = true;

  // Packed params (ops/kernel_rollout.pack_params): the params leaves in
  // field order, then dt.
  struct Params {
    float goal[N], mass_cart, mass_pole, length, gravity, w_state[N],
        w_control, w_final[N], u_min, u_max, dt;
  };

  // Structural pattern of jac(): '.' zero, '1' one, 'x' live (see
  // acrobot.cuh Model). Only θ and θ̇ enter the accelerations.
  __host__ __device__ static constexpr char a_kind(int r, int i) {
    return "..1."
           "...1"
           ".x.x"
           ".x.x"[r * N + i];
  }
  __host__ __device__ static constexpr char b_kind(int r, int j) {
    return "."
           "."
           "x"
           "x"[r * M + j];
  }

  __device__ __forceinline__ static Params load(const float* __restrict__ p) {
    Params q;
    for (int i = 0; i < N; ++i) q.goal[i] = p[i];
    q.mass_cart = p[4];
    q.mass_pole = p[5];
    q.length = p[6];
    q.gravity = p[7];
    for (int i = 0; i < N; ++i) q.w_state[i] = p[8 + i];
    q.w_control = p[12];
    for (int i = 0; i < N; ++i) q.w_final[i] = p[13 + i];
    q.u_min = p[17];
    q.u_max = p[18];
    q.dt = p[19];
    return q;
  }
  __device__ __forceinline__ static float u_lo(const Params& p, int) {
    return p.u_min;
  }
  __device__ __forceinline__ static float u_hi(const Params& p, int) {
    return p.u_max;
  }

  // dynamics, cost and final_cost: templates on the scalar (acrobot.cuh)
  template <class S>
  __device__ __forceinline__ static void dynamics(const Params& p,
                                                  const S x[N], const S u[M],
                                                  S dx[N]) {
    const S thetadot = x[3];
    const float mt = p.mass_cart + p.mass_pole;
    S st, ct;
    dual::sincos_of(x[1], &st, &ct);
    const S temp =
        (u[0] + p.mass_pole * p.length * thetadot * thetadot * st) / mt;
    const S thetaddot =
        (-p.gravity * st - ct * temp)
        / (p.length * (4.0f / 3.0f - p.mass_pole * ct * ct / mt));
    dx[0] = x[2];
    dx[1] = x[3];
    dx[2] = temp + p.mass_pole * p.length * thetaddot * ct / mt;
    dx[3] = thetaddot;
  }
  template <class S>
  __device__ __forceinline__ static S weighted_err(const Params& p,
                                                   const float w[N],
                                                   const S x[N]) {
    S acc{};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const S e = p.goal[i] - x[i];
      const S term = w[i] * e * e;
      acc = i == 0 ? term : acc + term;
    }
    return acc;
  }
  template <class S>
  __device__ __forceinline__ static S cost(const Params& p, const S x[N],
                                           const S u[M]) {
    return weighted_err(p, p.w_state, x) + p.w_control * u[0] * u[0];
  }
  template <class S>
  __device__ __forceinline__ static S final_cost(const Params& p,
                                                 const S x[N]) {
    return weighted_err(p, p.w_final, x);
  }

  // Continuous-time Jacobians (jac_soa); only the entries a_kind/b_kind
  // mark live are set. One reciprocal per distinct denominator (mt, D).
  __device__ __forceinline__ static void jac(const Params& p,
                                             const float x[N],
                                             const float u[M], float A[N][N],
                                             float Bu[N][M]) {
    const float thetadot = x[3];
    const float mt = p.mass_cart + p.mass_pole;
    const float rmt = 1.0f / mt;
    const float k = p.mass_pole * rmt;
    const float kl = k * p.length;
    float st, ct;
    sincosf(x[1], &st, &ct);
    const float temp =
        (u[0] + p.mass_pole * p.length * thetadot * thetadot * st) * rmt;
    const float dtemp_dth = kl * thetadot * thetadot * ct;
    const float dtemp_dw = 2.0f * kl * thetadot * st;
    const float rD = 1.0f / (p.length * (4.0f / 3.0f - k * ct * ct));
    const float a2 = (-p.gravity * st - ct * temp) * rD;  // θ̈
    const float dD_dth = 2.0f * p.length * k * ct * st;
    const float dN_dth = -p.gravity * ct + st * temp - ct * dtemp_dth;
    const float da2_dth = (dN_dth - a2 * dD_dth) * rD;
    const float da2_dw = -ct * dtemp_dw * rD;
    const float da2_du = -ct * rmt * rD;
    A[2][1] = dtemp_dth + kl * (da2_dth * ct - a2 * st);
    A[2][3] = dtemp_dw + kl * ct * da2_dw;
    A[3][1] = da2_dth;
    A[3][3] = da2_dw;
    Bu[2][0] = rmt + kl * ct * da2_du;
    Bu[3][0] = da2_du;
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

}  // namespace cartpole
