// Quadrotor device functions (counterpart of the SoA functions of
// ilqr_tpu/models/quadrotor.py and ilqr_tpu_torch/models/quadrotor.py), as
// the fused kernels take a model (see acrobot.cuh Model). Every expression
// keeps the operation order of the Python SoA code; the trig is the
// full-accuracy sincosf, as the JAX package's jnp.sin/jnp.cos off the TPU.
#pragma once

#include "cost_pattern.cuh"

namespace quadrotor {

struct Model : cost::DiagonalHessians {
  static constexpr int N = 12;  // [p (3), v (3), φ θ ψ, ω (3)]
  static constexpr int M = 4;   // per-rotor thrusts

  // Packed params: the params leaves in field order, then dt.
  struct Params {
    float goal[N], mass, gravity, arm, c_tau, inertia[3], hx[N], hu[M], fs,
        u_min[M], u_max[M], dt;
  };

  // Structural pattern of jac(): '.' zero, '1' one, 'x' live.
  __host__ __device__ static constexpr char a_kind(int r, int i) {
    return "...1........"
           "....1......."
           ".....1......"
           "......xxx..."
           "......xxx..."
           "......xx...."
           "......xx.1xx"
           "......x...xx"
           "......xx..xx"
           "..........xx"
           ".........x.x"
           ".........xx."[r * N + i];
  }
  __host__ __device__ static constexpr char b_kind(int r, int j) {
    return "...."
           "...."
           "...."
           "xxxx"
           "xxxx"
           "xxxx"
           "...."
           "...."
           "...."
           ".x.x"
           "x.x."
           "xxxx"[r * M + j];
  }

  __device__ __forceinline__ static Params load(const float* __restrict__ p) {
    Params q;
    for (int i = 0; i < N; ++i) q.goal[i] = p[i];
    q.mass = p[12];
    q.gravity = p[13];
    q.arm = p[14];
    q.c_tau = p[15];
    for (int i = 0; i < 3; ++i) q.inertia[i] = p[16 + i];
    for (int i = 0; i < N; ++i) q.hx[i] = p[19 + i];
    for (int j = 0; j < M; ++j) q.hu[j] = p[31 + j];
    q.fs = p[35];
    for (int j = 0; j < M; ++j) q.u_min[j] = p[36 + j];
    for (int j = 0; j < M; ++j) q.u_max[j] = p[40 + j];
    q.dt = p[44];
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
    const float F = u[0] + u[1] + u[2] + u[3];
    const float taux = p.arm * (u[1] - u[3]);
    const float tauy = p.arm * (u[2] - u[0]);
    const float tauz = p.c_tau * (u[0] - u[1] + u[2] - u[3]);
    float sph, cph, sth, cth, sps, cps;
    sincosf(x[6], &sph, &cph);
    sincosf(x[7], &sth, &cth);
    sincosf(x[8], &sps, &cps);
    const float Fm = F * inv_m;
    const float inv_cth = 1.0f / cth;
    const float tth = sth * inv_cth;
    const float Jx = p.inertia[0], Jy = p.inertia[1], Jz = p.inertia[2];
    dx[0] = x[3];
    dx[1] = x[4];
    dx[2] = x[5];
    dx[3] = Fm * (cph * sth * cps + sph * sps);
    dx[4] = Fm * (cph * sth * sps - sph * cps);
    dx[5] = Fm * (cph * cth) - p.gravity;
    dx[6] = x[9] + sph * tth * x[10] + cph * tth * x[11];
    dx[7] = cph * x[10] - sph * x[11];
    dx[8] = (sph * x[10] + cph * x[11]) * inv_cth;
    dx[9] = (taux - (Jz - Jy) * x[10] * x[11]) / Jx;
    dx[10] = (tauy - (Jx - Jz) * x[11] * x[9]) / Jy;
    dx[11] = (tauz - (Jy - Jx) * x[9] * x[10]) / Jz;
  }
  __device__ __forceinline__ static float state_err_sq(const Params& p,
                                                       const float x[N]) {
    float e = p.goal[0] - x[0];
    float acc = e * p.hx[0] * e;
#pragma unroll
    for (int i = 1; i < N; ++i) {
      e = p.goal[i] - x[i];
      acc = acc + e * p.hx[i] * e;
    }
    return acc;
  }
  __device__ __forceinline__ static float cost(const Params& p,
                                               const float x[N],
                                               const float u[M]) {
    const float hov = p.mass * p.gravity * 0.25f;
    float acc = state_err_sq(p, x);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float du = u[j] - hov;
      acc = acc + du * p.hu[j] * du;
    }
    return acc;
  }
  __device__ __forceinline__ static float final_cost(const Params& p,
                                                     const float x[N]) {
    return p.fs * state_err_sq(p, x);
  }

  // Continuous-time Jacobians (jac_soa); only the entries a_kind/b_kind
  // mark live or one are set.
  __device__ __forceinline__ static void jac(const Params& p,
                                             const float x[N],
                                             const float u[M],
                                             float A[N][N], float Bu[N][M]) {
    const float inv_m = 1.0f / p.mass;
    const float F = u[0] + u[1] + u[2] + u[3];
    const float Fm = F * inv_m;
    float sph, cph, sth, cth, sps, cps;
    sincosf(x[6], &sph, &cph);
    sincosf(x[7], &sth, &cth);
    sincosf(x[8], &sps, &cps);
    const float inv_cth = 1.0f / cth;
    const float tth = sth * inv_cth;
    const float sec2 = inv_cth * inv_cth;
    const float w1 = x[9], w2 = x[10], w3 = x[11];
    const float Jx = p.inertia[0], Jy = p.inertia[1], Jz = p.inertia[2];

    // world-frame thrust direction (third column of R_zyx)
    const float rx = cph * sth * cps + sph * sps;
    const float ry = cph * sth * sps - sph * cps;
    const float rz = cph * cth;

    A[0][3] = 1.0f;
    A[1][4] = 1.0f;
    A[2][5] = 1.0f;
    // v̇ rows: angle sensitivities of the thrust direction
    A[3][6] = Fm * (-sph * sth * cps + cph * sps);
    A[3][7] = Fm * (cph * cth * cps);
    A[3][8] = Fm * (-cph * sth * sps + sph * cps);
    A[4][6] = Fm * (-sph * sth * sps - cph * cps);
    A[4][7] = Fm * (cph * cth * sps);
    A[4][8] = Fm * rx;
    A[5][6] = Fm * (-sph * cth);
    A[5][7] = Fm * (-cph * sth);
    // Euler-rate rows: W(φ,θ)ω sensitivities
    A[6][6] = (cph * w2 - sph * w3) * tth;
    A[6][7] = (sph * w2 + cph * w3) * sec2;
    A[6][9] = 1.0f;
    A[6][10] = sph * tth;
    A[6][11] = cph * tth;
    A[7][6] = -sph * w2 - cph * w3;
    A[7][10] = cph;
    A[7][11] = -sph;
    A[8][6] = (cph * w2 - sph * w3) * inv_cth;
    A[8][7] = (sph * w2 + cph * w3) * sth * sec2;
    A[8][10] = sph * inv_cth;
    A[8][11] = cph * inv_cth;
    // body-rate rows: gyroscopic coupling
    A[9][10] = -(Jz - Jy) * w3 / Jx;
    A[9][11] = -(Jz - Jy) * w2 / Jx;
    A[10][9] = -(Jx - Jz) * w3 / Jy;
    A[10][11] = -(Jx - Jz) * w1 / Jy;
    A[11][9] = -(Jy - Jx) * w2 / Jz;
    A[11][10] = -(Jy - Jx) * w1 / Jz;

#pragma unroll
    for (int j = 0; j < M; ++j) {
      Bu[3][j] = rx * inv_m;
      Bu[4][j] = ry * inv_m;
      Bu[5][j] = rz * inv_m;
    }
    const float LJx = p.arm / Jx;
    const float LJy = p.arm / Jy;
    const float cJz = p.c_tau / Jz;
    Bu[9][1] = LJx;
    Bu[9][3] = -LJx;
    Bu[10][0] = -LJy;
    Bu[10][2] = LJy;
    Bu[11][0] = cJz;
    Bu[11][1] = -cJz;
    Bu[11][2] = cJz;
    Bu[11][3] = -cJz;
  }
  __device__ __forceinline__ static void cost_derivs(
      const Params& p, const float x[N], const float u[M], float cx[N],
      float cu[M], float cxx[N][N], float /*cxu*/[N][M],
      float cuu[M][M]) {
    const float hov = p.mass * p.gravity * 0.25f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cx[i] = -2.0f * p.hx[i] * (p.goal[i] - x[i]);
      cxx[i][i] = 2.0f * p.hx[i];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      cu[j] = 2.0f * p.hu[j] * (u[j] - hov);
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

}  // namespace quadrotor
