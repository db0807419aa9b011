// Acrobot model device functions (counterpart of the SoA functions of
// ilqr_tpu/models/acrobot.py and ilqr_tpu_torch/models/acrobot.py).
//
// Every expression keeps the operation order of the Python SoA code, so
// that with --fmad=false each value is the same IEEE f32 result the plain
// PyTorch version computes op by op. The trig uses the full-accuracy
// sincosf (not the __sinf/__cosf intrinsics that --use_fast_math would
// select) and the angle-sum identities for q1+q2, as the JAX package does
// off the TPU.
#pragma once

#include "cost_pattern.cuh"
#include "dual.cuh"

namespace acrobot {

constexpr int N = 4;   // state dims
constexpr int M = 1;   // control dims
// Packed params (ops/kernel_rollout.pack_params): AcrobotParams leaves in
// field order, then dt.
constexpr int P = 21;

struct Params {
  float goal[N];
  float i1, i2, l1, l2, m1, m2, lc1, lc2, g;
  float ks, kd, kr;    // running-cost gains
  float kfs, kfd;      // final-cost gains
  float u_min, u_max;
  float dt;
};

__device__ __forceinline__ Params load_params(const float* __restrict__ p) {
  Params q;
  for (int i = 0; i < N; ++i) q.goal[i] = p[i];
  q.i1 = p[4];  q.i2 = p[5];
  q.l1 = p[6];  q.l2 = p[7];
  q.m1 = p[8];  q.m2 = p[9];
  q.lc1 = p[10]; q.lc2 = p[11];
  q.g = p[12];
  q.ks = p[13]; q.kd = p[14]; q.kr = p[15];
  q.kfs = p[16]; q.kfd = p[17];
  q.u_min = p[18]; q.u_max = p[19];
  q.dt = p[20];
  return q;
}

// The model functions are templates on the scalar type S: float for the
// rollouts and the sweep, dual::Dual<float> and dual::Dual<dual::Dual<float>>
// for the derivative kernel's exact first and second derivatives
// (dual.cuh). Params stay float: they are constants of every derivative.
// With S = float the code is the same sequence of IEEE operations as before
// templating.

// f(x, u): [q̇1, q̇2, q̈1, q̈2] with the 2×2 H-solve through one reciprocal
// determinant. C(0,1) uses l2 (reference quirk, include/acrobot.h:53-61).
template <class S>
__device__ __forceinline__ void dynamics(const Params& p, const S x[N],
                                         const S& u, S dx[N]) {
  using dual::sincos_of;
  const S qd1 = x[2], qd2 = x[3];
  S s1, c1, s2, c2;
  sincos_of(x[0], &s1, &c1);
  sincos_of(x[1], &s2, &c2);
  const S s12 = s1 * c2 + c1 * s2;

  const float kk = p.m2 * p.l1 * p.lc2;
  const S kkc2 = kk * c2;
  const S h11 = p.i1 + p.i2 + p.m2 * p.l1 * p.l1 + 2.0f * kkc2;
  const S h12 = p.i2 + kkc2;
  const float h22 = p.i2;
  const S kks2 = kk * s2;

  const S gBs12 = p.m2 * p.g * p.lc2 * s12;
  const S g1 = (p.m1 * p.g * p.lc1 + p.m2 * p.g * p.l1) * s1 + gBs12;
  const S b1 =
      (2.0f * kks2 * qd1 + (p.m2 * p.l2 * p.lc2) * s2 * qd2) * qd2 - g1;
  const S b2 = u - kks2 * qd1 * qd1 - gBs12;

  const S rdet = 1.0f / (h11 * h22 - h12 * h12);
  dx[0] = qd1;
  dx[1] = qd2;
  dx[2] = (h22 * b1 - h12 * b2) * rdet;
  dx[3] = (h11 * b2 - h12 * b1) * rdet;
}

template <class S>
__device__ __forceinline__ S cost(const Params& p, const S x[N], const S& u) {
  const S e0 = p.goal[0] - x[0];
  const S e1 = p.goal[1] - x[1];
  const S e2 = p.goal[2] - x[2];
  const S e3 = p.goal[3] - x[3];
  return p.ks * p.ks * (e0 * e0 + e1 * e1) + p.kd * p.kd * (e2 * e2 + e3 * e3)
         + p.kr * p.kr * u * u;
}

template <class S>
__device__ __forceinline__ S final_cost(const Params& p, const S x[N]) {
  const S e0 = p.goal[0] - x[0];
  const S e1 = p.goal[1] - x[1];
  const S e2 = p.goal[2] - x[2];
  const S e3 = p.goal[3] - x[3];
  return p.kfs * p.kfs * (e0 * e0 + e1 * e1)
         + p.kfd * p.kfd * (e2 * e2 + e3 * e3);
}

// Continuous-time Jacobians A = ∂f/∂x, Bu = ∂f/∂u (jac_soa). Entries that
// Model::a_kind/b_kind mark structural zeros are left unset: callers never
// read them.
__device__ __forceinline__ void jac(const Params& p, const float x[N], float u,
                                    float A[N][N], float Bu[N]) {
  const float qd1 = x[2], qd2 = x[3];
  float s1, c1, s2, c2;
  sincosf(x[0], &s1, &c1);
  sincosf(x[1], &s2, &c2);
  const float s12 = s1 * c2 + c1 * s2;
  const float c12 = c1 * c2 - s1 * s2;

  const float kk = p.m2 * p.l1 * p.lc2;
  const float kkc2 = kk * c2;
  const float h11 = p.i1 + p.i2 + p.m2 * p.l1 * p.l1 + 2.0f * kkc2;
  const float h12 = p.i2 + kkc2;
  const float h22 = p.i2;
  const float rdet = 1.0f / (h11 * h22 - h12 * h12);
  const float kks2 = kk * s2;

  const float c11 = -2.0f * kks2 * qd2;
  const float c12_ = -p.m2 * p.l2 * p.lc2 * s2 * qd2;
  const float c21 = kks2 * qd1;

  const float gBs12 = p.m2 * p.g * p.lc2 * s12;
  const float g1 = (p.m1 * p.g * p.lc1 + p.m2 * p.g * p.l1) * s1 + gBs12;
  const float g2 = gBs12;

  const float b1 = -(c11 * qd1 + c12_ * qd2) - g1;
  const float b2 = u - c21 * qd1 - g2;
  const float qdd1 = (h22 * b1 - h12 * b2) * rdet;
  const float qdd2 = (h11 * b2 - h12 * b1) * rdet;

  // msolve(r1, r2) = ((h22 r1 - h12 r2) rdet, (h11 r2 - h12 r1) rdet)
  const float db1_q1 =
      -(p.m1 * p.g * p.lc1 * c1 + p.m2 * p.g * (p.l1 * c1 + p.lc2 * c12));
  const float db2_q1 = -p.m2 * p.g * p.lc2 * c12;
  A[2][0] = (h22 * db1_q1 - h12 * db2_q1) * rdet;
  A[3][0] = (h11 * db2_q1 - h12 * db1_q1) * rdet;

  const float db1_q2 = 2.0f * kk * c2 * qd2 * qd1
                       + p.m2 * p.l2 * p.lc2 * c2 * qd2 * qd2
                       - p.m2 * p.g * p.lc2 * c12;
  const float db2_q2 = -kk * c2 * qd1 * qd1 - p.m2 * p.g * p.lc2 * c12;
  const float dm_qdd1 = -2.0f * kks2 * qdd1 - kks2 * qdd2;
  const float dm_qdd2 = -kks2 * qdd1;
  const float r1 = db1_q2 - dm_qdd1;
  const float r2 = db2_q2 - dm_qdd2;
  A[2][1] = (h22 * r1 - h12 * r2) * rdet;
  A[3][1] = (h11 * r2 - h12 * r1) * rdet;

  const float e1 = -c11;
  const float e2 = -2.0f * c21;
  A[2][2] = (h22 * e1 - h12 * e2) * rdet;
  A[3][2] = (h11 * e2 - h12 * e1) * rdet;

  const float db1_qd2 =
      2.0f * kks2 * qd1 + 2.0f * p.m2 * p.l2 * p.lc2 * s2 * qd2;
  A[2][3] = h22 * db1_qd2 * rdet;
  A[3][3] = -h12 * db1_qd2 * rdet;

  // the two structural ones
  A[0][2] = 1.0f;
  A[1][3] = 1.0f;
  Bu[2] = -h12 * rdet;
  Bu[3] = h11 * rdet;
}

// Running-cost derivatives (cost_derivs_soa): cx, cu, diag(cxx), cuu.
__device__ __forceinline__ void cost_derivs(const Params& p, const float x[N],
                                            float u, float cx[N], float* cu,
                                            float cxx_diag[N], float* cuu) {
  const float w[N] = {p.ks * p.ks, p.ks * p.ks, p.kd * p.kd, p.kd * p.kd};
  for (int i = 0; i < N; ++i) {
    cx[i] = -2.0f * w[i] * (p.goal[i] - x[i]);
    cxx_diag[i] = 2.0f * w[i];
  }
  *cu = 2.0f * p.kr * p.kr * u;
  *cuu = 2.0f * p.kr * p.kr;
}

// Final-cost derivatives (final_cost_derivs_soa): cx and diag(cxx).
__device__ __forceinline__ void final_cost_derivs(const Params& p,
                                                  const float x[N], float cx[N],
                                                  float cxx_diag[N]) {
  const float w[N] = {p.kfs * p.kfs, p.kfs * p.kfs, p.kfd * p.kfd,
                      p.kfd * p.kfd};
  for (int i = 0; i < N; ++i) {
    cx[i] = -2.0f * w[i] * (p.goal[i] - x[i]);
    cxx_diag[i] = 2.0f * w[i];
  }
}

// The model as the fused kernels take it (sweep_step.cuh, rollout_step.cuh,
// kernels.cuh): the functions above with the control as an array;
// dynamics, cost and final_cost stay templates on the scalar.
struct Model : cost::DiagonalHessians {
  static constexpr int N = acrobot::N, M = acrobot::M;
  using Params = acrobot::Params;
  // The whole iteration runs as a team of 16 threads per lane
  // (iteration_team.cuh): its 5 directions and 15 cost-Hessian pairs fit a
  // team
  static constexpr bool kTeamIteration = true;

  // Structural pattern of jac(), row by row: '.' a Python-float zero of
  // jac_soa, '1' a Python-float one, 'x' a live entry
  // (tests/test_torch_models.py holds it against the JAX package's jac_soa).
  // The sweep skips the constant terms exactly as ops/kernel_sweep.py's
  // _fmul/_fadd fold them. The running cost's Hessian patterns are
  // DiagonalHessians' (cost_pattern.cuh); the final cost's cxx is diagonal.
  __host__ __device__ static constexpr char a_kind(int r, int i) {
    return "..1."
           "...1"
           "xxxx"
           "xxxx"[r * N + i];
  }
  __host__ __device__ static constexpr char b_kind(int r, int j) {
    return "."
           "."
           "x"
           "x"[r * M + j];
  }

  __device__ __forceinline__ static Params load(const float* __restrict__ p) {
    return load_params(p);
  }
  __device__ __forceinline__ static float u_lo(const Params& p, int) {
    return p.u_min;
  }
  __device__ __forceinline__ static float u_hi(const Params& p, int) {
    return p.u_max;
  }
  template <class S>
  __device__ __forceinline__ static void dynamics(const Params& p,
                                                  const S x[N], const S u[M],
                                                  S dx[N]) {
    acrobot::dynamics(p, x, u[0], dx);
  }
  template <class S>
  __device__ __forceinline__ static S cost(const Params& p, const S x[N],
                                           const S u[M]) {
    return acrobot::cost(p, x, u[0]);
  }
  template <class S>
  __device__ __forceinline__ static S final_cost(const Params& p,
                                                 const S x[N]) {
    return acrobot::final_cost(p, x);
  }
  __device__ __forceinline__ static void jac(const Params& p,
                                             const float x[N],
                                             const float u[M],
                                             float A[N][N], float Bu[N][M]) {
    float b[N];
    acrobot::jac(p, x, u[0], A, b);
    Bu[2][0] = b[2];
    Bu[3][0] = b[3];
  }
  __device__ __forceinline__ static void cost_derivs(
      const Params& p, const float x[N], const float u[M], float cx[N],
      float cu[M], float cxx[N][N], float /*cxu*/[N][M],
      float cuu[M][M]) {
    float cxx_diag[N];
    acrobot::cost_derivs(p, x, u[0], cx, &cu[0], cxx_diag, &cuu[0][0]);
#pragma unroll
    for (int i = 0; i < N; ++i) cxx[i][i] = cxx_diag[i];
  }
  __device__ __forceinline__ static void final_cost_derivs(
      const Params& p, const float x[N], float cx[N], float cxx[N]) {
    acrobot::final_cost_derivs(p, x, cx, cxx);
  }
};

}  // namespace acrobot
