// One step of the merged linearize + backward sweep for m = 1, per lane
// (counterpart of ilqr_tpu/ops/pallas_sweep.py _sweep_step with the
// analytic model derivatives, use_limits=True, _qp_m1 and the m = 1 branch
// of _free_solve_rows; ref src/ilqr_core.cpp:350-401).
//
// The V-carry (Vx, Vxx), dV, the divergence latch and the gnorm sum live in
// registers of the calling thread. Sums run in the JAX accumulation order;
// terms whose fx/fu/cxx/cxu factor is a structural zero of the model are
// skipped, as the JAX package's trace-time constant folding drops them.
#pragma once

#include "acrobot.cuh"

namespace sweep {

using Model = acrobot::Params;
constexpr int N = acrobot::N;

// jnp.maximum / jnp.minimum: a NaN in either operand propagates
// (fmaxf/fminf would drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
// jnp.clip(v, lo, hi) = minimum(maximum(v, lo), hi)
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return nan_min(nan_max(v, lo), hi);
}

struct Carry {
  float vx[N];
  float vxx[N][N];
  float dv0, dv1;   // expected-reduction coefficients
  float div;        // latched divergence flag, f32 0/1
  float gacc;       // Σ_t |k_t| / (|u_t| + 1)
};

// V_T from the final cost at the terminal state; zeroed accumulators
// (pallas_sweep._terminal_init, analytic branch).
__device__ __forceinline__ void terminal_init(const Model& p, const float xT[N],
                                              Carry& c) {
  float cxx_diag[N];
  acrobot::final_cost_derivs(p, xT, c.vx, cxx_diag);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) c.vxx[i][j] = (i == j) ? cxx_diag[i] : 0.0f;
  c.dv0 = 0.0f;
  c.dv1 = 0.0f;
  c.div = 0.0f;
  c.gacc = 0.0f;
}

__device__ __forceinline__ bool fx_nz(int r, int i) {
  return acrobot::a_nz(r, i) || r == i;
}

// One backward step at (x_t, u_t) with regularization lam. Writes the
// feedforward k and the feedback row Krow, and advances the carry.
__device__ __forceinline__ void step(const Model& p, const float x[N], float u,
                                     float lam, Carry& c, float* k_out,
                                     float Krow[N]) {
  // --- linearization: fx = I + dt·A, fu = dt·B (Euler), cost derivatives
  float A[N][N], Bu[N];
  acrobot::jac(p, x, u, A, Bu);
  float fx[N][N], fu[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (acrobot::a_nz(r, i))
        fx[r][i] = (r == i) ? p.dt * A[r][i] + 1.0f : p.dt * A[r][i];
      else
        fx[r][i] = (r == i) ? 1.0f : 0.0f;
    }
    fu[r] = acrobot::b_nz(r) ? p.dt * Bu[r] : 0.0f;
  }
  float cx[N], cxx_diag[N], cu, cuu;
  acrobot::cost_derivs(p, x, u, cx, &cu, cxx_diag, &cuu);

  // --- Q-terms (ref ilqr_core.cpp:359-363)
  float fvv[N];  // fuᵀ Vxx
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (acrobot::b_nz(i)) acc = acc + fu[i] * c.vxx[i][j];
    fvv[j] = acc;
  }
  float qu = cu;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (acrobot::b_nz(i)) qu = qu + fu[i] * c.vx[i];
  float quu = cuu;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (acrobot::b_nz(i)) quu = quu + fvv[i] * fu[i];
  const float quuF = quu + lam;

  float qx[N], qux[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float ax = cx[j];
    float aq = 0.0f;  // cxu is structurally zero
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (fx_nz(i, j)) {
        ax = ax + fx[i][j] * c.vx[i];
        aq = aq + fvv[i] * fx[i][j];
      }
    }
    qx[j] = ax;
    qux[j] = aq;
  }
  float w[N][N];  // Vxx fx
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int l = 0; l < N; ++l)
        if (fx_nz(l, j)) acc = acc + c.vxx[kk][l] * fx[l][j];
      w[kk][j] = acc;
    }
  float qxx[N][N];  // cxx + fxᵀ Vxx fx, upper triangle mirrored
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) {
      float acc = (i == j) ? cxx_diag[i] : 0.0f;  // cxx is diagonal
#pragma unroll
      for (int kk = 0; kk < N; ++kk)
        if (fx_nz(kk, i)) acc = acc + fx[kk][i] * w[kk][j];
      qxx[i][j] = acc;
      qxx[j][i] = acc;
    }

  // --- m = 1 box QP in closed form (pallas_sweep._qp_m1); a NaN quuF is
  // not "bad", exactly as the JAX comparison q11 <= 0 reads it.
  const float lo = p.u_min - u;
  const float hi = p.u_max - u;
  const bool bad = quuF <= 0.0f;
  const float q_safe = bad ? 1.0f : quuF;
  const float rq = 1.0f / q_safe;  // one IEEE reciprocal, shared below
  const float x1 = clip(-qu * rq, lo, hi);
  const float gk = quuF * x1 + qu;
  const bool clamped = (x1 <= lo && gk > 0.0f) || (x1 >= hi && gk < 0.0f);
  const float k = bad ? 0.0f : x1;
  const bool is_free = !clamped && !bad;
  // feedback rows: −Qux/QuuF on the free dim, zero when clamped
  // (_free_solve_rows, m = 1; ref :377-385)
  const float nrq = -rq;
#pragma unroll
  for (int i = 0; i < N; ++i) Krow[i] = is_free ? qux[i] * nrq : 0.0f;

  // --- divergence latch, dV, value update (ref :386-393)
  c.div = fmaxf(c.div, bad ? 1.0f : 0.0f);
  c.dv0 = c.dv0 + k * qu;
  c.dv1 = c.dv1 + 0.5f * k * quu * k;
  const float quu_k = quu * k;
  float vx_new[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    vx_new[i] = qx[i] + Krow[i] * quu_k + Krow[i] * qu + qux[i] * k;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    c.vx[i] = vx_new[i];
#pragma unroll
    for (int j = i; j < N; ++j) {
      const float v = qxx[i][j] + Krow[i] * quu * Krow[j] + Krow[i] * qux[j]
                      + qux[i] * Krow[j];
      c.vxx[i][j] = v;
      c.vxx[j][i] = v;
    }
  }

  // gradient-norm epilogue (ref :153-159): the mean over t is taken once
  // the sweep ends
  c.gacc = c.gacc + fabsf(k) / (fabsf(u) + 1.0f);
  *k_out = k;
}

}  // namespace sweep
