// One step of the merged linearize + backward sweep, per lane, for a model
// given as a traits struct (acrobot.cuh Model): counterpart of
// ilqr_tpu/ops/pallas_sweep.py _sweep_step and _terminal_init; ref
// src/ilqr_core.cpp:350-401. The QP is qp.cuh's: the box QP with control
// limits, the Newton step without.
//
// Where the derivatives come from is a template policy:
//  - Analytic: the model's jac/cost_derivs/final_cost_derivs with the Euler
//    step's fx = I + dt·A, fu = dt·B (the JAX kernel's use_analytic
//    branch). Terms with a structurally constant fx/fu/cxx/cxu/cuu factor
//    are folded exactly as the JAX package's trace-time constant folding
//    folds them (a product with a structural one is its other factor, a
//    term with a structural zero is dropped, and a sum that starts at a
//    structural zero starts at its first live term). The running cost's
//    Hessians fold by the model's cxx_kind/cxu_kind/cuu_kind patterns
//    (cost_pattern.cuh) as the JAX trace folds its Python-float zeros: Qxx
//    starts at a live cxx[i][j], Qux at a live cxu[jn][jm], Quu at a live
//    cuu[im][jm], and each otherwise at its first live term. The final
//    cost's cxx is diagonal for every model.
//  - FiniteDiff: the reference's central stencils of the discrete step
//    (Euler or RK4) and of the costs (fd.cuh; the JAX kernel's "fd" mode).
//    Every entry is a traced value there, so nothing folds: every sum
//    starts at its first term, Qxx/Qux/Quu at the dense cost Hessians, and
//    V_T's Hessian is dense.
//  - Jvp: exact forward-mode derivatives of the discrete step (Euler or
//    RK4) and of the costs with dual numbers (jvp.cuh; the JAX kernel's
//    "jvp" mode where use_analytic is false). Dense as FiniteDiff: the two
//    share every line of the step and of terminal_init and differ only in
//    where the numbers come from.
//
// The V-carry (Vx, Vxx), dV, the divergence latch and the gnorm sum live in
// registers of the calling thread (local memory for the large models).
// Sums run in the JAX accumulation order.
#pragma once

#include "cost_pattern.cuh"
#include "fd.cuh"
#include "jnp.cuh"
#include "jvp.cuh"
#include "qp.cuh"

namespace sweep {

template <class Model>
struct Carry {
  float vx[Model::N];
  float vxx[Model::N][Model::N];
  float dv0, dv1;   // expected-reduction coefficients
  float div;        // latched divergence flag, f32 0/1
  float gacc;       // Σ_t max_j |k_j| / (|u_j| + 1)
};

// The derivative sources of the step (see the top of this file)
struct Analytic {
  static constexpr bool kDense = false;
  // A = ∂f/∂x, Bu = ∂f/∂u at (x, u): the model's closed forms
  template <class Model>
  __device__ __forceinline__ void jac(const typename Model::Params& p,
                                      const float x[Model::N],
                                      const float u[Model::M],
                                      float A[Model::N][Model::N],
                                      float Bu[Model::N][Model::M]) const {
    Model::jac(p, x, u, A, Bu);
  }
};
struct FiniteDiff {
  static constexpr bool kDense = true;
  fd::Stencil s;
  template <class Model>
  __device__ __forceinline__ void linearize(
      const typename Model::Params& p, const float x[Model::N],
      const float u[Model::M], float fx[Model::N][Model::N],
      float fu[Model::N][Model::M], float cx[Model::N], float cu[Model::M],
      float cxx[Model::N][Model::N], float cxu[Model::N][Model::M],
      float cuu[Model::M][Model::M]) const {
    fd::linearize<Model>(p, x, u, s, fx, fu, cx, cu, cxx, cxu, cuu);
  }
  template <class Model>
  __device__ __forceinline__ void terminal(
      const typename Model::Params& p, const float xT[Model::N],
      float vx[Model::N], float vxx[Model::N][Model::N]) const {
    fd::terminal<Model>(p, xT, s, vx, vxx);
  }
  // the units of linearize and terminal one at a time (derivs.cuh): a
  // direction of (x, u), a pair of the running (or final) cost's Hessian,
  // a direction of the final cost's gradient
  template <class Model>
  __device__ __forceinline__ float direction(const typename Model::Params& p,
                                             const float x[Model::N],
                                             const float u[Model::M], int a,
                                             float col[Model::N]) const {
    return fd::direction<Model>(p, x, u, a, s, col);
  }
  template <class Model, bool kRunning>
  __device__ __forceinline__ float second(const typename Model::Params& p,
                                          const float x[Model::N],
                                          const float u[Model::M], int a,
                                          int b) const {
    return fd::second<Model, kRunning>(p, x, u, a, b, s);
  }
  template <class Model>
  __device__ __forceinline__ float final_direction(
      const typename Model::Params& p, const float xT[Model::N],
      int a) const {
    return fd::final_direction<Model>(p, xT, a, s);
  }
};
struct Jvp {
  static constexpr bool kDense = true;
  int scheme;  // the step differentiated: integrate::kEuler or kRK4
  template <class Model>
  __device__ __forceinline__ void linearize(
      const typename Model::Params& p, const float x[Model::N],
      const float u[Model::M], float fx[Model::N][Model::N],
      float fu[Model::N][Model::M], float cx[Model::N], float cu[Model::M],
      float cxx[Model::N][Model::N], float cxu[Model::N][Model::M],
      float cuu[Model::M][Model::M]) const {
    jvp::linearize<Model>(p, x, u, scheme, fx, fu, cx, cu, cxx, cxu, cuu);
  }
  template <class Model>
  __device__ __forceinline__ void terminal(
      const typename Model::Params& p, const float xT[Model::N],
      float vx[Model::N], float vxx[Model::N][Model::N]) const {
    jvp::terminal<Model>(p, xT, vx, vxx);
  }
  // the units of linearize and terminal one at a time (as FiniteDiff's)
  template <class Model>
  __device__ __forceinline__ float direction(const typename Model::Params& p,
                                             const float x[Model::N],
                                             const float u[Model::M], int a,
                                             float col[Model::N]) const {
    return jvp::direction<Model>(p, x, u, a, scheme, col);
  }
  template <class Model, bool kRunning>
  __device__ __forceinline__ float second(const typename Model::Params& p,
                                          const float x[Model::N],
                                          const float u[Model::M], int a,
                                          int b) const {
    return jvp::second<Model, kRunning>(p, x, u, a, b);
  }
  template <class Model>
  __device__ __forceinline__ float final_direction(
      const typename Model::Params& p, const float xT[Model::N],
      int a) const {
    return jvp::final_direction<Model>(p, xT, a);
  }
};

// Structural kinds of the step's factors under a policy: '.' zero, '1'
// one, 'x' live. Under the dense policies every entry is live.
template <class Model, class Deriv>
struct Kinds {
  // fx = I + dt·A under Analytic
  __host__ __device__ static constexpr char fx(int r, int i) {
    if constexpr (Deriv::kDense) return 'x';
    return Model::a_kind(r, i) == '.' ? (r == i ? '1' : '.') : 'x';
  }
  // fu = dt·B; a structural one of B gives the live dt
  __host__ __device__ static constexpr char fu(int r, int j) {
    if constexpr (Deriv::kDense) return 'x';
    return Model::b_kind(r, j);
  }
  __host__ __device__ static constexpr char cxx(int i, int j) {
    if constexpr (Deriv::kDense) return 'x';
    return Model::cxx_kind(i, j);
  }
  __host__ __device__ static constexpr char cxu(int i, int j) {
    if constexpr (Deriv::kDense) return 'x';
    return Model::cxu_kind(i, j);
  }
  __host__ __device__ static constexpr char cuu(int i, int j) {
    if constexpr (Deriv::kDense) return 'x';
    return Model::cuu_kind(i, j);
  }
};

// V_T from the final cost at the terminal state; zeroed accumulators
// (pallas_sweep._terminal_init). Under Analytic every model's final cxx is
// diagonal (tests/test_torch_models.py checks it against the JAX package),
// so final_cost_derivs writes its diagonal only; under the dense policies
// the stencils or the dual numbers give a dense Hessian.
template <class Model, class Deriv>
__device__ __forceinline__ void terminal_init(
    const typename Model::Params& p, const float xT[Model::N],
    const Deriv& d, Carry<Model>& c) {
  constexpr int N = Model::N;
  if constexpr (Deriv::kDense) {
    d.template terminal<Model>(p, xT, c.vx, c.vxx);
  } else {
    float cxx_diag[N];
    Model::final_cost_derivs(p, xT, c.vx, cxx_diag);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j)
        c.vxx[i][j] = (i == j) ? cxx_diag[i] : 0.0f;
  }
  c.dv0 = 0.0f;
  c.dv1 = 0.0f;
  c.div = 0.0f;
  c.gacc = 0.0f;
}

// s ← s + t, where a sum still at its structural 0.0 becomes t (_fadd)
__device__ __forceinline__ void fold_add(float& s, bool& live, float t) {
  s = live ? s + t : t;
  live = true;
}

// One backward step at (x_t, u_t) with regularization lam. Writes the
// feedforward k and the feedback rows Krow, and advances the carry.
template <class Model, bool kLimits, class Deriv>
__device__ __forceinline__ void step(const typename Model::Params& p,
                                     const float x[Model::N],
                                     const float u[Model::M], float lam,
                                     const Deriv& d, Carry<Model>& c,
                                     float k[Model::M],
                                     float Krow[Model::M][Model::N]) {
  constexpr int N = Model::N, M = Model::M;
  using Kd = Kinds<Model, Deriv>;
  // Loops over the controls unroll fully for m ≤ 4 and stay loops for
  // m ≥ 5, where unrolling them would emit O(n²m²) operations per step
  // (the unroll factor changes the code, not the order of its operations).
  constexpr int kUnrollM = M <= 4 ? 4 : 1;
  // The analytic cost patterns fold at compile time: over the state the
  // loops unroll, so each cxx_kind is a constant; over the controls they
  // unroll only for m ≤ 4, so a pattern with a live cxu or a non-diagonal
  // cuu needs m ≤ 4. The dense Hessians of FiniteDiff and Jvp (every kind
  // 'x') run at any m, with runtime indices into cxu and cuu.
  constexpr bool kDiagCuu = !Deriv::kDense && cost::diagonal_cuu<Model>();
  constexpr bool kZeroCxu = !Deriv::kDense && cost::zero_cxu<Model>();
  static_assert(kUnrollM > 1 || Deriv::kDense || (kDiagCuu && kZeroCxu),
                "a live cxu or a non-diagonal cuu pattern folds at compile "
                "time only where the control loops unroll (m <= 4)");
  // --- linearization
  float fx[N][N], fu[N][M];
  float cx[N], cu[M], cxx[N][N], cxu[N][M], cuu[M][M];
  if constexpr (Deriv::kDense) {
    d.template linearize<Model>(p, x, u, fx, fu, cx, cu, cxx, cxu, cuu);
  } else {
    // fx = I + dt·A, fu = dt·B (Euler), the cost's analytic derivatives
    float A[N][N], Bu[N][M];
    d.template jac<Model>(p, x, u, A, Bu);
#pragma unroll
    for (int r = 0; r < N; ++r) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const char ak = Model::a_kind(r, i);
        if (ak == 'x')
          fx[r][i] = (r == i) ? p.dt * A[r][i] + 1.0f : p.dt * A[r][i];
        else if (ak == '1')
          fx[r][i] = (r == i) ? p.dt + 1.0f : p.dt;
        else
          fx[r][i] = (r == i) ? 1.0f : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const char bk = Model::b_kind(r, j);  // a structural one gives dt
        fu[r][j] = bk == 'x' ? p.dt * Bu[r][j] : (bk == '1' ? p.dt : 0.0f);
      }
    }
    Model::cost_derivs(p, x, u, cx, cu, cxx, cxu, cuu);
  }
  // a diagonal cuu's diagonal, read at compile-time indices here so that
  // the runtime loops over the controls of m ≥ 5 index an M-vector only
  [[maybe_unused]] float cuu_d[M];
  if constexpr (kDiagCuu) {
#pragma unroll
    for (int j = 0; j < M; ++j) cuu_d[j] = cuu[j][j];
  }

  // --- Q-terms (ref ilqr_core.cpp:359-363)
  float fvv[M][N];  // fuᵀ Vxx
#pragma unroll(kUnrollM)
  for (int jm = 0; jm < M; ++jm)
#pragma unroll
    for (int jn = 0; jn < N; ++jn) {
      float acc = 0.0f;
      bool live = false;
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (Kd::fu(i, jm) != '.')
          fold_add(acc, live, fu[i][jm] * c.vxx[i][jn]);
      fvv[jm][jn] = acc;
    }
  float qu[M];
#pragma unroll(kUnrollM)
  for (int jm = 0; jm < M; ++jm) {
    float acc = cu[jm];
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (Kd::fu(i, jm) != '.') acc = acc + fu[i][jm] * c.vx[i];
    qu[jm] = acc;
  }
  float quu[M][M], quuF[M][M];
#pragma unroll(kUnrollM)
  for (int im = 0; im < M; ++im)
#pragma unroll(kUnrollM)
    for (int jm = im; jm < M; ++jm) {
      float acc = 0.0f;
      bool live = false;
      if constexpr (kDiagCuu) {
        live = im == jm;
        acc = live ? cuu_d[im] : 0.0f;
      } else if (Kd::cuu(im, jm) == 'x') {
        acc = cuu[im][jm];
        live = true;
      }
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (Kd::fu(i, jm) != '.')
          fold_add(acc, live, fvv[im][i] * fu[i][jm]);
      quu[im][jm] = acc;
      quu[jm][im] = acc;
      quuF[im][jm] = (im == jm) ? acc + lam : acc;
      quuF[jm][im] = quuF[im][jm];
    }

  float qx[N], qux[M][N];
#pragma unroll
  for (int jn = 0; jn < N; ++jn) {
    float ax = cx[jn];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const char fk = Kd::fx(i, jn);
      if (fk == '1') ax = ax + c.vx[i];
      if (fk == 'x') ax = ax + fx[i][jn] * c.vx[i];
    }
    qx[jn] = ax;
#pragma unroll(kUnrollM)
    for (int jm = 0; jm < M; ++jm) {
      float aq = 0.0f;
      bool live = false;
      if constexpr (!kZeroCxu) {
        if (Kd::cxu(jn, jm) == 'x') {
          aq = cxu[jn][jm];
          live = true;
        }
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const char fk = Kd::fx(i, jn);
        if (fk == '1') fold_add(aq, live, fvv[jm][i]);
        if (fk == 'x') fold_add(aq, live, fvv[jm][i] * fx[i][jn]);
      }
      qux[jm][jn] = aq;
    }
  }
  float w[N][N];  // Vxx fx
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = 0.0f;
      bool live = false;
#pragma unroll
      for (int l = 0; l < N; ++l) {
        const char fk = Kd::fx(l, j);
        if (fk == '1') fold_add(acc, live, c.vxx[kk][l]);
        if (fk == 'x') fold_add(acc, live, c.vxx[kk][l] * fx[l][j]);
      }
      w[kk][j] = acc;
    }
  float qxx[N][N];  // cxx + fxᵀ Vxx fx, upper triangle mirrored
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) {
      float acc = 0.0f;
      bool live = false;
      if (Kd::cxx(i, j) == 'x') {
        acc = cxx[i][j];
        live = true;
      }
#pragma unroll
      for (int kk = 0; kk < N; ++kk) {
        const char fk = Kd::fx(kk, i);
        if (fk == '1') fold_add(acc, live, w[kk][j]);
        if (fk == 'x') fold_add(acc, live, fx[kk][i] * w[kk][j]);
      }
      qxx[i][j] = acc;
      qxx[j][i] = acc;
    }

  // --- the QP and the feedback rows
  bool is_free[M], bad;
  if constexpr (kLimits) {
    float lo[M], hi[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      lo[j] = Model::u_lo(p, j) - u[j];
      hi[j] = Model::u_hi(p, j) - u[j];
    }
    qp::box<M>(quuF, qu, lo, hi, k, is_free, bad);
  } else {
    qp::newton<M>(quuF, qu, k, is_free, bad);
  }
  qp::free_rows<M, N>(quuF, is_free, qux, Krow);

  // --- divergence latch, dV, value update (ref :386-393)
  c.div = fmaxf(c.div, bad ? 1.0f : 0.0f);
  float d0 = k[0] * qu[0];
#pragma unroll(kUnrollM)
  for (int jm = 1; jm < M; ++jm) d0 = d0 + k[jm] * qu[jm];
  float d1 = 0.0f;
#pragma unroll(kUnrollM)
  for (int im = 0; im < M; ++im)
#pragma unroll(kUnrollM)
    for (int jm = 0; jm < M; ++jm) {
      const float t = 0.5f * k[im] * quu[im][jm] * k[jm];
      d1 = (im == 0 && jm == 0) ? t : d1 + t;
    }
  c.dv0 = c.dv0 + d0;
  c.dv1 = c.dv1 + d1;
  float quu_k[M];
#pragma unroll(kUnrollM)
  for (int im = 0; im < M; ++im) {
    float acc = quu[im][0] * k[0];
#pragma unroll(kUnrollM)
    for (int jm = 1; jm < M; ++jm) acc = acc + quu[im][jm] * k[jm];
    quu_k[im] = acc;
  }
  float vx_new[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = qx[i];
#pragma unroll(kUnrollM)
    for (int cm = 0; cm < M; ++cm)
      acc = acc + Krow[cm][i] * quu_k[cm] + Krow[cm][i] * qu[cm]
            + qux[cm][i] * k[cm];
    vx_new[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    c.vx[i] = vx_new[i];
#pragma unroll
    for (int j = i; j < N; ++j) {
      float acc = qxx[i][j];
#pragma unroll(kUnrollM)
      for (int cm = 0; cm < M; ++cm) {
#pragma unroll(kUnrollM)
        for (int d = 0; d < M; ++d)
          acc = acc + Krow[cm][i] * quu[cm][d] * Krow[d][j];
        acc = acc + Krow[cm][i] * qux[cm][j] + qux[cm][i] * Krow[cm][j];
      }
      c.vxx[i][j] = acc;
      c.vxx[j][i] = acc;
    }
  }

  // gradient-norm epilogue (ref :153-159): the mean over t is taken once
  // the sweep ends
  float gstep = fabsf(k[0]) / (fabsf(u[0]) + 1.0f);
#pragma unroll(kUnrollM)
  for (int jm = 1; jm < M; ++jm)
    gstep = jnp::maximum(gstep, fabsf(k[jm]) / (fabsf(u[jm]) + 1.0f));
  c.gacc = c.gacc + gstep;
}

}  // namespace sweep
