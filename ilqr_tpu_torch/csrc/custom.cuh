// What a generated custom-model header (ops/codegen.py) needs beside
// dual.cuh: the dense structural patterns, PyTorch's c / x, and a
// params-only value as the scalar S.
#pragma once

#include "dual.cuh"

namespace custom {

// Whether a custom model's whole iteration (and with it its split sweep in
// the dense forms, sweep_team.cuh kSweepKind) is the team of
// iteration_team.cuh: where m·n < 32 and a warp holds the stencil's
// 2(n + m) sides and the m(n + 1) gain entries of a step one a thread, as
// for the package's team models; team::kTeamWidth then takes 16 or 32
// threads a lane. Outside the rule (m = 1 with n ≥ 16, m = 3 with n = 10,
// and every m·n ≥ 32) a custom model keeps the one-thread iteration_kernel
// and sweep_kernel of kernels.cuh. The line search is the team of
// linesearch_team.cuh for every model.
__host__ __device__ constexpr bool team_iteration(int n, int m) {
  return m * n < 32 && 2 * (n + m) <= 32 && m * (n + 1) <= 32;
}

// Every entry of the Jacobians and cost Hessians live: a custom model runs
// the dense derivative policies only (sweep_step.cuh FiniteDiff and Jvp,
// which fold nothing), so no entry is structurally constant.
struct DensePattern {
  // the warp per lane of the m·n ≥ 32 models (sweep_team.cuh TeamSweep,
  // iteration_warp.cuh) is not taken: such a custom model keeps the
  // one-thread sweep and iteration
  static constexpr bool kTeamSweep = false;
  __host__ __device__ static constexpr char a_kind(int, int) { return 'x'; }
  __host__ __device__ static constexpr char b_kind(int, int) { return 'x'; }
  __host__ __device__ static constexpr char cxx_kind(int, int) { return 'x'; }
  __host__ __device__ static constexpr char cxu_kind(int, int) { return 'x'; }
  __host__ __device__ static constexpr char cuu_kind(int, int) { return 'x'; }
};

// c / x for a Python constant c, as PyTorch computes it
// (Tensor.__rtruediv__: reciprocal(x) · c); on dual numbers the plain
// Dual's rule, (c / x.v, ((−x.d) · c) · (1 / (x.v · x.v))), with each
// division by x again this one
__device__ __forceinline__ float rdiv(float c, float x) {
  return (1.0f / x) * c;
}
template <class T>
__device__ __forceinline__ dual::Dual<T> rdiv(float c,
                                              const dual::Dual<T>& x) {
  return {rdiv(c, x.v), ((-x.d) * c) * rdiv(1.0f, x.v * x.v)};
}

// a value of params and constants only as the scalar S: a dual number's
// derivative parts are zero
__device__ __forceinline__ void lift_to(float v, float& out) { out = v; }
template <class T>
__device__ __forceinline__ void lift_to(float v, dual::Dual<T>& out) {
  lift_to(v, out.v);
  lift_to(0.0f, out.d);
}
template <class S>
__device__ __forceinline__ S lift(float v) {
  S s;
  lift_to(v, s);
  return s;
}

}  // namespace custom
