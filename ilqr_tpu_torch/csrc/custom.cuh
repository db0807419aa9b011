// What a generated custom-model header (ops/codegen.py) needs beside
// dual.cuh: the dense structural patterns, PyTorch's c / x, and a
// params-only value as the scalar S.
#pragma once

#include "dual.cuh"

namespace custom {

// Every entry of the Jacobians and cost Hessians live: a custom model runs
// the dense derivative policies only (sweep_step.cuh FiniteDiff and Jvp,
// which fold nothing), so no entry is structurally constant.
struct DensePattern {
  // the merged sweep, the whole iteration and the line search stay the
  // one-thread kernels (sweep_team.cuh TeamSweep, iteration_warp.cuh,
  // linesearch_team.cuh TeamLineSearch; no kTeamIteration): the team
  // kernels are held against their plain versions for the package's models
  // only
  static constexpr bool kTeamSweep = false;
  static constexpr bool kTeamLineSearch = false;
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
