// Structural patterns of a model's running-cost Hessians, the counterpart
// of a_kind/b_kind for cost_derivs (see acrobot.cuh Model): cxx_kind(i, j),
// cxu_kind(i, jm) and cuu_kind(im, jm) give '.' where the model's
// cost_derivs_soa returns a Python-float zero and 'x' where it returns a
// live array (tests/test_torch_models.py holds them against the JAX
// package). The sweep (sweep_step.cuh) folds the structural zeros out at
// compile time and reads only the live entries of the full cxx[N][N],
// cxu[N][M] and cuu[M][M] that Model::cost_derivs writes.
//
// The final cost's cxx is diagonal for every model (final_cost_derivs
// writes its diagonal only); a model whose final cxx is not diagonal
// needs a final-cost pattern first.
#pragma once

namespace cost {

// Diagonal cxx and cuu with every diagonal entry live, cxu structurally
// zero: the running cost of every model but power_mass.
struct DiagonalHessians {
  __host__ __device__ static constexpr char cxx_kind(int i, int j) {
    return i == j ? 'x' : '.';
  }
  __host__ __device__ static constexpr char cxu_kind(int, int) { return '.'; }
  __host__ __device__ static constexpr char cuu_kind(int im, int jm) {
    return im == jm ? 'x' : '.';
  }
};

// Whether Model's cuu pattern is DiagonalHessians' (evaluated at compile
// time only)
template <class Model>
__host__ __device__ constexpr bool diagonal_cuu() {
  for (int i = 0; i < Model::M; ++i)
    for (int j = 0; j < Model::M; ++j)
      if (Model::cuu_kind(i, j) != (i == j ? 'x' : '.')) return false;
  return true;
}

// Whether Model's cxu is structurally zero (evaluated at compile time only)
template <class Model>
__host__ __device__ constexpr bool zero_cxu() {
  for (int i = 0; i < Model::N; ++i)
    for (int j = 0; j < Model::M; ++j)
      if (Model::cxu_kind(i, j) != '.') return false;
  return true;
}

}  // namespace cost
