// The fused solver's four kernels instantiated for acrobot (n = 4, m = 1),
// with the library's shared entry points. See kernels.cuh; the whole
// iteration is the team kernel of iteration_team.cuh (Model::kTeamIteration).
#include <cuda_runtime.h>

#include "acrobot.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(acrobot, acrobot::Model)

extern "C" {

int ilqr_max_alphas() { return fused::kMaxA; }

const char* ilqr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
