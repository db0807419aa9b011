// The fused solver's rollout, sweep and line-search kernels instantiated for
// the quadrotor (n = 12, m = 4); its iteration kernels compile in
// kernels_quadrotor_iteration.cu, in parallel, as each kernel that holds the
// 81-candidate QP takes nvcc minutes. See kernels.cuh.
#include "quadrotor.cuh"
#include "kernels.cuh"

ILQR_SPLIT_LAUNCHERS(quadrotor, quadrotor::Model)
