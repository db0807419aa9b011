// The fused solver's four kernels instantiated for the quadrotor
// (n = 12, m = 4). See kernels.cuh.
#include "quadrotor.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(quadrotor, quadrotor::Model)
