// The fused solver's whole-iteration kernels instantiated for the quadrotor
// (n = 12, m = 4); the other three are in kernels_quadrotor.cu. See
// kernels.cuh.
#include "quadrotor.cuh"
#include "kernels.cuh"

ILQR_ITERATION_LAUNCHER(quadrotor, quadrotor::Model)
