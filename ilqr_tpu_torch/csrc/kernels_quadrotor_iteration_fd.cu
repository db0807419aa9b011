// The fused solver's stencil whole-iteration kernels (deriv_mode="fd",
// Euler or RK4) instantiated for the quadrotor (n = 12, m = 4); its stencil
// sweep kernels are in kernels_quadrotor_fd.cu. See kernels.cuh.
#include "quadrotor.cuh"
#include "kernels.cuh"

ILQR_FD_ITERATION_LAUNCHER(quadrotor, quadrotor::Model)
