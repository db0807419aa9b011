// The fused solver's dual-number whole-iteration kernels
// (deriv_mode="analytic" with RK4: exact derivatives of the step)
// instantiated for the quadrotor (n = 12, m = 4); its dual-number sweep
// kernels are in kernels_quadrotor_jvp.cu. See kernels.cuh.
#include "quadrotor.cuh"
#include "kernels.cuh"

ILQR_JVP_ITERATION_LAUNCHER(quadrotor, quadrotor::Model)
