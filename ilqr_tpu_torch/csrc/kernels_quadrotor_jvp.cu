// The fused solver's dual-number sweep kernels (deriv_mode="analytic" with
// RK4: exact derivatives of the step) instantiated for the quadrotor
// (n = 12, m = 4); its dual-number iteration kernels compile in
// kernels_quadrotor_iteration_jvp.cu, in parallel, as each kernel that
// holds the 81-candidate QP takes nvcc minutes. See kernels.cuh.
#include "quadrotor.cuh"
#include "kernels.cuh"

ILQR_JVP_SWEEP_LAUNCHER(quadrotor, quadrotor::Model)
