// The fused solver's stencil sweep kernels (deriv_mode="fd", Euler or RK4)
// instantiated for the quadrotor (n = 12, m = 4); its stencil iteration
// kernels compile in kernels_quadrotor_iteration_fd.cu, in parallel, as
// each kernel that holds the 81-candidate QP takes nvcc minutes. See
// kernels.cuh.
#include "quadrotor.cuh"
#include "kernels.cuh"

ILQR_FD_SWEEP_LAUNCHER(quadrotor, quadrotor::Model)
