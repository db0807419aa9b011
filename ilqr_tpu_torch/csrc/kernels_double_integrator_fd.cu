// The fused solver's stencil sweep and whole-iteration kernels
// (deriv_mode="fd", Euler or RK4) instantiated for double_integrator
// (n = 4, m = 2). See kernels.cuh.
#include "double_integrator.cuh"
#include "kernels.cuh"

ILQR_FD_LAUNCHERS(double_integrator, double_integrator::Model)
