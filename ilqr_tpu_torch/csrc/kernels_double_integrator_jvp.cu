// The fused solver's dual-number sweep and whole-iteration kernels
// (deriv_mode="analytic" with RK4: exact derivatives of the step)
// instantiated for double_integrator (n = 4, m = 2). See kernels.cuh.
#include "double_integrator.cuh"
#include "kernels.cuh"

ILQR_JVP_LAUNCHERS(double_integrator, double_integrator::Model)
