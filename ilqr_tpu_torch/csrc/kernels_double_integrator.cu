// The fused solver's four kernels instantiated for the 2D double integrator
// (n = 4, m = 2). See kernels.cuh.
#include "double_integrator.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(double_integrator, double_integrator::Model)
