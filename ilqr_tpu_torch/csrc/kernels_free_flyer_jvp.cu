// The fused solver's dual-number sweep and whole-iteration kernels
// (deriv_mode="analytic" with RK4: exact derivatives of the step)
// instantiated for free_flyer (n = 6, m = 8). See kernels.cuh.
#include "free_flyer.cuh"
#include "kernels.cuh"

ILQR_JVP_LAUNCHERS(free_flyer, free_flyer::Model)
