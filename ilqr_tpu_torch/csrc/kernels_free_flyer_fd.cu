// The fused solver's stencil sweep and whole-iteration kernels
// (deriv_mode="fd", Euler or RK4) instantiated for free_flyer
// (n = 6, m = 8). See kernels.cuh.
#include "free_flyer.cuh"
#include "kernels.cuh"

ILQR_FD_LAUNCHERS(free_flyer, free_flyer::Model)
