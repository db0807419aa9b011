// The fused solver's four kernels instantiated for free_flyer
// (n = 6, m = 8). See kernels.cuh.
#include "free_flyer.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(free_flyer, free_flyer::Model)
