// The fused solver's stencil sweep and whole-iteration kernels
// (deriv_mode="fd", Euler or RK4) instantiated for bicycle
// (n = 4, m = 2). See kernels.cuh.
#include "bicycle.cuh"
#include "kernels.cuh"

ILQR_FD_LAUNCHERS(bicycle, bicycle::Model)
