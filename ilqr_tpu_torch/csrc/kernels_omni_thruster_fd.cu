// The fused solver's stencil sweep and whole-iteration kernels
// (deriv_mode="fd", Euler or RK4) instantiated for omni_thruster
// (n = 6, m = 6). See kernels.cuh.
#include "omni_thruster.cuh"
#include "kernels.cuh"

ILQR_FD_LAUNCHERS(omni_thruster, omni_thruster::Model)
