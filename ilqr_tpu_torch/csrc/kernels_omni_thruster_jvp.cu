// The fused solver's dual-number sweep and whole-iteration kernels
// (deriv_mode="analytic" with RK4: exact derivatives of the step)
// instantiated for omni_thruster (n = 6, m = 6). See kernels.cuh.
#include "omni_thruster.cuh"
#include "kernels.cuh"

ILQR_JVP_LAUNCHERS(omni_thruster, omni_thruster::Model)
