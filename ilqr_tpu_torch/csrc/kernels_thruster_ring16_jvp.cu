// The fused solver's dual-number sweep and whole-iteration kernels
// (deriv_mode="analytic" with RK4: exact derivatives of the step)
// instantiated for thruster_ring16 (n = 6, m = 16). See kernels.cuh.
#include "thruster_ring.cuh"
#include "kernels.cuh"

ILQR_JVP_LAUNCHERS(thruster_ring16, thruster_ring::Model<16>)
