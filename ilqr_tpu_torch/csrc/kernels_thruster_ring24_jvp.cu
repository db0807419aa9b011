// The fused solver's dual-number sweep and whole-iteration kernels
// (deriv_mode="analytic" with RK4: exact derivatives of the step)
// instantiated for thruster_ring24 (n = 6, m = 24). See kernels.cuh.
#include "thruster_ring.cuh"
#include "kernels.cuh"

ILQR_JVP_LAUNCHERS(thruster_ring24, thruster_ring::Model<24>)
