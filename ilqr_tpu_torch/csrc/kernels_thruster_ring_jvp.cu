// The fused solver's dual-number sweep and whole-iteration kernels
// (deriv_mode="analytic" with RK4: exact derivatives of the step)
// instantiated for thruster_ring (n = 6, m = 12). See kernels.cuh.
#include "thruster_ring.cuh"
#include "kernels.cuh"

ILQR_JVP_LAUNCHERS(thruster_ring, thruster_ring::Model<12>)
