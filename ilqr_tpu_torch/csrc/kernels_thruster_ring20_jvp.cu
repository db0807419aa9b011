// The fused solver's dual-number sweep and whole-iteration kernels
// (deriv_mode="analytic" with RK4: exact derivatives of the step)
// instantiated for thruster_ring20 (n = 6, m = 20). See kernels.cuh.
#include "thruster_ring.cuh"
#include "kernels.cuh"

ILQR_JVP_LAUNCHERS(thruster_ring20, thruster_ring::Model<20>)
