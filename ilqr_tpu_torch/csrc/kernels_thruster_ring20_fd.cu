// The fused solver's stencil sweep and whole-iteration kernels
// (deriv_mode="fd", Euler or RK4) instantiated for thruster_ring20
// (n = 6, m = 20). See kernels.cuh.
#include "thruster_ring.cuh"
#include "kernels.cuh"

ILQR_FD_LAUNCHERS(thruster_ring20, thruster_ring::Model<20>)
