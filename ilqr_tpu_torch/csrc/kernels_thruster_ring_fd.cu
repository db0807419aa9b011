// The fused solver's stencil sweep and whole-iteration kernels
// (deriv_mode="fd", Euler or RK4) instantiated for thruster_ring
// (n = 6, m = 12). See kernels.cuh.
#include "thruster_ring.cuh"
#include "kernels.cuh"

ILQR_FD_LAUNCHERS(thruster_ring, thruster_ring::Model<12>)
