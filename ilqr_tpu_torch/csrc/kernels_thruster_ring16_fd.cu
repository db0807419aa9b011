// The fused solver's stencil sweep and whole-iteration kernels
// (deriv_mode="fd", Euler or RK4) instantiated for thruster_ring16
// (n = 6, m = 16). See kernels.cuh.
#include "thruster_ring.cuh"
#include "kernels.cuh"

ILQR_FD_LAUNCHERS(thruster_ring16, thruster_ring::Model<16>)
