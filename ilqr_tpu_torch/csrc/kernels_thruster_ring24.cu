// The fused solver's four kernels instantiated for thruster_ring24
// (n = 6, m = 24). See kernels.cuh.
#include "thruster_ring.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(thruster_ring24, thruster_ring::Model<24>)
