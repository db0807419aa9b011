// The fused solver's four kernels instantiated for thruster_ring16
// (n = 6, m = 16). See kernels.cuh.
#include "thruster_ring.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(thruster_ring16, thruster_ring::Model<16>)
