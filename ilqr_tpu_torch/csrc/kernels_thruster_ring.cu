// The fused solver's four kernels instantiated for thruster_ring
// (n = 6, m = 12). See kernels.cuh.
#include "thruster_ring.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(thruster_ring, thruster_ring::Model<12>)
