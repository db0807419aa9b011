// The fused solver's four kernels instantiated for thruster_ring20
// (n = 6, m = 20). See kernels.cuh.
#include "thruster_ring.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(thruster_ring20, thruster_ring::Model<20>)
