// The linearization kernel (derivs.cuh) instantiated for thruster_ring.
#include "thruster_ring.cuh"
#include "derivs.cuh"

ILQR_DERIVS_LAUNCHER(thruster_ring, thruster_ring::Model<12>)
