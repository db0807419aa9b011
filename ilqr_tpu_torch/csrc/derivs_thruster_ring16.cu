// The linearization kernel (derivs.cuh) instantiated for thruster_ring16.
#include "thruster_ring.cuh"
#include "derivs.cuh"

ILQR_DERIVS_LAUNCHER(thruster_ring16, thruster_ring::Model<16>)
