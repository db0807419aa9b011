// The linearization kernel (derivs.cuh) instantiated for thruster_ring24.
#include "thruster_ring.cuh"
#include "derivs.cuh"

ILQR_DERIVS_LAUNCHER(thruster_ring24, thruster_ring::Model<24>)
