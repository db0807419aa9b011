// The linearization kernel (derivs.cuh) instantiated for thruster_ring20.
#include "thruster_ring.cuh"
#include "derivs.cuh"

ILQR_DERIVS_LAUNCHER(thruster_ring20, thruster_ring::Model<20>)
