// The linearization kernel (derivs.cuh) instantiated for omni_thruster.
#include "omni_thruster.cuh"
#include "derivs.cuh"

ILQR_DERIVS_LAUNCHER(omni_thruster, omni_thruster::Model)
