// The linearization kernel (derivs.cuh) instantiated for power_mass.
#include "power_mass.cuh"
#include "derivs.cuh"

ILQR_DERIVS_LAUNCHER(power_mass, power_mass::Model)
