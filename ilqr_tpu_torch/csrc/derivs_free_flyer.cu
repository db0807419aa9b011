// The linearization kernel (derivs.cuh) instantiated for free_flyer.
#include "free_flyer.cuh"
#include "derivs.cuh"

ILQR_DERIVS_LAUNCHER(free_flyer, free_flyer::Model)
