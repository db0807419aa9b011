// The linearization kernel (derivs.cuh) instantiated for bicycle.
#include "bicycle.cuh"
#include "derivs.cuh"

ILQR_DERIVS_LAUNCHER(bicycle, bicycle::Model)
