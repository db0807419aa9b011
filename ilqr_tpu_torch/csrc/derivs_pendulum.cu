// The linearization kernel (derivs.cuh) instantiated for pendulum.
#include "pendulum.cuh"
#include "derivs.cuh"

ILQR_DERIVS_LAUNCHER(pendulum, pendulum::Model)
