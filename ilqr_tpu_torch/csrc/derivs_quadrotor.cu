// The linearization kernel (derivs.cuh) instantiated for quadrotor.
#include "quadrotor.cuh"
#include "derivs.cuh"

ILQR_DERIVS_LAUNCHER(quadrotor, quadrotor::Model)
