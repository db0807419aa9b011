// The linearization kernel (derivs.cuh) instantiated for double_integrator.
#include "double_integrator.cuh"
#include "derivs.cuh"

ILQR_DERIVS_LAUNCHER(double_integrator, double_integrator::Model)
