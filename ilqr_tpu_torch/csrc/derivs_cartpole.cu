// The linearization kernel (derivs.cuh) instantiated for cartpole.
#include "cartpole.cuh"
#include "derivs.cuh"

ILQR_DERIVS_LAUNCHER(cartpole, cartpole::Model)
