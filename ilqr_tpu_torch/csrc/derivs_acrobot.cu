// The linearization kernel (derivs.cuh) instantiated for acrobot.
#include "acrobot.cuh"
#include "derivs.cuh"

ILQR_DERIVS_LAUNCHER(acrobot, acrobot::Model)
