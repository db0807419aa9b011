// The fused solver's stencil sweep and whole-iteration kernels
// (deriv_mode="fd", Euler or RK4) instantiated for acrobot
// (n = 4, m = 1). See kernels.cuh.
#include "acrobot.cuh"
#include "kernels.cuh"

ILQR_FD_LAUNCHERS(acrobot, acrobot::Model)
