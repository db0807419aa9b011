// The fused solver's four kernels instantiated for the cart-pole
// (n = 4, m = 1). See kernels.cuh.
#include "cartpole.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(cartpole, cartpole::Model)
