// The fused solver's stencil sweep and whole-iteration kernels
// (deriv_mode="fd", Euler or RK4) instantiated for power_mass
// (n = 4, m = 2; live cxu, full cuu). See kernels.cuh.
#include "power_mass.cuh"
#include "kernels.cuh"

ILQR_FD_LAUNCHERS(power_mass, power_mass::Model)
