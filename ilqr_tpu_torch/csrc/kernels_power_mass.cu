// The fused solver's four kernels instantiated for the power-limited point
// mass (n = 4, m = 2; live cxu, full cuu). See kernels.cuh.
#include "power_mass.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(power_mass, power_mass::Model)
