// The fused solver's dual-number sweep and whole-iteration kernels
// (deriv_mode="analytic" with RK4: exact derivatives of the step)
// instantiated for power_mass (n = 4, m = 2). See kernels.cuh.
#include "power_mass.cuh"
#include "kernels.cuh"

ILQR_JVP_LAUNCHERS(power_mass, power_mass::Model)
