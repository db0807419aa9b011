// The fused solver's dual-number sweep and whole-iteration kernels
// (deriv_mode="analytic" with RK4: exact derivatives of the step)
// instantiated for point_mass_3d (n = 6, m = 3). See kernels.cuh.
#include "point_mass_3d.cuh"
#include "kernels.cuh"

ILQR_JVP_LAUNCHERS(point_mass_3d, point_mass_3d::Model)
