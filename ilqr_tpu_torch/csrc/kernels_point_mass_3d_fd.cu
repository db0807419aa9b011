// The fused solver's stencil sweep and whole-iteration kernels
// (deriv_mode="fd", Euler or RK4) instantiated for point_mass_3d
// (n = 6, m = 3). See kernels.cuh.
#include "point_mass_3d.cuh"
#include "kernels.cuh"

ILQR_FD_LAUNCHERS(point_mass_3d, point_mass_3d::Model)
