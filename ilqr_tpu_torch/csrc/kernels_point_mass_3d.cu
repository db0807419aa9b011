// The fused solver's four kernels instantiated for the 3D point mass
// (n = 6, m = 3). See kernels.cuh.
#include "point_mass_3d.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(point_mass_3d, point_mass_3d::Model)
