// The linearization kernel (derivs.cuh) instantiated for point_mass_3d.
#include "point_mass_3d.cuh"
#include "derivs.cuh"

ILQR_DERIVS_LAUNCHER(point_mass_3d, point_mass_3d::Model)
