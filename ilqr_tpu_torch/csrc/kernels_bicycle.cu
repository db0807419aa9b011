// The fused solver's four kernels instantiated for the kinematic bicycle
// (n = 4, m = 2). See kernels.cuh.
#include "bicycle.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(bicycle, bicycle::Model)
