// The fused solver's four kernels instantiated for omni_thruster
// (n = 6, m = 6). See kernels.cuh.
#include "omni_thruster.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(omni_thruster, omni_thruster::Model)
