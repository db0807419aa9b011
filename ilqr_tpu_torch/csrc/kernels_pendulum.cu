// The fused solver's four kernels instantiated for the pendulum
// (n = 2, m = 1). See kernels.cuh.
#include "pendulum.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(pendulum, pendulum::Model)
