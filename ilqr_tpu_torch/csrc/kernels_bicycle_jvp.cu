// The fused solver's dual-number sweep and whole-iteration kernels
// (deriv_mode="analytic" with RK4: exact derivatives of the step)
// instantiated for bicycle (n = 4, m = 2). See kernels.cuh.
#include "bicycle.cuh"
#include "kernels.cuh"

ILQR_JVP_LAUNCHERS(bicycle, bicycle::Model)
