// The m = 1 backward kernel (backward.cuh) instantiated for n = 2
// (pendulum) and n = 4 (acrobot, cartpole): ilqr_backward_n2,
// ilqr_backward_n4.
#include "backward.cuh"

ILQR_BACKWARD_LAUNCHER(2)
ILQR_BACKWARD_LAUNCHER(4)
