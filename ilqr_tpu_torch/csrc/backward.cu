// The m = 1 backward kernel (backward.cuh: a team of threads per lane fed
// by a cp.async ring) instantiated for n = 2 (pendulum) and n = 4 (acrobot,
// cartpole): ilqr_backward_n2, ilqr_backward_n4, and their
// ilqr_backward_n<n>_blocks_per_sm.
#include "backward.cuh"

ILQR_BACKWARD_LAUNCHER(2)
ILQR_BACKWARD_LAUNCHER(4)
