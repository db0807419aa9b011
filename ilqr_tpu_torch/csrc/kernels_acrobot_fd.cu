// The fused solver's stencil sweep and whole-iteration kernels
// (deriv_mode="fd", Euler or RK4) instantiated for acrobot
// (n = 4, m = 1). See kernels.cuh; the whole iteration is the team kernel
// of iteration_team.cuh (Model::kTeamIteration).
#include "acrobot.cuh"
#include "kernels.cuh"

ILQR_FD_LAUNCHERS(acrobot, acrobot::Model)
