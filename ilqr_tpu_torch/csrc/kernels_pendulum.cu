// The fused solver's four kernels instantiated for the pendulum
// (n = 2, m = 1). See kernels.cuh; the whole
// iteration is the team kernel of iteration_team.cuh (Model::kTeamIteration).
#include "pendulum.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(pendulum, pendulum::Model)
