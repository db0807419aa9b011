// The fused solver's dual-number sweep and whole-iteration kernels
// (deriv_mode="analytic" with RK4: exact derivatives of the step)
// instantiated for pendulum (n = 2, m = 1). See kernels.cuh; the whole
// iteration is the team kernel of iteration_team.cuh (Model::kTeamIteration).
#include "pendulum.cuh"
#include "kernels.cuh"

ILQR_JVP_LAUNCHERS(pendulum, pendulum::Model)
