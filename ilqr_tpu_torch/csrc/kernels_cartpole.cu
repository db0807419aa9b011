// The fused solver's four kernels instantiated for the cart-pole
// (n = 4, m = 1). See kernels.cuh; the whole
// iteration is the team kernel of iteration_team.cuh (Model::kTeamIteration).
#include "cartpole.cuh"
#include "kernels.cuh"

ILQR_FUSED_LAUNCHERS(cartpole, cartpole::Model)
