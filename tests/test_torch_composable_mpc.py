"""The composable solver's single-problem entry points and the single-
controller MPC (``solve``, ``solve_verbose``, ``solve_warm``, ``mpc_init``,
``mpc_step``, ``make_mpc_controller``, ``run_mpc``) on the CPU against the
JAX package and the reference's golden trajectory.

- The reference's main path, the CLI's ``integrator`` problem
  (``run_ilqr integrator``: fd derivatives, the iterative box QP,
  unclamped, Euler, T = 99, dt = 0.02, x0 = (−1, 0, 0, −0.2), goal
  (1, .5, 0, 0)), in f32 against golden/integrator_golden.csv at
  chip_smoke's f32 bounds (cost within 1e-2 of 356.1685, controls within
  1e-3), with the JAX package's f32 solve's termination reason and
  iteration count. In f32 both end at λ > λmax after 15 iterations, not
  at the f64 reference's FUN_TOL after 14: past the optimum the f32
  stencils' noise makes every step a "NO STEP" (ROADMAP.md §C).
- ``solve_verbose``'s table against the JAX package's, line for line, on
  the same problem with analytic derivatives: the iteration, the step
  label, the expected reduction, the gradient norm and log10(λ) as
  printed, the cost within 1e-5 relative and the reduction within 1e-4
  (four ulps of the cost, of which the printed reduction is a
  difference), the closing message equal.
- ``solve_warm`` from a cold solution, ``mpc_step`` (with a disturbance)
  and ``run_mpc`` on tests/test_mpc.py's double integrator (goal (1, .5),
  T = 40, dt = 0.05, analytic, clamped, max_iter 30) against the JAX
  functions for a few steps: states and costs within 1e-4 relative,
  iteration counts equal.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu import get_model as jax_get_model
from ilqr_tpu import mpc as jax_mpc
from ilqr_tpu import solve as jax_solve
from ilqr_tpu import solve_verbose as jax_solve_verbose
from ilqr_tpu import solve_warm as jax_solve_warm
from ilqr_tpu.models import double_integrator as jdi
from ilqr_tpu_torch import SolverConfig, get_model, mpc, solve
from ilqr_tpu_torch import solve_verbose, solve_warm
from ilqr_tpu_torch.models import double_integrator as tdi

GOLDEN_CSV = "golden/integrator_golden.csv"
GOLDEN_COST, GOLDEN_COST_TOL, GOLDEN_US_TOL = 356.1685, 1e-2, 1e-3
X0 = np.array([-1.0, 0.0, 0.0, -0.2], np.float32)
GOAL = (1.0, 0.5, 0.0, 0.0)
REL = 1e-4


def _params():
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float32)),
                                jdi.default_params(goal=GOAL))
    return jp, tdi.default_params(goal=GOAL)


def _golden_us():
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), GOLDEN_CSV)
    rows = [[float(v) for v in line.replace(",", " ").split()]
            for line in open(path).read().splitlines()[1:]]
    return np.asarray([r[4:6] for r in rows[:-1]])


def test_integrator_main_path_matches_golden_and_jax():
    jp, tp = _params()
    u0 = np.zeros((99, 2), np.float32)
    got = solve(get_model("double_integrator"), tp,
                SolverConfig(deriv_mode="fd"), 0.02, X0, u0, device="cpu")
    ref = jax_solve(jax_get_model("double_integrator"), jp,
                    JaxConfig(deriv_mode="fd"), 0.02, jnp.asarray(X0),
                    jnp.asarray(u0))
    assert abs(float(got.cost) - GOLDEN_COST) <= GOLDEN_COST_TOL
    assert np.abs(got.us.numpy() - _golden_us()).max() <= GOLDEN_US_TOL
    assert int(got.reason) == int(ref.reason)
    assert int(got.iterations) == int(ref.iterations)


def _table(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue().splitlines()


def test_solve_verbose_table_matches_jax():
    jp, tp = _params()
    u0 = np.zeros((99, 2), np.float32)
    want = _table(jax_solve_verbose, jax_get_model("double_integrator"), jp,
                  JaxConfig(deriv_mode="analytic"), 0.02, jnp.asarray(X0),
                  jnp.asarray(u0))
    got = _table(lambda *a: solve_verbose(*a, device="cpu"),
                 get_model("double_integrator"), tp,
                 SolverConfig(deriv_mode="analytic"), 0.02, X0, u0)
    assert len(got) == len(want) and len(want) > 8
    assert got[:2] == want[:2] and got[-3:] == want[-3:]
    for g, w in zip(got[2:-3], want[2:-3]):
        gf, wf = g.split("\t"), w.split("\t")
        assert len(gf) == len(wf) == 6, (g, w)
        assert (gf[0], gf[3], gf[4], gf[5]) == (wf[0], wf[3], wf[4], wf[5])
        if "NO STEP" in wf[1]:
            assert gf[1] == wf[1]
        else:
            assert abs(float(gf[1]) - float(wf[1])) <= 1e-5 * float(wf[1])
        assert abs(float(gf[2]) - float(wf[2])) <= 1e-4, (g, w)


def _mpc_setup():
    jp, tp = _params()
    jcfg = JaxConfig(deriv_mode="analytic", clamp_forward=True, max_iter=30)
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True, max_iter=30)
    x0 = np.array([-1.0, 0.0, 0.0, 0.0], np.float32)
    return jp, tp, jcfg, cfg, x0, np.zeros((40, 2), np.float32)


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max() <= REL, (what, float(err.max()))


def test_solve_warm_matches_jax():
    """A cold solve, the plant moved, then the warm re-solve from the cold
    solution (handed to JAX as arrays) on both sides."""
    jp, tp, jcfg, cfg, x0, u0 = _mpc_setup()
    model, jm = get_model("double_integrator"), jax_get_model(
        "double_integrator")
    cold = solve(model, tp, cfg, 0.05, x0, u0, device="cpu")
    x1 = x0 + np.array([0.05, -0.02, 0.1, 0.0], np.float32)
    got = solve_warm(model, tp, cfg, 0.05, x1, cold, device="cpu")
    prev = type(jax_solve(jm, jp, jcfg, 0.05, jnp.asarray(x0),
                          jnp.asarray(u0)))(
        *(jnp.asarray(a.numpy()) for a in cold))
    ref = jax_solve_warm(jm, jp, jcfg, 0.05, jnp.asarray(x1), prev)
    assert int(got.iterations) == int(ref.iterations)
    _close(got.cost, ref.cost, "cost")
    _close(got.xs, ref.xs, "xs")
    _close(got.lam, ref.lam, "lam")


def test_mpc_step_and_run_mpc_match_jax():
    jp, tp, jcfg, cfg, x0, u0 = _mpc_setup()
    model, jm = get_model("double_integrator"), jax_get_model(
        "double_integrator")
    steps = 4
    state, (xs, costs) = mpc.run_mpc(model, tp, cfg, 0.05, x0, u0, steps,
                                     device="cpu")
    jstate, (jxs, jcosts) = jax_mpc.run_mpc(jm, jp, jcfg, 0.05,
                                            jnp.asarray(x0),
                                            jnp.asarray(u0), n_steps=steps)
    assert xs.shape == (steps, 4) and costs.shape == (steps,)
    _close(xs, jxs, "run_mpc x")
    _close(costs, jcosts, "run_mpc cost")
    assert int(state.t) == int(jstate.t) == steps
    assert int(state.plan.iterations) == int(jstate.plan.iterations)
    # one more cycle with a disturbance, through the controller's callables
    init_fn, step_fn = mpc.make_mpc_controller(model, cfg, 0.05)
    kick = np.array([0.1, -0.1, 0.0, 0.0], np.float32)
    got = step_fn(tp, state=state, disturbance=kick)
    want = jax_mpc.mpc_step(jm, jp, jcfg, 0.05, jstate,
                            disturbance=jnp.asarray(kick))
    _close(got.x, want.x, "mpc_step x")
    _close(got.plan.cost, want.plan.cost, "mpc_step cost")
    assert int(got.plan.iterations) == int(want.plan.iterations)
    first = init_fn(tp, x0=x0, u0=u0, device="cpu")
    _close(first.plan.cost, jax_mpc.mpc_init(
        jm, jp, jcfg, 0.05, jnp.asarray(x0), jnp.asarray(u0)).plan.cost,
        "mpc_init cost")


@pytest.mark.parametrize("mode", ["iterative", "enum", "pn_fixed"])
def test_single_solve_modes_match_jax(mode):
    """``solve`` of one problem (one lane of the batch path) in each QP
    mode at m = 2."""
    jp, tp, jcfg, cfg, x0, u0 = _mpc_setup()
    got = solve(get_model("double_integrator"), tp,
                cfg.replace(boxqp_mode=mode, max_iter=6), 0.05, x0, u0,
                device="cpu")
    ref = jax_solve(jax_get_model("double_integrator"), jp,
                    jcfg.replace(boxqp_mode=mode, max_iter=6), 0.05,
                    jnp.asarray(x0), jnp.asarray(u0))
    assert got.cost.shape == ()
    _close(got.cost, ref.cost, "cost")
    assert int(got.iterations) == int(ref.iterations)
