"""The fused solver's warm start (``solve_batch_fused_warm``) and the fleet
MPC on it (``ilqr_tpu_torch.mpc``) against the JAX package, on the CPU.

- ``solve_batch_fused_warm`` (the port's plain versions) against
  ``ilqr_tpu.fused.solve_batch_fused_warm`` (Pallas interpret mode) on the
  inputs of tests/test_fused_solver.py:119 (acrobot), :510 (the m = 2
  double integrator) and :640 (the whole-iteration and split-iteration
  routes without limits). Both sides warm-start from the same previous
  Solution (the port's cold solve, handed to JAX as arrays) at x0 moved
  by 0.01·normal, so the re-rollout's feedback K (x − x̄) is live: costs
  to rtol 1e-4, equal iteration counts and reasons, states and controls
  to 1e-4 (tests/test_torch_fused.py's bounds; see ``_check``). The JAX
  side runs the m = 2 problems in time blocks of 1 to keep its compile
  short (the fleet and acrobot too).
- A warm re-solve from the same states never worsens a lane's cost by more
  than 1e-3 (the JAX test's bound), and takes a Solution with numpy
  fields as it takes one of tensors.
- ``fleet_init`` + 3 × ``fleet_step`` against ``ilqr_tpu.mpc`` on
  tests/test_mpc.py:88-112's inputs: states to 1e-4, the plans as above,
  step counters equal.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu import get_model as jax_get_model
from ilqr_tpu import mpc as jax_mpc
from ilqr_tpu.fused import solve_batch_fused_warm as jax_warm
from ilqr_tpu.types import Solution as JaxSolution
from ilqr_tpu_torch import (
    SolverConfig,
    Solution,
    get_model,
    mpc,
    solve_batch_fused,
    solve_batch_fused_warm,
)
from ilqr_tpu_torch.ops import (
    kernel_rollout,
    launch_counts,
    reset_launch_counts,
)

FAST_ALPHAS = (1.0, 0.3, 0.03)
COST_RTOL = 1e-4
ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(name, **kw):
    """(JAX params, port params) of ``name``'s defaults in f32."""
    import importlib

    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                jax_get_model(name).default_params(**kw))
    mod = importlib.import_module(f"ilqr_tpu_torch.models.{name}")
    return jax.tree_util.tree_map(jnp.asarray, jp), mod.params_from_numpy(jp)


def _as_jax(sol: Solution) -> JaxSolution:
    return JaxSolution(*[jnp.asarray(getattr(sol, f).numpy())
                         for f in JaxSolution._fields])


def _check(got, ref, trajectory=True):
    """Costs, iterations, reasons and (with ``trajectory``) the states and
    controls. λ and the gains are not compared: once a lane has converged
    its line search decides on a dcost of an ulp of the cost, so the λ
    schedule, and the gains through Quu + λ, follow each side's rounding
    (tests/test_torch_fused.py's docstring)."""
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=COST_RTOL)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got.reason.numpy(), np.asarray(ref.reason))
    for name in ("us", "xs") if trajectory else ():
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=ATOL,
                                   err_msg=name)


def _warm_both(name, x0, T, kw, time_block, params_kw=None, seed=7):
    """The port's cold solve, then both packages' warm starts from it at
    x0 + 0.01·normal; returns (cold, port warm, JAX warm, moved x0)."""
    jp, tp = _params(name, **(params_kw or {}))
    model = get_model(name)
    u0 = np.zeros((T, model.m), np.float32)
    cold = solve_batch_fused(model, tp, SolverConfig(**kw), DT[name], x0, u0,
                             device="cpu")
    x1 = (x0 + 0.01 * np.random.default_rng(seed).normal(size=x0.shape)
          ).astype(np.float32)
    reset_launch_counts()
    got = solve_batch_fused_warm(model, tp, SolverConfig(**kw), DT[name], x1,
                                 cold, device="cpu")
    assert not any(launch_counts().values())
    ref = jax_warm(jax_get_model(name), jp,
                   JaxConfig(iter_time_block=time_block,
                             sweep_time_block=time_block,
                             ls_time_block=time_block, **kw),
                   DT[name], jnp.asarray(x1), _as_jax(cold))
    return cold, got, ref, x1


DT = {"acrobot": 0.02, "double_integrator": 0.02, "pendulum": 0.05}


def test_warm_matches_jax_acrobot():
    """tests/test_fused_solver.py:119-135's problem (acrobot, B = 3,
    T = 15, max_iter = 8): costs, iterations and reasons, as that test
    reads them. Its bang-bang solution has one interior control (step 8),
    which the two sides' sin/cos ulps move apart slowly (|Δu| 3e-6 after
    one iteration, 9e-4 after eight), so the trajectories are held on the
    m = 2 problems below, which have no trig."""
    rng = np.random.default_rng(1)
    x0 = (0.05 * rng.normal(size=(3, 4))).astype(np.float32)
    kw = dict(deriv_mode="analytic", clamp_forward=True, max_iter=8)
    _cold, got, ref, _x1 = _warm_both("acrobot", x0, 15, kw, 1)
    _check(got, ref, trajectory=False)


def test_warm_rollout_closes_the_loop_around_prev():
    """With max_iter = 0 the warm start returns its initial rollout: from
    the new x0, prev.us with the feedback prev.K (x − prev.xs), clamped —
    the plain rollout on the relaid previous trajectory, bit for bit, and
    not the open-loop one; λ/dλ carried, k and K zero."""
    _jp, tp = _params("acrobot")
    model = get_model("acrobot")
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True, max_iter=4)
    x0 = (0.05 * np.random.default_rng(1).normal(size=(3, 4))).astype(
        np.float32)
    cold = solve_batch_fused(model, tp, cfg, 0.02, x0, np.zeros((15, 1)),
                             device="cpu")
    x1 = torch.from_numpy(x0 + np.float32(0.05))
    warm = solve_batch_fused_warm(model, tp, cfg.replace(max_iter=0), 0.02,
                                  x1, cold, device="cpu")
    pp = kernel_rollout.pack_params(tp, 0.02)
    xs, us, xT, cost = kernel_rollout.rollout_plain(
        model, "euler", True, pp, x1.t(), cold.us.permute(1, 2, 0),
        cold.xs[:, :-1].permute(1, 2, 0), cold.K.permute(1, 2, 3, 0))
    np.testing.assert_array_equal(warm.cost.numpy(), cost.numpy())
    np.testing.assert_array_equal(warm.us.numpy(),
                                  us.permute(2, 0, 1).numpy())
    np.testing.assert_array_equal(
        warm.xs.numpy(), torch.cat([xs, xT[None]]).permute(2, 0, 1).numpy())
    np.testing.assert_array_equal(warm.lam.numpy(), cold.lam.numpy())
    np.testing.assert_array_equal(warm.dlam.numpy(), cold.dlam.numpy())
    assert not warm.K.any() and not warm.k.any()
    assert np.all(warm.iterations.numpy() == 0)
    open_loop = solve_batch_fused_warm(
        model, tp, cfg.replace(max_iter=0), 0.02, x1,
        cold._replace(K=torch.zeros_like(cold.K)), device="cpu")
    assert np.abs(open_loop.cost.numpy() - cost.numpy()).min() > 0.1


def test_warm_matches_jax_m2():
    """tests/test_fused_solver.py:510-530's problem (double integrator,
    B = 2, T = 12, max_iter = 12, the enumeration QP)."""
    rng = np.random.default_rng(5)
    x0 = (rng.normal(size=(2, 4)) * 0.3).astype(np.float32)
    kw = dict(deriv_mode="analytic", clamp_forward=True, max_iter=12)
    _cold, got, ref, _x1 = _warm_both(
        "double_integrator", x0, 12, kw, 1,
        params_kw=dict(goal=(1.0, 0.5, 0.0, 0.0)))
    _check(got, ref)


@pytest.mark.parametrize("iter_kernel", ["merged", "split"])
def test_warm_routes_without_limits_match_jax(iter_kernel):
    """tests/test_fused_solver.py:640-669's problem (double integrator
    without limits, B = 2, T = 12, max_iter = 5) on the whole-iteration
    and the split-iteration routes."""
    rng = np.random.default_rng(10)
    x0 = (rng.normal(size=(2, 4)) * 0.3).astype(np.float32)
    kw = dict(deriv_mode="analytic", clamp_forward=False,
              use_control_limits=False, max_iter=5, alphas=FAST_ALPHAS,
              iter_kernel=iter_kernel)
    _cold, got, ref, _x1 = _warm_both(
        "double_integrator", x0, 12, kw, 1,
        params_kw=dict(goal=(1.0, 0.5, 0.0, 0.0)))
    _check(got, ref)


@pytest.mark.parametrize("route", ["whole-iteration", "split iteration",
                                   "split sweep"])
def test_warm_from_same_states_never_worsens(route):
    """The JAX test's bound (tests/test_fused_solver.py:133-134): a warm
    re-solve from the same states takes no more iterations than the cold
    solve's budget and never worsens a lane's cost by more than 1e-3; a
    Solution with numpy fields warm-starts the same."""
    _jp, tp = _params("acrobot")
    model = get_model("acrobot")
    extra = {"whole-iteration": {}, "split iteration":
             dict(iter_kernel="split"), "split sweep":
             dict(sweep_kernel="split")}[route]
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True, max_iter=8,
                       **extra)
    x0 = (0.05 * np.random.default_rng(1).normal(size=(3, 4))).astype(
        np.float32)
    cold = solve_batch_fused(model, tp, cfg, 0.02, x0, np.zeros((15, 1)),
                             device="cpu")
    warm = solve_batch_fused_warm(model, tp, cfg, 0.02, x0, cold,
                                  device="cpu")
    assert int(warm.iterations.max()) <= 8
    assert np.all(warm.cost.numpy() <= cold.cost.numpy() + 1e-3)
    as_numpy = Solution(*[a.numpy() for a in cold])
    again = solve_batch_fused_warm(model, tp, cfg, 0.02, x0, as_numpy,
                                   device="cpu")
    for a, b in zip(warm, again):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_warm_checks_the_previous_solution():
    _jp, tp = _params("acrobot")
    model = get_model("acrobot")
    cfg = SolverConfig(max_iter=2)
    x0 = np.zeros((2, 4), np.float32)
    cold = solve_batch_fused(model, tp, cfg, 0.02, x0, np.zeros((5, 1)),
                             device="cpu")
    with pytest.raises(ValueError, match="prev.K"):
        solve_batch_fused_warm(model, tp, cfg, 0.02, x0,
                               cold._replace(K=cold.K[:, :4]), device="cpu")
    with pytest.raises(ValueError, match="prev.us"):
        solve_batch_fused_warm(model, tp, cfg, 0.02, np.zeros((3, 4)), cold,
                               device="cpu")


def test_fleet_mpc_matches_jax():
    """tests/test_mpc.py:88-112's fleet (pendulum, B = 3, T = 12,
    max_iter = 6): fleet_init and three fleet_step replans on both
    packages."""
    jp, tp = _params("pendulum")
    model = get_model("pendulum")
    kw = dict(deriv_mode="analytic", clamp_forward=True, max_iter=6)
    rng = np.random.default_rng(0)
    x0s = (rng.normal(size=(3, 2)) * 0.2).astype(np.float32)
    u0 = np.zeros((12, 1), np.float32)
    jcfg = JaxConfig(iter_time_block=1, sweep_time_block=1, ls_time_block=1,
                     **kw)
    jfleet = jax_mpc.fleet_init(jax_get_model("pendulum"), jp, jcfg, 0.05,
                                jnp.asarray(x0s), jnp.asarray(u0))
    fleet = mpc.fleet_init(model, tp, SolverConfig(**kw), 0.05, x0s, u0,
                           device="cpu")
    for step in range(4):
        if step:
            jfleet = jax_mpc.fleet_step(jax_get_model("pendulum"), jp, jcfg,
                                        0.05, jfleet)
            fleet = mpc.fleet_step(model, tp, SolverConfig(**kw), 0.05,
                                   fleet)
        np.testing.assert_allclose(fleet.x.numpy(), np.asarray(jfleet.x),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(fleet.t.numpy(), np.asarray(jfleet.t))
        _check(fleet.plan, jfleet.plan)
    assert fleet.x.shape == (3, 2) and int(fleet.t[0]) == 3
    assert int(fleet.plan.iterations.max()) <= 6
    assert np.all(np.isfinite(fleet.plan.cost.numpy()))


def test_fleet_step_applies_feedback_and_shifts():
    """The plant step is u = ū₀ + K₀ (x − x̄₀), clamped, then one Euler step;
    a disturbance moves the next states; the re-plan starts from the
    shifted plan (its controls' tail repeats)."""
    _jp, tp = _params("pendulum")
    model = get_model("pendulum")
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True, max_iter=3)
    x0s = np.asarray([[0.1, 0.0], [-0.2, 0.3]], np.float32)
    fleet = mpc.fleet_init(model, tp, cfg, 0.05, x0s, np.zeros((6, 1)),
                           device="cpu")
    moved = fleet._replace(x=fleet.x + 0.05)
    x_next = mpc.plant_step(model, tp, cfg, 0.05, moved)
    plan = fleet.plan
    u = (plan.us[:, 0, 0]
         + (plan.K[:, 0, 0] * (moved.x - plan.xs[:, 0])).sum(-1))
    u = u.clamp(float(tp.u_min[0]), float(tp.u_max[0]))
    theta, omega = moved.x[:, 0], moved.x[:, 1]
    dyn = model.dynamics_soa(tp, moved.x.t(), u[None])
    np.testing.assert_allclose(x_next.numpy(),
                               (moved.x.t() + dyn * 0.05).t().numpy(),
                               rtol=1e-6, atol=1e-7)
    assert theta.shape == omega.shape == (2,)
    d = np.asarray([0.01, -0.02], np.float32)
    nxt = mpc.fleet_step(model, tp, cfg, 0.05, moved, disturbance=d)
    np.testing.assert_allclose(nxt.x.numpy(), (x_next + torch.from_numpy(d))
                               .numpy(), rtol=0, atol=0)
    np.testing.assert_array_equal(nxt.t.numpy(), [1, 1])


def test_mpc_module_imports_no_jax():
    code = ("import sys, ilqr_tpu_torch.mpc\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'ilqr_tpu.')) or m == 'ilqr_tpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("entry", ["solve_batch_fused_warm", "fleet_init"])
def test_default_device_is_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    _jp, tp = _params("acrobot")
    model = get_model("acrobot")
    x0 = np.zeros((2, 4), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "fleet_init":
            mpc.fleet_init(model, tp, SolverConfig(), 0.02, x0,
                           np.zeros((5, 1), np.float32))
        else:
            cold = solve_batch_fused(model, tp, SolverConfig(max_iter=1),
                                     0.02, x0, np.zeros((5, 1), np.float32),
                                     device="cpu")
            solve_batch_fused_warm(model, tp, SolverConfig(), 0.02, x0, cold)
