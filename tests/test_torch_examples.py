"""The port's examples (ilqr_tpu_torch/examples/) on the CPU at
tests/test_examples.py's smoke shapes with ``--cpu`` (the two batch
examples in a subprocess each, mpc_fleet in this process), with the lines
their JAX counterparts print and check. examples/custom_model.py's
counterpart is covered by tests/test_torch_custom_model.py.

mpc_fleet's final fleet states are held against the JAX script's own run
at the same shapes (its vmapped ``mpc_init`` / ``mpc_step``, the composable
solver per controller, in f32) — the port's fleet is the fused fleet MPC
(``mpc.fleet_init`` / ``fleet_step``) — to 1e-5 on |a − b| (measured
2.4e-7 at fleet 2, 2 steps, horizon 8).
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ilqr_tpu import SolverConfig, get_model
from ilqr_tpu.mpc import mpc_init, mpc_step
from ilqr_tpu_torch.examples import mpc_fleet

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_TOL = 1e-5


def _run(module, *argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", f"ilqr_tpu_torch.examples.{module}", *argv],
        capture_output=True, text=True, timeout=600, env=env, cwd=_ROOT)
    assert res.returncode == 0, (
        f"{module} failed\nstdout:\n{res.stdout}\nstderr:\n{res.stderr}")
    return res.stdout


@pytest.mark.parametrize("module, checks", [
    ("free_flyer_docking", ("solves/s (vmap path)",
                            "per-craft peak thrust within own ceiling: "
                            "100%")),
    ("quadrotor_waypoints", ("solves/s (vmap path)",
                             "median final position error")),
])
def test_batch_example_smoke(module, checks):
    out = _run(module, "--cpu", "--vmap", "--batch", "2", "--horizon", "8",
               "--max-iter", "2")
    for check in checks:
        assert check in out
    assert "nan" not in out


def test_mpc_fleet_smoke_and_states_match_jax(capsys):
    # in this process: the two batch examples above run as scripts
    fleet = mpc_fleet.main(["--cpu", "--fleet", "2", "--steps", "2",
                            "--horizon", "8"])
    out = capsys.readouterr().out
    assert "replans/s" in out and "nan" not in out
    with jax.enable_x64(False):   # the script's f32 (the suite enables x64)
        model = get_model("double_integrator")
        params = model.default_params()
        cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                           max_iter=25)
        rng = np.random.default_rng(0)
        x0s = jnp.asarray(rng.normal(size=(2, model.n)) * 0.4, jnp.float32)
        u0 = jnp.zeros((8, model.m), jnp.float32)
        state = jax.vmap(functools.partial(mpc_init, model, params, cfg,
                                           0.05, u0=u0))(x0s)
        for _ in range(2):
            state = jax.vmap(functools.partial(mpc_step, model, params, cfg,
                                               0.05))(state)
        want = np.asarray(state.x)
    got = fleet.x.numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= FLEET_TOL
    np.testing.assert_array_equal(fleet.t.numpy(), [2, 2])
