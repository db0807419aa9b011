"""Whole fused solves of pendulum (n = 2, m = 1), cartpole (n = 4, m = 1),
bicycle (n = 4, m = 2, tan steering, asymmetric box) and power_mass
(n = 4, m = 2, live cxu, full cxx/cuu) on the CPU (the port's plain
versions) against the JAX package's XLA path
``ilqr_tpu.batch.solve_batch`` with the XLA derivative, backward and
rollout routes — the reference the JAX package's own fused tests hold its
kernels to, on their inputs and to their bounds:

- cartpole: tests/test_fused_solver.py:51-69, costs to rtol 2e-4 and
  atol 2e-4;
- pendulum: :72-83 (there against the Pallas composable path), costs to
  rtol 1e-3;
- power_mass: :845-872, costs to rtol 1e-4, controls within 5e-3, and cxu
  live on these inputs;
- bicycle: :914-936, costs to rtol 1e-4, controls within 5e-3.

Each model also runs without control limits (the Newton step), to the same
bounds. The reference's derivatives come from autodiff, so these hold the
port's closed-form ``jac_soa``/``cost_derivs_soa`` and the sweep's general
cost-Hessian terms end to end. The routes: ``iter_kernel="auto"`` takes
the whole-iteration op for all four (m·n < 32); power_mass and bicycle
also take the split iteration (sweep + line search).

On the card the m = 1 split sweep (``sweep_kernel="split"``) needs the
derivative kernel for these models and the backward kernel at n = 2, which
are not ported: it raises there before anything runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu import get_model as jax_get_model
from ilqr_tpu.batch import solve_batch as jax_solve_batch
from ilqr_tpu.models import bicycle as jbc
from ilqr_tpu.models import power_mass as jpw
from ilqr_tpu_torch import SolverConfig, fused, get_model, solve_batch_fused
from ilqr_tpu_torch.models import bicycle as tbc
from ilqr_tpu_torch.models import cartpole as tcp
from ilqr_tpu_torch.models import pendulum as tpd
from ilqr_tpu_torch.models import power_mass as tpw

FAST_ALPHAS = (1.0, 0.3, 0.03)
PORT = {"pendulum": tpd, "cartpole": tcp, "bicycle": tbc, "power_mass": tpw}


def _case(name):
    """(JAX params, T, dt, max_iter, x0 (2 or 4, n), cost rtol, cost atol,
    controls bound) of the JAX package's fused test of ``name``."""
    jm = jax_get_model(name)
    if name == "bicycle":
        jp = jbc.default_params(goal=(3.0, 1.0, 0.0, 0.0))
    else:
        jp = jm.default_params()
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    if name == "cartpole":
        x0 = 0.3 * np.random.default_rng(3).normal(size=(4, 4))
        return jp, 12, 0.02, 6, x0, 2e-4, 2e-4, None
    if name == "pendulum":
        return jp, 10, 0.05, 10, np.zeros((2, 2)), 1e-3, 0.0, None
    if name == "power_mass":
        x0 = 0.4 * np.random.default_rng(5).normal(size=(2, 4))
        return jp, 15, 0.05, 8, x0, 1e-4, 0.0, 5e-3
    x0 = 0.2 * np.random.default_rng(9).normal(size=(2, 4))
    return jp, 15, 0.05, 8, x0, 1e-4, 0.0, 5e-3


@pytest.mark.parametrize("name,use_limits,iter_kernel", [
    ("cartpole", True, "auto"), ("cartpole", False, "auto"),
    ("pendulum", True, "auto"), ("pendulum", False, "auto"),
    ("power_mass", True, "auto"), ("power_mass", False, "auto"),
    ("power_mass", True, "split"),
    ("bicycle", True, "auto"), ("bicycle", False, "auto"),
    ("bicycle", True, "split"),
])
def test_fused_solve_matches_jax_xla(name, use_limits, iter_kernel):
    jp, T, dt, max_iter, x0, rtol, atol, us_tol = _case(name)
    model = get_model(name)
    x0 = x0.astype(np.float32)
    u0 = np.zeros((T, model.m), np.float32)
    kw = dict(deriv_mode="analytic", clamp_forward=use_limits,
              use_control_limits=use_limits, max_iter=max_iter,
              alphas=FAST_ALPHAS)
    ref = jax_solve_batch(
        jax_get_model(name), jax.tree_util.tree_map(jnp.asarray, jp),
        JaxConfig(backward_kernel="xla", rollout_kernel="xla",
                  deriv_kernel="xla", **kw),
        dt, jnp.asarray(x0), jnp.asarray(u0))
    cfg = SolverConfig(iter_kernel=iter_kernel, **kw)
    assert fused.fused_applicable(model, cfg)
    assert fused._use_iter_kernel(model, cfg) == (iter_kernel == "auto")
    got = solve_batch_fused(model, PORT[name].params_from_numpy(jp), cfg, dt,
                            x0, u0, device="cpu")
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=rtol, atol=atol)
    us = got.us.numpy()
    if us_tol is not None:
        assert np.abs(us - np.asarray(ref.us)).max() < us_tol
    B = x0.shape[0]
    assert got.us.shape == (B, T, model.m)
    assert got.K.shape == (B, T, model.m, model.n)
    assert got.xs.shape == (B, T + 1, model.n)
    assert np.all(np.isfinite(got.cost.numpy()))
    if use_limits:
        lo, hi = jp.u_min.reshape(-1), jp.u_max.reshape(-1)
        assert np.all(us >= lo - 1e-6) and np.all(us <= hi + 1e-6)
    if name == "power_mass":
        # the solve engages the cross terms: cxu's velocity rows are live
        # at the solution (tests/test_fused_solver.py:866-871)
        cxu = jpw.cost_derivs_soa(
            jax.tree_util.tree_map(jnp.asarray, jp),
            jnp.asarray(x0[0])[:, None], jnp.ones((2, 1), jnp.float32))[3]
        assert any(abs(float(jnp.broadcast_to(v, (1,))[0])) > 1e-6
                   for row in cxu for v in row if not isinstance(v, float))
        tcxu = tpw.cost_derivs_soa(
            tpw.params_from_numpy(jp), got.xs[:, :-1].permute(2, 1, 0),
            got.us.permute(2, 1, 0))[3]
        assert float(torch.stack([tcxu[2][0], tcxu[3][1]]).abs().max()) > 0.1


@pytest.mark.parametrize("name", ["pendulum", "cartpole"])
def test_split_sweep_raises_on_the_card(name, monkeypatch):
    """sweep_kernel="split" needs the derivative kernel for the model
    (ROADMAP §B item 5) and, for the pendulum, the backward kernel at n = 2
    (item 6): on the card it raises NotImplementedError before any op
    runs, and falls back to nothing. On the CPU the plain versions run it
    and agree with the merged sweep."""
    model = get_model(name)
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=3, sweep_kernel="split", alphas=FAST_ALPHAS)
    with pytest.raises(NotImplementedError, match="derivs_packed") as err:
        fused._check_kernels(model, cfg, torch.device("cuda"))
    assert ("backward_sweep_packed at n = 2" in str(err.value)) == (
        model.n == 2)
    fused._check_kernels(model, cfg, torch.device("cpu"))
    fused._check_kernels(get_model("acrobot"), cfg, torch.device("cuda"))

    # solve_batch_fused checks before the initial rollout
    def no_op(*a, **k):
        raise AssertionError("an op ran for an unported route")

    monkeypatch.setattr(fused, "rollout_packed", no_op)
    monkeypatch.setattr(fused, "resolve_device",
                        lambda device: torch.device("cuda"))
    x0 = np.zeros((2, model.n), np.float32)
    u0 = np.zeros((5, 1), np.float32)
    with pytest.raises(NotImplementedError, match="item 5"):
        solve_batch_fused(model, model.default_params(), cfg, 0.05, x0, u0)
    monkeypatch.undo()
    split = solve_batch_fused(model, model.default_params(), cfg, 0.05, x0,
                              u0, device="cpu")
    merged = solve_batch_fused(model, model.default_params(),
                               cfg.replace(sweep_kernel="merged"), 0.05, x0,
                               u0, device="cpu")
    np.testing.assert_allclose(split.cost.numpy(), merged.cost.numpy(),
                               rtol=1e-5)
