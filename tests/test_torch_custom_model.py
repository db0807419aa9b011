"""Custom models in ilqr_tpu_torch: the registry, the recorder and emitter
that turn a model's torch SoA functions into the kernels' device functions
(ops/codegen.py), the model's library sources (ops/_build.py), the "xla"
routes of a model without SoA functions, and the composable solve of the
unicycle against the JAX package's (examples/custom_model.py).

Tolerances. The recorder replays the very torch operations of the SoA
functions, so its evaluation is held bit for bit. Whole composable solves
hold JAX's cost to rtol 1e-3 (the trig of the two libraries differs by an
ulp, which 80 steps and tens of iterations carry; measured 1.3e-7) and the
goal to 0.1, as tests/test_custom_model.py does. The plain split iteration
equals the plain merged one bit for bit (the same sweep and line search).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu import solve as jax_solve
from ilqr_tpu_torch import SolverConfig, solve, solve_batch, solve_batch_fused
from ilqr_tpu_torch import models
from ilqr_tpu_torch.examples import custom_model as tcm
from ilqr_tpu_torch.ops import (
    _build,
    codegen,
    kernel_backward,
    kernel_iter,
    kernel_rollout,
    launch_counts,
    reset_launch_counts,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import custom_model as jcm  # noqa: E402

GOAL_TOL = 0.1
SOLVE_RTOL = 1e-3
FAST_ALPHAS = (1.0, 0.3, 0.03)


@pytest.fixture(autouse=True, scope="module")
def _restore_registry():
    """The models this module registers leave the registry with it (other
    modules in the same process count the package's 14)."""
    saved = dict(models._REGISTRY)
    yield
    models._REGISTRY.clear()
    models._REGISTRY.update(saved)


def _registered():
    return tcm.register_models()


def test_register_get_and_refuse():
    uni, head = _registered()
    assert models.get_model("unicycle") is uni
    assert models.get_model("unicycle_heading") is head
    assert {"unicycle", "unicycle_heading"} <= set(models.list_models())
    assert models.custom_model(uni) is uni
    assert models.custom_model(models.get_model("acrobot")) is None
    assert models.is_builtin(models.get_model("pendulum"))
    assert not models.is_builtin(uni)
    with pytest.raises(ValueError, match="already registered"):
        models.register(uni)
    with pytest.raises(ValueError, match="already registered"):
        models.register(dataclasses.replace(uni))
    for bad in ("my-model", "2wheel", "uni cycle", "ünicycle", ""):
        with pytest.raises(ValueError, match="C identifier"):
            models.register(dataclasses.replace(uni, name=bad))
    assert "my-model" not in models.list_models()
    # an unregistered copy has no kernels on the card
    other = dataclasses.replace(uni, name="unicycle_copy")
    assert models.custom_model(other) is None
    pp = kernel_rollout.pack_params(tcm.default_params(), 0.05)
    with pytest.raises(NotImplementedError, match="register"):
        kernel_rollout.require_kernel_model(other, "euler", pp,
                                            pp.vec.device)
    assert kernel_rollout.require_kernel_model(
        uni, "rk4", pp, pp.vec.device, limits=True) == "ilqr_unicycle"


def _soa_inputs(model, seed, B=64):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((2.0 * rng.normal(size=(model.n, B)))
                         .astype(np.float32))
    u = torch.from_numpy((2.0 * rng.normal(size=(model.m, B)))
                         .astype(np.float32))
    p = model.default_params()
    # lane-broadcast params, as the plain versions pass them
    p = type(p)(*(leaf.reshape(tuple(leaf.shape) + (1,)) for leaf in p))
    return p, x, u


@pytest.mark.parametrize("name", ["unicycle", "unicycle_heading"])
def test_recorder_replays_the_soa_functions_bitwise(name):
    model = {"unicycle": tcm.UNICYCLE,
             "unicycle_heading": tcm.UNICYCLE_HEADING}[name]
    rec = codegen.record(model)
    assert (rec.n, rec.m) == (model.n, model.m)
    assert rec.fields == type(model.default_params())._fields
    for seed in (0, 1, 2):
        p, x, u = _soa_inputs(model, seed)
        dx, c, cf = codegen.evaluate(rec, p, x, u)
        assert torch.equal(dx, model.dynamics_soa(p, x, u))
        assert torch.equal(c, model.cost_soa(p, x, u))
        assert torch.equal(cf, model.final_cost_soa(p, x))


def test_emitted_header():
    text = codegen.model_header(tcm.UNICYCLE)
    assert "static constexpr int N = 3;" in text
    assert "static constexpr int M = 2;" in text
    fields = [f"float {f}[" for f in tcm.UnicycleParams._fields]
    pos = [text.index(f) for f in fields]
    assert pos == sorted(pos) and text.index("float dt;") > pos[-1]
    for template in ("static void dynamics(", "static S cost(",
                     "static S final_cost("):
        assert template in text
    assert text.count("template <class S>") == 3
    assert "return p.u_min[j];" in text and "return p.u_max[j];" in text
    assert "dual::cos_of(x[2])" in text and "dual::sin_of(x[2])" in text
    assert "(p.goal[0] - x[0])" in text
    assert "q.dt = p[12];" in text
    # PyTorch's CUDA division by a constant: a multiply by f32(1/3)
    head = codegen.model_header(tcm.UNICYCLE_HEADING)
    assert "(u[0] * 0.333333343f)" in head and " / " not in head.split(
        "dynamics(")[1].split("cost(")[0]
    assert "ILQR_BACKWARD_LAUNCHER(3)" in _build.model_sources(
        tcm.UNICYCLE_HEADING)["backward.cu"]
    src = _build.model_sources(tcm.UNICYCLE)
    assert "backward.cu" not in src
    assert "ILQR_ROLLOUT_LAUNCHERS(unicycle, custom_model::Model)" in src[
        "rollout.cu"]
    assert "ILQR_JVP_LAUNCHERS(unicycle," in src["jvp.cu"]
    assert "ILQR_FD_LAUNCHERS(unicycle," in src["fd.cu"]
    assert "ILQR_DERIVS_LAUNCHER(unicycle," in src["derivs.cu"]
    assert _build.model_dir(tcm.UNICYCLE).parent == _build.CUSTOM_ROOT


def test_emitter_writes_pytorch_arithmetic():
    """Each operation as PyTorch computes it on the card: c / x as
    reciprocal(x)·c, x / c as x times f32(1/c), constants exact f32
    literals, a params-only value as float and lifted to S."""
    from typing import NamedTuple

    class Params(NamedTuple):
        k: torch.Tensor
        u_min: torch.Tensor
        u_max: torch.Tensor

    def dyn(p, x, u):
        return torch.stack([2.0 / x[0] - 0.1, -(x[1] / 7.0),
                            p.k / 3.0 + 0.0 * u[0], torch.abs(x[0])
                            * torch.tan(u[0])])

    def cst(p, x, u):
        return 1.5 - x[0] * p.k + u[0] / p.k

    def fin(p, x):
        return p.k / x[2] + x[3]

    model = models.Model(
        name="probe", n=4, m=1, dynamics=dyn, cost=cst, final_cost=fin,
        default_params=lambda: Params(torch.tensor(0.7), torch.tensor([-1.]),
                                      torch.tensor([1.])),
        dynamics_soa=dyn, cost_soa=cst, final_cost_soa=fin)
    text = codegen.emit_header(codegen.record(model))
    assert "custom::rdiv(2.0f, x[0])" in text
    assert "(0.100000001f)" not in text and "- 0.100000001f)" in text
    assert f"* {codegen.f32_literal(float(np.float32(1) / np.float32(7)))})" \
        in text
    assert "const float n" in text                 # p.k / 3.0
    assert "(1.5f - " in text
    assert "(u[0] / p.k[0])" in text and "(p.k[0] / x[2])" in text
    assert "dual::abs_of(x[0])" in text and "dual::tan_of(u[0])" in text
    rec = codegen.record(model)
    p = model.default_params()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(0.5, 2.0, (4, 16)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(-1, 1, (1, 16)).astype(np.float32))
    dx, c, cf = codegen.evaluate(rec, p, x, u)
    assert torch.equal(dx, dyn(p, x, u))
    assert torch.equal(c, cst(p, x, u)) and torch.equal(cf, fin(p, x))
    assert codegen.f32_literal(codegen.f32(0.1)) == "0.100000001f"
    assert codegen.f32_literal(-2.0) == "(-2.0f)"


def test_unsupported_operation_raises_naming_it():
    def dyn(p, x, u):
        return torch.stack([x[1], torch.exp(u[0]) + x[0], u[1]])

    bad = dataclasses.replace(tcm.UNICYCLE, name="unicycle_exp",
                              dynamics_soa=dyn)
    with pytest.raises(NotImplementedError, match="exp") as err:
        codegen.record(bad)
    assert "unicycle_exp" in str(err.value)

    def pow_cost(p, x, u):
        return x[0] ** 2 + u[0]

    with pytest.raises(NotImplementedError, match="unicycle_pow"):
        codegen.record(dataclasses.replace(
            tcm.UNICYCLE, name="unicycle_pow", cost_soa=pow_cost))
    # the plain versions still run such a model on the CPU (the stencils:
    # the plain dual numbers carry the recorder's functions only)
    sol = solve_batch_fused(bad, tcm.default_params(),
                            SolverConfig(deriv_mode="fd", max_iter=1,
                                         alphas=FAST_ALPHAS),
                            0.05, np.zeros((2, 3), np.float32),
                            np.zeros((4, 2), np.float32), device="cpu")
    assert np.isfinite(sol.cost.numpy()).all()


def test_plain_split_iteration_equals_merged_bitwise():
    """The plain split iteration (sweep + line search) against the plain
    whole iteration on the same inputs, for the unicycle's dual-number
    sweep with Euler and RK4 and its stencils: equal bits."""
    uni, _head = _registered()
    rng = np.random.default_rng(3)
    T, B = 6, 5
    f = lambda *s, sc=0.3: torch.from_numpy(
        (sc * rng.normal(size=s)).astype(np.float32))
    pp = kernel_rollout.pack_params(tcm.default_params(), 0.05)
    x0, us = f(3, B), f(T, 2, B, sc=1.0)
    xs, xT = f(T, 3, B), f(3, B)
    kold, Kold = f(T, 2, B), f(T, 2, 3, B)
    lam, live = torch.ones(B), (torch.arange(B) % 3 > 0).float()
    al = torch.tensor(FAST_ALPHAS)
    cprev = 100.0 + f(B)
    for integrator, mode in (("euler", "jvp"), ("rk4", "jvp"),
                             ("euler", "fd")):
        whole = kernel_iter.iteration_packed(
            uni, integrator, True, pp, x0, xs, xT, us, kold, Kold, lam,
            cprev, live, al, mode=mode, eps=0.05)
        k, K, dv, div, gnorm = kernel_iter.sweep_plain(
            uni, integrator, pp, xs, xT, us, lam, mode, True, 0.05)
        okf = 1.0 - div
        gtf = okf * (gnorm < 1e-6).float() * (lam < 1e-5).float()
        split = kernel_rollout.linesearch_packed(
            uni, integrator, True, pp, x0, us, xs, xT, K, k, Kold, kold, al,
            dv, cprev, okf * (1.0 - gtf) * live, okf * live, 0.0)
        for g, w in zip((*split, div, gnorm), whole):
            assert torch.equal(g, w), (integrator, mode)


def _no_soa():
    return dataclasses.replace(tcm.UNICYCLE, name="unicycle_aos",
                               dynamics_soa=None, cost_soa=None,
                               final_cost_soa=None)


def _jax_no_soa():
    return dataclasses.replace(jcm.UNICYCLE, name="unicycle_aos",
                               dynamics_soa=None, cost_soa=None,
                               final_cost_soa=None)


def test_model_without_soa_takes_the_xla_routes():
    """"auto" runs the "xla" derivative and rollout routes (no kernel op
    is reached) and matches JAX's solve to rtol 1e-3; "pallas" raises
    ValueError naming the missing SoA functions."""
    model = _no_soa()
    assert not model.has_soa
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=8)
    x0, u0 = np.zeros(3, np.float32), np.zeros((20, 2), np.float32)
    reset_launch_counts()
    got = solve(model, tcm.default_params(), cfg, 0.05, x0, u0,
                device="cpu")
    assert launch_counts() == {k: 0 for k in launch_counts()}
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                jcm.default_params())
    want = jax_solve(_jax_no_soa(), jp,
                     JaxConfig(deriv_mode="analytic", clamp_forward=True,
                               max_iter=8), 0.05, jnp.asarray(x0),
                     jnp.asarray(u0))
    np.testing.assert_allclose(float(got.cost), float(want.cost),
                               rtol=SOLVE_RTOL)
    assert int(got.iterations) == int(want.iterations)
    for field in ("deriv_kernel", "rollout_kernel"):
        with pytest.raises(ValueError, match="dynamics_soa"):
            solve(model, tcm.default_params(),
                  cfg.replace(**{field: "pallas"}), 0.05, x0, u0,
                  device="cpu")
    with pytest.raises(NotImplementedError, match="params_batched"):
        solve_batch(model, tcm.default_params(), cfg, 0.05, x0[None], u0,
                    device="cpu", params_batched=True)


@pytest.mark.parametrize("goal", [(2.0, 1.0, 0.0), (1.5, -0.5, 0.0)])
def test_composable_solve_reaches_the_goal_as_jax(goal):
    """The example's problem (analytic, clamped, T = 80 from rest) on the
    plain kernel routes, for the example's goal and the JAX test's."""
    uni, _head = _registered()
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True)
    x0, u0 = np.zeros(3, np.float32), np.zeros((80, 2), np.float32)
    got = solve(uni, tcm.default_params(goal), cfg, 0.05, x0, u0,
                device="cpu")
    xf = got.xs[-1].numpy()
    assert abs(xf[0] - goal[0]) < GOAL_TOL and abs(xf[1] - goal[1]) < GOAL_TOL
    want = jax_solve(jcm.UNICYCLE, jcm.default_params(goal),
                     JaxConfig(deriv_mode="analytic", clamp_forward=True),
                     0.05, jnp.asarray(x0), jnp.asarray(u0))
    np.testing.assert_allclose(float(got.cost), float(want.cost),
                               rtol=SOLVE_RTOL)


def test_backward_owner_reads_the_registry():
    """The backward kernel at n = 3 is the registered m = 1 custom model's
    (its library), found through the registry at the call; an n no model
    carries raises."""
    _uni, head = _registered()
    assert kernel_backward.backward_owner(3) is head
    assert kernel_backward.backward_owner(4) is None
    assert 3 in kernel_backward.backward_ns()
    with pytest.raises(NotImplementedError, match="n = 5"):
        kernel_backward.backward_owner(5)
    from ilqr_tpu_torch import fused

    cfg = SolverConfig(sweep_kernel="split")
    fused._check_kernels(head, cfg, torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="unicycle_copy"):
        fused._check_kernels(dataclasses.replace(head, name="unicycle_copy"),
                             cfg, torch.device("cuda"))
