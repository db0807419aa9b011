"""ilqr_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor ilqr_tpu, so it also runs where JAX is not
installed; tests/conftest.py imports JAX, so there run it as
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from ilqr_tpu_torch import (
    SolverConfig,
    get_model,
    mpc,
    solve,
    solve_batch,
    solve_batch_fused,
    solve_batch_fused_warm,
)
from ilqr_tpu_torch.models import acrobot as tac
from ilqr_tpu_torch.models import bicycle as tbc
from ilqr_tpu_torch.models import cartpole as tcp
from ilqr_tpu_torch.models import double_integrator as tdi
from ilqr_tpu_torch.models import free_flyer as tff
from ilqr_tpu_torch.models import omni_thruster as tot
from ilqr_tpu_torch.models import pendulum as tpd
from ilqr_tpu_torch.models import point_mass_3d as tpm
from ilqr_tpu_torch.models import power_mass as tpw
from ilqr_tpu_torch.models import quadrotor as tqd
from ilqr_tpu_torch.models import thruster_ring as ttr
from ilqr_tpu_torch.ops import (
    kernel_backward,
    kernel_derivs,
    kernel_iter,
    kernel_rollout,
    kernel_sweep,
    launch_counts,
    reset_launch_counts,
)

T, N, M = 7, 4, 1
ALPHAS = (1.0, 0.5, 0.1)
MODEL = tac.MODEL
# Kernel and plain version compute the same IEEE f32 operations in the same
# order (the kernels are built with --fmad=false and without fast math), so
# only the trig library (libdevice sincosf vs torch.sin/cos) could differ,
# by an ulp: 1e-5 relative over T = 7 steps.
TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, what, tol=TOL):
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape, what
    assert torch.equal(torch.isnan(got), torch.isnan(want)), what
    ok = ~torch.isnan(want)
    err = (got[ok] - want[ok]).abs() / (1.0 + want[ok].abs())
    assert err.max().item() <= tol, (what, err.max().item())


@pytest.mark.cuda
def test_kernels_match_plain(dev):
    """All four kernels at a lane count that is not a multiple of the block
    (the lane guard), with λ < 0 on some lanes (divergence latch), mixed
    live/gate/keep masks, against the plain versions on the same card."""
    b = 200
    rng = np.random.default_rng(14)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    x0 = f(0.3 * rng.normal(size=(N, b)))
    us = f(2.0 * rng.normal(size=(T, M, b)))
    xs = f(0.3 * rng.normal(size=(T, N, b)))
    xT = f(0.3 * rng.normal(size=(N, b)))
    K = f(0.1 * rng.normal(size=(T, M, N, b)))
    k = f(0.5 * rng.normal(size=(T, M, b)))
    lam = f(np.where(rng.uniform(size=b) < 0.1, -100.0, 1.0))
    live = f(rng.uniform(size=b) > 0.5)
    dv = f(np.stack([-np.abs(rng.normal(size=b)) * 5.0, rng.normal(size=b)]))
    cprev = f(4000.0 + rng.normal(size=b) * 50.0)
    gate = f(rng.uniform(size=b) > 0.5)
    al = f(ALPHAS)
    pp = kernel_rollout.pack_params(tac.default_params(), 0.02, dev)
    reset_launch_counts()
    cases = [
        (kernel_rollout.rollout_packed, kernel_rollout.rollout_plain,
         (MODEL, "euler", True, pp, x0, us, xs, K)),
        (kernel_sweep.sweep_packed, kernel_sweep.sweep_plain,
         (MODEL, "euler", pp, xs, xT, us, lam)),
        (kernel_rollout.linesearch_packed, kernel_rollout.linesearch_plain,
         (MODEL, "euler", True, pp, x0, us, xs, xT, K, k, K * 2, k * 2, al,
          dv, cprev, gate, live, 0.0)),
        (kernel_iter.iteration_packed, kernel_iter.iteration_plain,
         (MODEL, "euler", True, pp, x0, xs, xT, us, k, K, lam, cprev, live,
          al)),
    ]
    for op, plain, args in cases:
        got = op(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{op.__name__}[{i}]")
    counts = launch_counts()
    assert all(counts[op.__name__] == 1 for op, _p, _a in cases), counts


@pytest.mark.cuda
def test_kernels_reject_bad_inputs(dev):
    pp = kernel_rollout.pack_params(tac.default_params(), 0.02, dev)
    x0 = torch.zeros((N, 8), device=dev)
    u = torch.zeros((T, M, 8), device=dev)
    xs = torch.zeros((T, N, 8), device=dev)
    K = torch.zeros((T, M, N, 8), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        kernel_rollout.rollout_packed(MODEL, "euler", True, pp, x0.double(),
                                      u, xs, K)
    with pytest.raises(ValueError, match="contiguous"):
        kernel_rollout.rollout_packed(MODEL, "euler", True, pp, x0, u,
                                      xs.transpose(0, 1).contiguous()
                                      .transpose(0, 1), K)
    with pytest.raises(ValueError, match="alphas"):
        kernel_iter.iteration_packed(
            MODEL, "euler", True, pp, x0, xs, x0, u, u, K,
            torch.ones(8, device=dev), torch.ones(8, device=dev),
            torch.ones(8, device=dev), torch.ones(12, device=dev))


@pytest.mark.cuda
def test_solve_on_card_matches_plain_solve(dev):
    """A short acrobot solve through the kernels against the same solve
    through the plain versions on the CPU. The CPU's sin/cos may differ from
    the card's by an ulp, which a few iterations carry to ~1e-6: costs to
    rtol 1e-4, equal iteration counts and reasons."""
    rng = np.random.default_rng(0)
    x0 = (0.05 * rng.normal(size=(64, 4))).astype(np.float32)
    u0 = np.zeros((8, 1), np.float32)
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True, max_iter=5,
                       alphas=(1.0, 0.3, 0.03))
    m, p = get_model("acrobot"), tac.default_params()
    reset_launch_counts()
    card = solve_batch_fused(m, p, cfg, 0.02, x0, u0)
    assert card.cost.device.type == "cuda"
    plain = solve_batch_fused(m, p, cfg, 0.02, x0, u0, device="cpu")
    np.testing.assert_allclose(card.cost.cpu().numpy(), plain.cost.numpy(),
                               rtol=1e-4)
    np.testing.assert_array_equal(card.iterations.cpu().numpy(),
                                  plain.iterations.numpy())
    np.testing.assert_array_equal(card.reason.cpu().numpy(),
                                  plain.reason.numpy())
    counts = launch_counts()
    assert counts["rollout_packed"] == 1
    assert counts["iteration_packed"] >= 5


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["jvp", "fd"])
def test_derivs_kernel_matches_plain(dev, mode):
    """The derivative kernel against its plain version on the same card, at
    a lane count that is not a multiple of the block. Both evaluate the same
    dual-number rules or stencils op by op, so they agree to an ulp (fd's
    stencils would turn any ulp of the cost into ~1e-1 in cxx)."""
    b = 200
    rng = np.random.default_rng(15)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    xs = f(0.5 * rng.normal(size=(T + 1, N, b)))
    us = f(2.0 * rng.normal(size=(T, M, b)))
    pp = kernel_rollout.pack_params(tac.default_params(), 0.02, dev)
    reset_launch_counts()
    got = kernel_derivs.derivs_packed(MODEL, "euler", pp, xs, us, mode=mode)
    torch.cuda.synchronize()
    want = kernel_derivs.derivs_plain(MODEL, "euler", pp, xs, us, mode=mode)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"derivs {mode}[{i}]")
    assert launch_counts()["derivs_packed"] == 1


@pytest.mark.cuda
def test_backward_kernel_matches_plain(dev):
    """The backward kernel against its plain version on the same card, with
    clamped controls and λ < 0 on some lanes (divergence latch)."""
    b = 200
    rng = np.random.default_rng(16)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    xs = f(0.3 * rng.normal(size=(T + 1, N, b)))
    us = f(3.0 * rng.normal(size=(T, M, b)))
    pp = kernel_rollout.pack_params(tac.default_params(), 0.02, dev)
    fx, fu, cx, cu, cxx, cxu, cuu = kernel_derivs.derivs_plain(
        MODEL, "euler", pp, xs, us)
    lam = f(np.where(rng.uniform(size=b) < 0.1, -100.0, 1.0))
    args = (fx, fu[:, :, 0], cx[:-1], cu[:, 0], cxx[:-1], cxu[:, :, 0],
            cuu[:, 0, 0], -5.0 - us[:, 0], 5.0 - us[:, 0], lam, cx[-1],
            cxx[-1])
    reset_launch_counts()
    got = kernel_backward.backward_sweep_packed(*args)
    torch.cuda.synchronize()
    want = kernel_backward.backward_plain(*args)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"backward[{i}]")
    assert launch_counts()["backward_sweep_packed"] == 1
    assert got[3][lam < 0].min().item() == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["composable", "split_sweep"])
def test_stage_kernel_solves_on_card_match_cpu(dev, path):
    """solve_batch, and solve_batch_fused with sweep_kernel="split", through
    the derivative, backward and rollout / line-search kernels against the
    same solve through the plain versions on the CPU, at T = 8: costs to
    rtol 1e-4 (sin/cos ulps carried a few iterations), equal iteration
    counts and reasons."""
    rng = np.random.default_rng(0)
    x0 = (0.05 * rng.normal(size=(64, 4))).astype(np.float32)
    u0 = np.zeros((8, 1), np.float32)
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True, max_iter=5,
                       alphas=(1.0, 0.3, 0.03))
    m, p = get_model("acrobot"), tac.default_params()
    if path == "composable":
        run = lambda device=None: solve_batch(m, p, cfg, 0.02, x0, u0,
                                              device=device)
        used = ("rollout_packed", "derivs_packed", "backward_sweep_packed")
    else:
        run = lambda device=None: solve_batch_fused(
            m, p, cfg.replace(sweep_kernel="split"), 0.02, x0, u0,
            device=device)
        used = ("rollout_packed", "derivs_packed", "backward_sweep_packed",
                "linesearch_packed")
    reset_launch_counts()
    card = run()
    assert card.cost.device.type == "cuda"
    counts = launch_counts()
    plain = run("cpu")
    np.testing.assert_allclose(card.cost.cpu().numpy(), plain.cost.numpy(),
                               rtol=1e-4)
    np.testing.assert_array_equal(card.iterations.cpu().numpy(),
                                  plain.iterations.numpy())
    np.testing.assert_array_equal(card.reason.cpu().numpy(),
                                  plain.reason.numpy())
    assert all(counts[name] >= 1 for name in used), counts
    assert counts["iteration_packed"] == counts["sweep_packed"] == 0, counts


@pytest.mark.cuda
def test_single_problem_solve_on_card(dev):
    """solve runs one problem as one lane through the same kernels."""
    x0 = np.array([0.01, -0.02, 0.0, 0.03], np.float32)
    u0 = np.zeros((8, 1), np.float32)
    cfg = SolverConfig(clamp_forward=True, max_iter=5, alphas=(1.0, 0.3, 0.03))
    m, p = get_model("acrobot"), tac.default_params()
    reset_launch_counts()
    card = solve(m, p, cfg, 0.02, x0, u0)
    assert launch_counts()["derivs_packed"] >= 1
    plain = solve(m, p, cfg, 0.02, x0, u0, device="cpu")
    assert card.xs.shape == (9, 4)
    np.testing.assert_allclose(card.cost.item(), plain.cost.item(),
                               rtol=1e-4)


MODS = {"acrobot": tac, "double_integrator": tdi, "point_mass_3d": tpm,
        "quadrotor": tqd, "omni_thruster": tot, "free_flyer": tff,
        "thruster_ring": ttr, "thruster_ring24": ttr, "pendulum": tpd,
        "cartpole": tcp, "bicycle": tbc, "power_mass": tpw}
ALL_MODELS = sorted(MODS) + ["thruster_ring16", "thruster_ring20"]
# controls around which the inputs are drawn (the thrusters' boxes are
# [0, u_max]: about a third of the draws lands on the lower bound)
U_MID = {"quadrotor": 1.2, "omni_thruster": 1.0, "free_flyer": 1.0,
         "thruster_ring": 1.0, "thruster_ring24": 1.0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MODS))
@pytest.mark.parametrize("use_limits", [True, False])
def test_model_kernels_match_plain(dev, name, use_limits):
    """Each model's four kernels, the sweep and the iteration with the box
    QP (use_limits) or the Newton step, against the plain versions on the
    same card, at a lane count that is not a multiple of the block. The
    models without trig agree to the bit; 1e-5 relative covers the
    trig ulps of the others."""
    m = get_model(name)
    n, mm, b, t = m.n, m.m, 200, 9
    rng = np.random.default_rng(17)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pp = kernel_rollout.pack_params(m.default_params(), 0.02, dev)
    u_mid = U_MID.get(name, 0.0)
    x0 = f(0.3 * rng.normal(size=(n, b)))
    us = f(u_mid + 0.6 * rng.normal(size=(t, mm, b)))
    xs = f(0.3 * rng.normal(size=(t, n, b)))
    xT = f(0.3 * rng.normal(size=(n, b)))
    K = f(0.1 * rng.normal(size=(t, mm, n, b)))
    k = f(0.2 * rng.normal(size=(t, mm, b)))
    lam = f(np.where(rng.uniform(size=b) < 0.1, -100.0, 1.0))
    live = f(rng.uniform(size=b) > 0.5)
    dv = f(np.stack([-np.abs(rng.normal(size=b)) * 5.0, rng.normal(size=b)]))
    cprev = f(100.0 + rng.normal(size=b))
    al = f(ALPHAS)
    reset_launch_counts()
    cases = [
        (kernel_rollout.rollout_packed, kernel_rollout.rollout_plain,
         (m, "euler", True, pp, x0, us, xs, K)),
        (kernel_sweep.sweep_packed, kernel_sweep.sweep_plain,
         (m, "euler", pp, xs, xT, us, lam, "jvp", use_limits)),
        (kernel_rollout.linesearch_packed, kernel_rollout.linesearch_plain,
         (m, "euler", True, pp, x0, us, xs, xT, K, k, K * 2, k * 2, al, dv,
          cprev, live, live, 0.0)),
        (kernel_iter.iteration_packed, kernel_iter.iteration_plain,
         (m, "euler", True, pp, x0, xs, xT, us, k, K, lam, cprev, live, al,
          "jvp", use_limits)),
    ]
    for op, plain, args in cases:
        got = op(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{name} {op.__name__}[{i}]")
    counts = launch_counts()
    assert all(counts[op.__name__] == 1 for op, _p, _a in cases), counts


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["double_integrator", "point_mass_3d",
                                  "quadrotor", "omni_thruster", "free_flyer",
                                  "thruster_ring", "pendulum", "cartpole",
                                  "bicycle", "power_mass"])
def test_model_solve_on_card_matches_plain_solve(dev, name):
    """A short solve of each model through the kernels against the same
    solve through the plain versions on the CPU: costs to rtol 1e-4, equal
    iteration counts and reasons."""
    m = get_model(name)
    p = m.default_params()
    rng = np.random.default_rng(0)
    x0 = (0.3 * rng.normal(size=(64, m.n))).astype(np.float32)
    u0 = (np.tile(MODS[name].hover_control(p).numpy()[None], (8, 1))
          if name in ("quadrotor", "omni_thruster")
          else np.zeros((8, m.m), np.float32))
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True, max_iter=5,
                       alphas=(1.0, 0.3, 0.03))
    reset_launch_counts()
    card = solve_batch_fused(m, p, cfg, 0.02, x0, u0)
    counts = launch_counts()
    plain = solve_batch_fused(m, p, cfg, 0.02, x0, u0, device="cpu")
    np.testing.assert_allclose(card.cost.cpu().numpy(), plain.cost.numpy(),
                               rtol=1e-4)
    np.testing.assert_array_equal(card.iterations.cpu().numpy(),
                                  plain.iterations.numpy())
    np.testing.assert_array_equal(card.reason.cpu().numpy(),
                                  plain.reason.numpy())
    route = ("sweep_packed" if m.m * m.n >= 32 else "iteration_packed")
    assert counts["rollout_packed"] == 1 and counts[route] >= 5, counts


@pytest.mark.cuda
@pytest.mark.parametrize("name", ALL_MODELS)
@pytest.mark.parametrize("integrator", ["euler", "rk4"])
def test_model_fd_and_rk4_kernels_match_plain(dev, name, integrator):
    """Each model's stencil sweep and iteration kernels (mode="fd", with
    and without limits) and its rollout and line search with the
    ``integrator`` step, against the plain versions on the same card, at a
    lane count that is not a multiple of the block. Both sides evaluate the
    same stencils op by op (one ulp of a cost would move cxx by ~1e-1 at
    eps = 1e-3, so any drift shows); held to 1e-4 relative, expected 0."""
    m = get_model(name)
    n, mm, b, t = m.n, m.m, 200, 5
    rng = np.random.default_rng(18)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pp = kernel_rollout.pack_params(m.default_params(), 0.02, dev)
    u_mid = U_MID.get(name, 1.0 if "ring" in name else 0.0)
    x0 = f(0.3 * rng.normal(size=(n, b)))
    us = f(u_mid + 0.6 * rng.normal(size=(t, mm, b)))
    xs = f(0.3 * rng.normal(size=(t, n, b)))
    xT = f(0.3 * rng.normal(size=(n, b)))
    K = f(0.1 * rng.normal(size=(t, mm, n, b)))
    k = f(0.2 * rng.normal(size=(t, mm, b)))
    lam = f(np.where(rng.uniform(size=b) < 0.1, -100.0, 1.0))
    live = f(rng.uniform(size=b) > 0.5)
    dv = f(np.stack([-np.abs(rng.normal(size=b)) * 5.0, rng.normal(size=b)]))
    cprev = f(100.0 + rng.normal(size=b))
    al = f(ALPHAS)
    reset_launch_counts()
    cases = [
        (kernel_rollout.rollout_packed, kernel_rollout.rollout_plain,
         (m, integrator, True, pp, x0, us, xs, K)),
        (kernel_rollout.linesearch_packed, kernel_rollout.linesearch_plain,
         (m, integrator, True, pp, x0, us, xs, xT, K, k, K * 2, k * 2, al,
          dv, cprev, live, live, 0.0)),
    ]
    for limits in (True, False):
        cases += [
            (kernel_sweep.sweep_packed, kernel_sweep.sweep_plain,
             (m, integrator, pp, xs, xT, us, lam, "fd", limits)),
            (kernel_iter.iteration_packed, kernel_iter.iteration_plain,
             (m, integrator, limits, pp, x0, xs, xT, us, k, K, lam, cprev,
              live, al, "fd", limits)),
        ]
    for op, plain, args in cases:
        got = op(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{name} {integrator} {op.__name__}[{i}]", tol=1e-4)
    counts = launch_counts()
    assert counts["rollout_packed"] == counts["linesearch_packed"] == 1
    assert counts["sweep_packed"] == counts["iteration_packed"] == 2, counts


@pytest.mark.cuda
@pytest.mark.parametrize("name,integrator", [("power_mass", "euler"),
                                             ("double_integrator", "rk4"),
                                             ("acrobot", "rk4")])
def test_fd_solve_on_card_matches_plain_solve(dev, name, integrator):
    """A short fd solve through the stencil kernels against the same solve
    through the plain versions on the CPU. power_mass and the double
    integrator have no trig, so the two agree to the bit; acrobot's sin/cos
    may differ by an ulp between the CPU and the card, which the stencils
    scale by 1/(4·eps²): its costs are held to rtol 1e-3."""
    m = get_model(name)
    p = m.default_params()
    rng = np.random.default_rng(0)
    x0 = (0.05 * rng.normal(size=(64, m.n))).astype(np.float32)
    u0 = np.zeros((8, m.m), np.float32)
    cfg = SolverConfig(deriv_mode="fd", integrator=integrator, max_iter=5,
                       alphas=(1.0, 0.3, 0.03))
    reset_launch_counts()
    card = solve_batch_fused(m, p, cfg, 0.02, x0, u0)
    counts = launch_counts()
    plain = solve_batch_fused(m, p, cfg, 0.02, x0, u0, device="cpu")
    if name == "acrobot":
        np.testing.assert_allclose(card.cost.cpu().numpy(),
                                   plain.cost.numpy(), rtol=1e-3)
    else:
        np.testing.assert_array_equal(card.cost.cpu().numpy(),
                                      plain.cost.numpy())
        np.testing.assert_array_equal(card.iterations.cpu().numpy(),
                                      plain.iterations.numpy())
    assert counts["rollout_packed"] == 1 and counts["iteration_packed"] >= 5


@pytest.mark.cuda
@pytest.mark.parametrize("name", ALL_MODELS)
def test_model_jvp_kernels_match_plain(dev, name):
    """Each model's dual-number sweep and iteration kernels (mode="jvp"
    with the RK4 step: exact derivatives through every stage, with and
    without limits) against the plain versions on the same card, at a lane
    count that is not a multiple of the block. Both sides run the same
    dual-number rules op by op; held to 1e-4 relative, expected 0."""
    m = get_model(name)
    n, mm, b, t = m.n, m.m, 200, 5
    rng = np.random.default_rng(19)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pp = kernel_rollout.pack_params(m.default_params(), 0.02, dev)
    u_mid = U_MID.get(name, 1.0 if "ring" in name else 0.0)
    x0 = f(0.3 * rng.normal(size=(n, b)))
    us = f(u_mid + 0.6 * rng.normal(size=(t, mm, b)))
    xs = f(0.3 * rng.normal(size=(t, n, b)))
    xT = f(0.3 * rng.normal(size=(n, b)))
    K = f(0.1 * rng.normal(size=(t, mm, n, b)))
    k = f(0.2 * rng.normal(size=(t, mm, b)))
    lam = f(np.where(rng.uniform(size=b) < 0.1, -100.0, 1.0))
    live = f(rng.uniform(size=b) > 0.5)
    cprev = f(100.0 + rng.normal(size=b))
    al = f(ALPHAS)
    reset_launch_counts()
    for limits in (True, False):
        for op, plain, args in (
                (kernel_sweep.sweep_packed, kernel_sweep.sweep_plain,
                 (m, "rk4", pp, xs, xT, us, lam, "jvp", limits)),
                (kernel_iter.iteration_packed, kernel_iter.iteration_plain,
                 (m, "rk4", limits, pp, x0, xs, xT, us, k, K, lam, cprev,
                  live, al, "jvp", limits))):
            got = op(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            for i, (g, w) in enumerate(zip(got, want)):
                _close(g, w, f"{name} jvp {op.__name__}[{i}]", tol=1e-4)
    counts = launch_counts()
    assert counts["sweep_packed"] == counts["iteration_packed"] == 2, counts


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["acrobot", "pendulum", "cartpole"])
@pytest.mark.parametrize("integrator", ["euler", "rk4"])
def test_split_kernels_match_plain(dev, name, integrator):
    """The derivative kernel of each split-sweep model (jvp and fd modes,
    the ``integrator`` step) and the backward kernel at the model's n (2
    for pendulum, 4 otherwise) on its derivatives, against the plain
    versions on the same card; held to 1e-4 relative, expected 0."""
    m = get_model(name)
    n, b, t = m.n, 200, 6
    rng = np.random.default_rng(20)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pp = kernel_rollout.pack_params(m.default_params(), 0.02, dev)
    xs = f(0.4 * rng.normal(size=(t + 1, n, b)))
    us = f(2.0 * rng.normal(size=(t, 1, b)))
    reset_launch_counts()
    for mode in ("jvp", "fd"):
        args = (m, integrator, pp, xs, us, mode)
        got = kernel_derivs.derivs_packed(*args)
        torch.cuda.synchronize()
        want = kernel_derivs.derivs_plain(*args)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{name} {integrator} {mode} derivs[{i}]", tol=1e-4)
        fx, fu, cx, cu, cxx, cxu, cuu = got
        p, _dt = kernel_rollout.unpack_params(pp)
        lam = f(np.where(rng.uniform(size=b) < 0.1, -100.0, 1.0))
        bargs = tuple(a.contiguous() for a in (
            fx, fu[:, :, 0], cx[:-1], cu[:, 0], cxx[:-1], cxu[:, :, 0],
            cuu[:, 0, 0], p.u_min[0] - us[:, 0], p.u_max[0] - us[:, 0], lam,
            cx[-1], cxx[-1]))
        got = kernel_backward.backward_sweep_packed(*bargs)
        torch.cuda.synchronize()
        want = kernel_backward.backward_plain(*bargs)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{name} {integrator} {mode} backward[{i}]",
                   tol=1e-4)
    counts = launch_counts()
    assert counts["derivs_packed"] == counts["backward_sweep_packed"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("name,extra", [
    ("acrobot", {}), ("omni_thruster", {}),
    ("pendulum", dict(sweep_kernel="split")),
    ("cartpole", dict(sweep_kernel="split", integrator="euler"))])
def test_jvp_and_split_solves_on_card_match_plain_solve(dev, name, extra):
    """Short solves with deriv_mode="analytic" and RK4 (the JVP route;
    pendulum on the split sweep) and cartpole's split sweep with the Euler
    step, through the kernels, against the same solves through the plain
    versions on the CPU: costs to rtol 1e-3 (the CPU's sin/cos may differ
    by an ulp; exact derivatives keep that at ulps, where the stencils of
    the fd mode would scale it by 1/(4·eps²))."""
    m = get_model(name)
    p = m.default_params()
    rng = np.random.default_rng(0)
    x0 = (0.05 * rng.normal(size=(64, m.n))).astype(np.float32)
    u0 = np.tile(np.asarray(U_MID.get(name, 0.0), np.float32),
                 (8, m.m)) if name == "omni_thruster" else np.zeros(
                     (8, m.m), np.float32)
    cfg = SolverConfig(**{**dict(deriv_mode="analytic", integrator="rk4",
                                 max_iter=5, alphas=(1.0, 0.3, 0.03)),
                          **extra})
    reset_launch_counts()
    card = solve_batch_fused(m, p, cfg, 0.02, x0, u0)
    counts = launch_counts()
    plain = solve_batch_fused(m, p, cfg, 0.02, x0, u0, device="cpu")
    np.testing.assert_allclose(card.cost.cpu().numpy(), plain.cost.numpy(),
                               rtol=1e-3)
    assert counts["rollout_packed"] == 1
    if extra.get("sweep_kernel") == "split":
        assert counts["derivs_packed"] >= 5
    else:
        assert counts["iteration_packed"] + counts["sweep_packed"] >= 5


def _per_lane_params(name, b, seed):
    """``name``'s default params with every leaf drawn per lane (× U(0.8,
    1.2)) and, where the box has a lower bound below zero, an asymmetric
    box per lane: a params NamedTuple of (b, …) tensors."""
    p = get_model(name).default_params()
    rng = np.random.default_rng(seed)
    leaves = {f: torch.as_tensor(
        np.asarray(getattr(p, f), np.float32)[None]
        * rng.uniform(0.8, 1.2, size=(b,) + tuple(getattr(p, f).shape)),
        dtype=torch.float32) for f in p._fields}
    return type(p)(**leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pendulum", "free_flyer", "acrobot"])
def test_per_lane_kernels_match_plain(dev, name):
    """The per-lane params mode (one row of the packed params per lane) of
    the rollout, sweep, line-search, iteration and (for the split sweep's
    models) derivative kernels against their plain versions on the card;
    rows equal across the lanes give the shared kernels' outputs bit for
    bit."""
    m = get_model(name)
    n, mm, b = m.n, m.m, 200
    rng = np.random.default_rng(21)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    u_mid = U_MID.get(name, 0.0)
    x0 = f(0.3 * rng.normal(size=(n, b)))
    us = f(u_mid + rng.normal(size=(T, mm, b)))
    xs = f(0.3 * rng.normal(size=(T, n, b)))
    xT = f(0.3 * rng.normal(size=(n, b)))
    K = f(0.1 * rng.normal(size=(T, mm, n, b)))
    k = f(0.5 * rng.normal(size=(T, mm, b)))
    lam = f(np.where(rng.uniform(size=b) < 0.2, 1e-3, 1.0))
    cprev = f(100.0 + rng.normal(size=b))
    mask = f(rng.uniform(size=b) > 0.5)
    al = f(ALPHAS)
    dv = torch.stack([-f(np.abs(rng.normal(size=b))), f(rng.normal(size=b))])
    per_lane = kernel_rollout.pack_params_batched(
        _per_lane_params(name, b, 3), 0.02, dev)
    p0 = get_model(name).default_params()
    shared = kernel_rollout.pack_params(p0, 0.02, dev)
    rows = kernel_rollout.pack_params_batched(
        type(p0)(*[v[None].expand((b,) + tuple(v.shape)) for v in p0]), 0.02,
        dev)

    def ops(pp):
        out = {
            "rollout": (kernel_rollout.rollout_packed, kernel_rollout
                        .rollout_plain, (m, "rk4", True, pp, x0, us, xs, K)),
            "sweep": (kernel_sweep.sweep_packed, kernel_sweep.sweep_plain,
                      (m, "euler", pp, xs, xT, us, lam)),
            "linesearch": (kernel_rollout.linesearch_packed,
                           kernel_rollout.linesearch_plain,
                           (m, "euler", True, pp, x0, us, xs, xT, K, k, K, k,
                            al, dv, cprev, mask, mask, 0.0)),
            "iteration": (kernel_iter.iteration_packed,
                          kernel_iter.iteration_plain,
                          (m, "euler", True, pp, x0, xs, xT, us, k, K, lam,
                           cprev, mask, al)),
        }
        if name in kernel_derivs.DERIVS_KERNEL_MODELS:
            out["derivs"] = (kernel_derivs.derivs_packed,
                             kernel_derivs.derivs_plain,
                             (m, "rk4", pp, torch.cat([xs, xT[None]]), us,
                              "fd"))
        return out

    for op, (kernel, plain, args) in ops(per_lane).items():
        reset_launch_counts()
        got = kernel(*args)
        assert launch_counts()[kernel.__name__] == 1, op
        for i, (g, w) in enumerate(zip(got, plain(*args))):
            _close(g, w, f"{name} {op} output {i}")
    shared_ops, rows_ops = ops(shared), ops(rows)
    for op, (kernel, _plain, args) in shared_ops.items():
        for g, w in zip(kernel(*rows_ops[op][2]), kernel(*args)):
            assert torch.equal(torch.isnan(g), torch.isnan(w)), op
            assert torch.equal(g.nan_to_num(), w.nan_to_num()), op


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["whole-iteration", "split iteration",
                                   "split sweep"])
def test_batched_and_warm_solves_on_card_match_cpu(dev, route):
    """Per-problem goals and boxes (pendulum) and a warm re-solve from the
    moved states, through the kernels, against the same solves through
    the plain versions on the CPU: costs to rtol 1e-3 (sin/cos ulps)."""
    m = get_model("pendulum")
    b = 64
    rng = np.random.default_rng(2)
    p = _per_lane_params("pendulum", b, 4)
    p = p._replace(goal=torch.as_tensor(np.stack(
        [rng.uniform(-3.0, 3.0, b), np.zeros(b)], 1), dtype=torch.float32),
        u_min=-torch.full((b, 1), 8.0), u_max=torch.full((b, 1), 8.0))
    extra = {"whole-iteration": {}, "split iteration":
             dict(iter_kernel="split"), "split sweep":
             dict(sweep_kernel="split")}[route]
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=6, alphas=(1.0, 0.3, 0.03), **extra)
    x0 = (0.1 * rng.normal(size=(b, 2))).astype(np.float32)
    u0 = np.zeros((20, 1), np.float32)
    reset_launch_counts()
    card = solve_batch_fused(m, p, cfg, 0.05, x0, u0, params_batched=True)
    assert launch_counts()["rollout_packed"] == 1
    cpu = solve_batch_fused(m, p, cfg, 0.05, x0, u0, device="cpu",
                            params_batched=True)
    np.testing.assert_allclose(card.cost.cpu().numpy(), cpu.cost.numpy(),
                               rtol=1e-3)
    shared = m.default_params()
    x1 = x0 + np.float32(0.02)
    cold = solve_batch_fused(m, shared, cfg, 0.05, x0, u0)
    cold_cpu = solve_batch_fused(m, shared, cfg, 0.05, x0, u0, device="cpu")
    reset_launch_counts()
    warm = solve_batch_fused_warm(m, shared, cfg, 0.05, x1, cold)
    assert launch_counts()["rollout_packed"] == 1
    warm_cpu = solve_batch_fused_warm(m, shared, cfg, 0.05, x1, cold_cpu,
                                      device="cpu")
    np.testing.assert_allclose(warm.cost.cpu().numpy(),
                               warm_cpu.cost.numpy(), rtol=1e-3)


@pytest.mark.cuda
def test_fleet_mpc_on_card_matches_cpu(dev):
    """fleet_init and two fleet_step replans of an acrobot fleet (the
    secondary bench's fleet MPC at B = 64, T = 30) on the card against the
    CPU: states to 1e-4, costs to rtol 1e-3."""
    m = get_model("acrobot")
    p = m.default_params()
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True,
                       max_iter=5, alphas=(1.0, 0.3, 0.03))
    x0 = (0.05 * np.random.default_rng(3).normal(size=(64, 4))).astype(
        np.float32)
    u0 = np.zeros((30, 1), np.float32)
    card = mpc.fleet_init(m, p, cfg, 0.02, x0, u0)
    cpu = mpc.fleet_init(m, p, cfg, 0.02, x0, u0, device="cpu")
    for _ in range(2):
        card = mpc.fleet_step(m, p, cfg, 0.02, card)
        cpu = mpc.fleet_step(m, p, cfg, 0.02, cpu)
        np.testing.assert_allclose(card.x.cpu().numpy(), cpu.x.numpy(),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(card.plan.cost.cpu().numpy(),
                                   cpu.plan.cost.numpy(), rtol=1e-3)
    assert card.x.device.type == "cuda" and int(card.t[0]) == 2


COMPOSABLE_MODELS = ("double_integrator", "point_mass_3d", "quadrotor",
                     "bicycle", "power_mass", "omni_thruster", "free_flyer",
                     "thruster_ring", "thruster_ring16", "thruster_ring20",
                     "thruster_ring24")


@pytest.mark.cuda
@pytest.mark.parametrize("name", COMPOSABLE_MODELS)
def test_derivs_kernel_of_every_model_matches_plain(dev, name):
    """derivs_packed of the m ≥ 2 models (one csrc/derivs_<model>.cu each)
    in jvp and fd mode with the Euler and RK4 steps, shared and per-lane
    params, against the plain version on the same card; held to 1e-4
    relative, expected 0."""
    m = get_model(name)
    n, b, t = m.n, 160, 5
    rng = np.random.default_rng(21)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    params = m.default_params()
    pp = kernel_rollout.pack_params(params, 0.02, dev)
    lanes = type(params)(*[
        np.asarray(v, np.float32)[None] * rng.uniform(
            0.8, 1.2, size=(b,) + tuple(np.shape(v))).astype(np.float32)
        for v in params])
    ppl = kernel_rollout.pack_params_batched(lanes, 0.02, dev)
    xs = f(0.4 * rng.normal(size=(t + 1, n, b)))
    us = f(rng.normal(size=(t, m.m, b)))
    reset_launch_counts()
    runs = 0
    for packed in (pp, ppl):
        for integrator in ("euler", "rk4"):
            for mode in ("jvp", "fd"):
                args = (m, integrator, packed, xs, us, mode)
                got = kernel_derivs.derivs_packed(*args)
                torch.cuda.synchronize()
                want = kernel_derivs.derivs_plain(*args)
                runs += 1
                for i, (g, w) in enumerate(zip(got, want)):
                    _close(g, w, f"{name} {integrator} {mode} [{i}]",
                           tol=1e-4)
    assert launch_counts()["derivs_packed"] == runs


@pytest.mark.cuda
@pytest.mark.parametrize("name", COMPOSABLE_MODELS)
def test_composable_solve_on_card_matches_cpu(dev, name):
    """A short composable solve (solve_batch: the derivative and rollout
    kernels, the backward scan's QPs in plain PyTorch) on the card against
    the same solve on the CPU: costs to 1e-3 relative (the trig ulps and
    cuBLAS's rounding of the QPs' matrix products)."""
    m = get_model(name)
    rng = np.random.default_rng(22)
    x0 = (0.3 * rng.normal(size=(4, m.n))).astype(np.float32)
    u0 = np.zeros((8, m.m), np.float32)
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True, max_iter=3)
    reset_launch_counts()
    card = solve_batch(m, m.default_params(), cfg, 0.05, x0, u0)
    counts = launch_counts()
    cpu = solve_batch(m, m.default_params(), cfg, 0.05, x0, u0,
                      device="cpu")
    assert counts["derivs_packed"] >= 1 and counts["rollout_packed"] >= 2
    np.testing.assert_allclose(card.cost.cpu().numpy(), cpu.cost.numpy(),
                               rtol=1e-3)


def _bitwise(got, want, what):
    """Equal bits, NaNs in the same places."""
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape, what
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    assert bool(same.all()), (what, float((got - want).abs().nan_to_num()
                                          .max()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["unicycle", "unicycle_heading"])
@pytest.mark.parametrize("integrator", ["euler", "rk4"])
def test_custom_model_kernels_match_plain(dev, name, integrator):
    """A registered custom model (ilqr_tpu_torch/examples/custom_model.py):
    its library is generated and built at first use, and one launch of
    each of its kernels — the rollout and line search, the dual-number and
    stencil sweep and iteration, the derivative kernel in both modes and,
    at m = 1, the backward kernel at n = 3 — equals its plain version on
    the same card bit for bit."""
    from ilqr_tpu_torch.examples import custom_model as tcm

    uni, head = tcm.register_models()
    m = uni if name == "unicycle" else head
    n, mm, b, t = m.n, m.m, 200, 6
    rng = np.random.default_rng(23)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pp = kernel_rollout.pack_params(m.default_params(), 0.05, dev)
    x0 = f(0.5 * rng.normal(size=(n, b)))
    us = f(1.5 * rng.normal(size=(t, mm, b)))
    xs = f(0.5 * rng.normal(size=(t, n, b)))
    xT = f(0.5 * rng.normal(size=(n, b)))
    K = f(0.1 * rng.normal(size=(t, mm, n, b)))
    k = f(0.2 * rng.normal(size=(t, mm, b)))
    lam = f(np.where(rng.uniform(size=b) < 0.1, -100.0, 1.0))
    live = f(rng.uniform(size=b) > 0.5)
    cprev = f(100.0 + rng.normal(size=b))
    al = f(ALPHAS)
    dv = torch.stack([-torch.ones(b, device=dev),
                      0.1 * torch.ones(b, device=dev)])
    xs_full = torch.cat([xs, xT[None]]).contiguous()
    cases = [
        (kernel_rollout.rollout_packed, kernel_rollout.rollout_plain,
         (m, integrator, True, pp, x0, us, xs, K)),
        (kernel_rollout.linesearch_packed, kernel_rollout.linesearch_plain,
         (m, integrator, True, pp, x0, us, xs, xT, K, k, K, k, al, dv, cprev,
          live, live, 0.0))]
    for mode in ("jvp", "fd"):
        cases += [
            (kernel_sweep.sweep_packed, kernel_sweep.sweep_plain,
             (m, integrator, pp, xs, xT, us, lam, mode, True, 0.05)),
            (kernel_iter.iteration_packed, kernel_iter.iteration_plain,
             (m, integrator, True, pp, x0, xs, xT, us, k, K, lam, cprev,
              live, al, mode, True, 0.0, 1e-6, 1e-5, 0.05)),
            (kernel_derivs.derivs_packed, kernel_derivs.derivs_plain,
             (m, integrator, pp, xs_full, us, mode, 0.05))]
    reset_launch_counts()
    for op, plain, args in cases:
        got = op(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        for i, (g, w) in enumerate(zip(got, want)):
            _bitwise(g, w, f"{name} {integrator} {op.__name__}[{i}]")
    counts = launch_counts()
    assert counts["rollout_packed"] == counts["linesearch_packed"] == 1
    assert counts["sweep_packed"] == counts["iteration_packed"] == 2
    assert counts["derivs_packed"] == 2
    if mm == 1:
        fx, fu, cx, cu, cxx, cxu, cuu = kernel_derivs.derivs_packed(
            m, integrator, pp, xs_full, us)
        p, _dt = kernel_rollout.unpack_params(pp)
        bargs = tuple(a.contiguous() for a in (
            fx, fu[:, :, 0], cx[:-1], cu[:, 0], cxx[:-1], cxu[:, :, 0],
            cuu[:, 0, 0], p.u_min[0] - us[:, 0], p.u_max[0] - us[:, 0], lam,
            cx[-1], cxx[-1]))
        got = kernel_backward.backward_sweep_packed(*bargs)
        torch.cuda.synchronize()
        want = kernel_backward.backward_plain(*bargs)
        for i, (g, w) in enumerate(zip(got, want)):
            _bitwise(g, w, f"{name} {integrator} backward[{i}]")
        assert launch_counts()["backward_sweep_packed"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    dict(), dict(integrator="rk4"), dict(deriv_mode="fd", fd_eps=0.05),
    dict(iter_kernel="split")])
def test_custom_model_solves_on_card_match_plain(dev, extra):
    """The unicycle fleet through solve_batch_fused on the card (its
    library's kernels) against the same solve through the plain versions on
    the CPU: costs to rtol 1e-3 (the trig libraries' ulps)."""
    from ilqr_tpu_torch.examples import custom_model as tcm

    uni, _head = tcm.register_models()
    rng = np.random.default_rng(0)
    x0 = (0.2 * rng.normal(size=(64, 3))).astype(np.float32)
    u0 = np.zeros((20, 2), np.float32)
    cfg = SolverConfig(**{**dict(deriv_mode="analytic", clamp_forward=True,
                                 max_iter=6, alphas=(1.0, 0.3, 0.03)),
                          **extra})
    reset_launch_counts()
    card = solve_batch_fused(uni, tcm.default_params(), cfg, 0.05, x0, u0)
    counts = launch_counts()
    assert counts["rollout_packed"] == 1
    assert counts["iteration_packed"] + counts["sweep_packed"] >= 6
    cpu = solve_batch_fused(uni, tcm.default_params(), cfg, 0.05, x0, u0,
                            device="cpu")
    np.testing.assert_allclose(card.cost.cpu().numpy(), cpu.cost.numpy(),
                               rtol=1e-3)
