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
    solve,
    solve_batch,
    solve_batch_fused,
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
