"""The merged sweep of the models with a team iteration (m·n < 32) against
``sweep_plain`` on the card: its stencil (Euler and RK4) and dual-number
(RK4) forms on the team of the model's whole iteration
(csrc/iteration_team.cuh sweep_small_team_kernel: 16 threads a lane for
acrobot, cartpole and pendulum, 32 for double_integrator, bicycle,
power_mass and point_mass_3d), its analytic (Euler) form on one thread a
lane (kernels.cuh sweep_kernel, csrc/sweep_team.cuh kSweepKind); with and
without limits, on
the team design's edge cases: a partial last block (B not a multiple of
the lanes per block), a lane with NaN in x0, λ mixed so that some lanes
latch ``div`` (a non-positive pivot), per-lane params, and T = 1. Every
test here needs a CUDA device and skips without one.

Like tests/test_torch_cuda.py this file imports neither JAX nor ilqr_tpu;
run it there as ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_sweep_small_team.py``. Kernel and plain version run
the same IEEE f32 operations in the same order (--fmad=false), so the
outputs are held bit for bit (NaNs in the same places), as chip_smoke.py
holds them.
"""

import numpy as np
import pytest
import torch

from ilqr_tpu_torch import get_model
from ilqr_tpu_torch.ops import kernel_rollout, kernel_sweep

DT = 0.05
MODELS = ("acrobot", "cartpole", "pendulum", "double_integrator", "bicycle",
          "power_mass", "point_mass_3d")
# (integrator, mode): the analytic Euler sweep, the CLI's stencils with
# Euler and RK4, analytic + RK4 (the dual numbers)
FORMS = {"analytic": ("euler", "jvp"), "fd": ("euler", "fd"),
         "fd_rk4": ("rk4", "fd"), "jvp_rk4": ("rk4", "jvp")}
# B, T, per-lane params, the lane with NaN in x0. B = 67 leaves 3 lanes in
# the last block (8 lanes a block at 16 threads a lane, 4 at 32); T = 20
# runs past one block of 16 steps of the closed forms' Jacobians; λ is
# mixed over {1e-6, 1, 10, −50} on every case (the −50 lanes have a
# non-positive pivot and latch div)
CASES = {"partial_block_nan": (67, 20, False, 5),
         "per_lane_T1": (33, 1, True, None)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, name, B, T, per_lane, nan_lane, seed):
    """sweep_packed's arguments after the model and integrator: the packed
    params (per-lane goals and limits where asked), states and controls
    drawn around the model's scale, λ mixed."""
    model = get_model(name)
    params = model.default_params()
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    n, m = model.n, model.m
    if per_lane:
        leaves = {k: np.repeat(np.asarray(v, np.float32)[None], B, 0)
                  for k, v in params._asdict().items()}
        leaves["goal"] = leaves["goal"] + 0.1 * rng.normal(size=(B, n))
        leaves["u_max"] = leaves["u_max"] * rng.uniform(
            0.5, 1.0, size=leaves["u_max"].shape)
        pp = kernel_rollout.pack_params_batched(type(params)(**leaves), DT,
                                                dev)
    else:
        pp = kernel_rollout.pack_params(params, DT, dev)
    x = 0.3 * rng.normal(size=(T + 1, n, B))
    if nan_lane is not None:
        x[0, :, nan_lane] = np.nan
    us = 0.5 * rng.normal(size=(T, m, B))
    lam = rng.choice([1e-6, 1.0, 10.0, -50.0], size=B)
    return (model, pp, f(x[:T]), f(x[T]), f(us), f(lam))


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        assert torch.equal(g[ok], w[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("limits", [True, False])
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", MODELS)
def test_small_team_sweep_matches_plain(dev, name, form, limits, case):
    integrator, mode = FORMS[form]
    B, T, per_lane, nan_lane = CASES[case]
    model, pp, xs, xT, us, lam = _inputs(
        dev, name, B, T, per_lane, nan_lane,
        seed=MODELS.index(name) * 10 + sorted(CASES).index(case))
    args = (model, integrator, pp, xs, xT, us, lam)
    kw = dict(mode=mode, use_limits=limits)
    before = kernel_sweep.sweep_packed.launches
    got = kernel_sweep.sweep_packed(*args, **kw)
    torch.cuda.synchronize()
    assert kernel_sweep.sweep_packed.launches == before + 1
    want = kernel_sweep.sweep_plain(*args, **kw)
    _equal(got, want)
    div = got[3]
    assert bool((div[lam < 0] == 1.0).any())   # a non-positive pivot latched
    assert bool((div == 0.0).any())
