"""The whole-iteration kernel of the split-route models (m·n ≥ 32), a warp
per lane (csrc/iteration_warp.cuh), against ``iteration_plain`` on the
card: thruster_ring (m = 12), thruster_ring24 (m = 24, the cap), free_flyer
(m = 8), omni_thruster (m = 6) and the quadrotor (n = 12, m = 4, the
enumeration QP), in its analytic (Euler), stencil (Euler and RK4) and
dual-number (RK4) forms, on the warp design's edge cases: a partial last
block (B not a multiple of the 4 lanes a block) with NaN in one lane's x0,
A = 1 without limits, A = 7 with every lane dead; λ is mixed so that some
lanes latch ``div``. Every test here needs a CUDA device and skips without
one.

Like tests/test_torch_cuda.py this file imports neither JAX nor ilqr_tpu;
run it there as ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_iteration_warp.py``. Kernel and plain version run the
same IEEE f32 operations in the same order (--fmad=false), so the outputs
are held bit for bit (NaNs in the same places), as chip_smoke.py holds
them.
"""

import numpy as np
import pytest
import torch

from ilqr_tpu_torch import SolverConfig, get_model
from ilqr_tpu_torch.ops import kernel_iter, kernel_rollout

T, DT = 3, 0.05
CFG = SolverConfig()
MODELS = ("thruster_ring", "thruster_ring24", "free_flyer", "omni_thruster",
          "quadrotor")
# (integrator, mode, clamp)
FORMS = {"analytic": ("euler", "jvp", True), "fd": ("euler", "fd", False),
         "fd_rk4": ("rk4", "fd", False), "jvp_rk4": ("rk4", "jvp", False)}
# B, A, live ("mixed", "dead"), the lane with NaN in x0, use_limits
CASES = {"partial_block_nan": (67, 11, "mixed", 5, True),
         "one_alpha_no_limits": (33, 1, "mixed", None, False),
         "seven_alphas_dead": (33, 7, "dead", None, True)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, name, integrator, clamp, B, A, live, nan_lane, seed):
    """The iteration's arguments after the model: x0, its open-loop
    rollout around random controls, previous gains, λ mixed over {1e-6, 1,
    10, −50} (the −50 lanes latch div) and the previous cost."""
    model = get_model(name)
    n, m = model.n, model.m
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pp = kernel_rollout.pack_params(model.default_params(), DT, dev)
    x0 = 0.3 * rng.normal(size=(n, B))
    if nan_lane is not None:
        x0[:, nan_lane] = np.nan
    scale = 2.0 if name == "quadrotor" else 0.5
    x0, us = f(x0), f(scale * rng.normal(size=(T, m, B)))
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    xs, _u, xT, c0 = kernel_rollout.rollout_plain(
        model, integrator, clamp, pp, x0, us, zeros(T, n, B),
        zeros(T, m, n, B))
    lam = f(rng.choice([1e-6, 1.0, 10.0, -50.0], size=B))
    cprev = c0 * f(rng.choice([0.99, 1.0, 1.01, 2.0], size=B))
    live = f(rng.uniform(size=B) > 0.3) if live == "mixed" else zeros(B)
    return (model, integrator, clamp, pp, x0, xs.contiguous(),
            xT.contiguous(), us, f(rng.normal(size=(T, m, B))),
            f(rng.normal(size=(T, m, n, B))), lam, cprev.contiguous(), live,
            f(CFG.alphas[:A]))


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        assert torch.equal(g[ok], w[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", MODELS)
def test_warp_iteration_matches_plain(dev, name, form, case):
    integrator, mode, clamp = FORMS[form]
    B, A, live, nan_lane, use_limits = CASES[case]
    args = _inputs(dev, name, integrator, clamp, B, A, live, nan_lane,
                   seed=sorted(CASES).index(case))
    kw = dict(mode=mode, use_limits=use_limits, z_min=CFG.z_min,
              tol_grad=CFG.tol_grad, lambda_grad_term=CFG.lambda_grad_term)
    before = kernel_iter.iteration_packed.launches
    got = kernel_iter.iteration_packed(*args, **kw)
    torch.cuda.synchronize()
    assert kernel_iter.iteration_packed.launches == before + 1
    want = kernel_iter.iteration_plain(*args, **kw)
    _equal(got, want)
    if live == "dead":   # no lane takes a step or keeps the new gains
        _equal(got[:2] + got[3:5], (args[5], args[7], args[8], args[9]))
    if nan_lane is not None:
        assert torch.isnan(got[5][nan_lane]) and got[7][nan_lane] == 0.0
