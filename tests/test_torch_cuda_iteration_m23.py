"""The whole-iteration kernel of the m = 2-3 models (double_integrator,
bicycle and power_mass: n = 4, m = 2; point_mass_3d: n = 6, m = 3) as a
team of 32 threads per lane (csrc/iteration_team.cuh at the width of a
warp) against ``iteration_plain`` on the card, bit for bit, in its analytic
(Euler), stencil (Euler and RK4) and dual-number (RK4) forms, with control
limits (the enumeration QP) and without (the Newton step), with per-lane
params, on the edge cases of the warp iteration's tests: a partial last
block (B not a multiple of the 4 lanes a block) with NaN in one lane's x0,
A = 1, A = 7 with every lane dead, and a horizon of 40 steps (more than
one block of 32 closed-form Jacobians, segments of the replay longer than
one step); λ is mixed so that some lanes latch ``div``. Every test here
needs a CUDA device and skips without one.

Like tests/test_torch_cuda.py this file imports neither JAX nor ilqr_tpu;
run it there as ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_iteration_m23.py``.
"""

import numpy as np
import pytest
import torch

from ilqr_tpu_torch import SolverConfig, get_model
from ilqr_tpu_torch.ops import kernel_iter, kernel_rollout

DT = 0.05
CFG = SolverConfig()
MODELS = ("double_integrator", "bicycle", "power_mass", "point_mass_3d")
# (integrator, mode, clamp)
FORMS = {"analytic": ("euler", "jvp", True), "fd": ("euler", "fd", False),
         "fd_rk4": ("rk4", "fd", False), "jvp_rk4": ("rk4", "jvp", False)}
# B, T, A, live ("mixed", "dead"), the lane with NaN in x0
CASES = {"partial_block_nan": (67, 3, 11, "mixed", 5),
         "one_alpha": (33, 3, 1, "mixed", None),
         "seven_alphas_dead": (33, 3, 7, "dead", None),
         "long_horizon": (37, 40, 11, "mixed", None)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def per_lane_params(model, B, rng, dev):
    """The model's default params with every leaf scaled per lane by a
    factor in [0.9, 1.1], packed one row a lane."""
    p = model.default_params()
    leaves = {}
    for f in p._fields:
        v = np.asarray(getattr(p, f), np.float32)
        s = rng.uniform(0.9, 1.1, size=(B,) + (1,) * v.ndim)
        leaves[f] = (v[None] * s).astype(np.float32)
    return kernel_rollout.pack_params_batched(type(p)(**leaves), DT, dev)


def _inputs(dev, name, integrator, clamp, B, T, A, live, nan_lane, seed):
    """The iteration's arguments after the model: per-lane params, x0, its
    open-loop rollout around random controls, previous gains, λ mixed over
    {1e-6, 1, 10, −50} (the −50 lanes latch div) and the previous cost."""
    model = get_model(name)
    n, m = model.n, model.m
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pp = per_lane_params(model, B, rng, dev)
    x0 = 0.3 * rng.normal(size=(n, B))
    if nan_lane is not None:
        x0[:, nan_lane] = np.nan
    x0, us = f(x0), f(0.5 * rng.normal(size=(T, m, B)))
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
@pytest.mark.parametrize("limits", (True, False), ids=("limits", "free"))
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", MODELS)
def test_team32_iteration_matches_plain(dev, name, form, case, limits):
    integrator, mode, clamp = FORMS[form]
    B, T, A, live, nan_lane = CASES[case]
    args = _inputs(dev, name, integrator, clamp, B, T, A, live, nan_lane,
                   seed=sorted(CASES).index(case))
    kw = dict(mode=mode, use_limits=limits, z_min=CFG.z_min,
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", MODELS)
def test_team32_iteration_is_launched(dev, name):
    """Each launcher of the four models launches the 32-thread team: 32
    threads a lane, blocks of 128 threads with no dynamic shared memory,
    at least one block an SM."""
    import ctypes

    from ilqr_tpu_torch.ops import _build

    lib = _build.library()
    ptr = ctypes.POINTER(ctypes.c_int)
    for suffix in ("", "_fd", "_jvp"):
        width = getattr(lib, f"ilqr_{name}_iteration{suffix}_lane_threads")
        width.restype = ctypes.c_int
        assert width() == 32
        occ = getattr(lib, f"ilqr_{name}_iteration{suffix}_blocks_per_sm")
        occ.argtypes, occ.restype = [ctypes.c_int, ptr, ptr], ctypes.c_int
        for limits in (1, 0):
            threads, smem = ctypes.c_int(0), ctypes.c_int(0)
            blocks = occ(limits, ctypes.byref(threads), ctypes.byref(smem))
            assert blocks >= 1 and threads.value == 128 and smem.value == 0


@pytest.mark.cuda
def test_custom_model_keeps_one_thread_iteration(dev):
    """A registered custom model outside the team's rule (n = 10, m = 3:
    m(n + 1) = 33 gain entries, more than a warp's threads; csrc/custom.cuh
    team_iteration) keeps the one-thread whole iteration and split sweep,
    and its kernel equals the plain version bit for bit; the example's
    unicycle, inside the rule, takes the 16-thread team
    (tests/test_torch_cuda_custom_team.py holds it)."""
    import ctypes

    from ilqr_tpu_torch.examples import custom_model as tcm
    from ilqr_tpu_torch.models import get_model, list_models, register
    from ilqr_tpu_torch.ops import _build
    from test_torch_custom_team import dense_model

    name = "dense_n10_m3"
    if name not in list_models():
        register(dense_model(10, 3, name))
    model = get_model(name)
    uni, _head = tcm.register_models()
    for m, want in ((model, 1), (uni, 16)):
        lib = _build.lib_for(m)
        for kind in ("iteration", "sweep"):
            for suffix in ("_fd", "_jvp"):
                width = getattr(lib, f"ilqr_{m.name}_{kind}{suffix}"
                                     "_lane_threads")
                width.restype = ctypes.c_int
                assert width() == want, (m.name, kind, suffix)
    rng = np.random.default_rng(3)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    B, T, n, k = 37, 6, model.n, model.m
    pp = kernel_rollout.pack_params(model.default_params(), DT, dev)
    x0, us = f(0.3 * rng.normal(size=(n, B))), f(0.5 * rng.normal(
        size=(T, k, B)))
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    xs, _u, xT, c0 = kernel_rollout.rollout_plain(
        model, "euler", True, pp, x0, us, zeros(T, n, B), zeros(T, k, n, B))
    args = (model, "euler", True, pp, x0, xs.contiguous(), xT.contiguous(),
            us, f(rng.normal(size=(T, k, B))),
            f(rng.normal(size=(T, k, n, B))),
            f(rng.choice([1e-6, 1.0, 10.0], size=B)), c0.contiguous(),
            f(rng.uniform(size=B) > 0.3), f(CFG.alphas))
    kw = dict(mode="jvp", use_limits=True, z_min=CFG.z_min,
              tol_grad=CFG.tol_grad, lambda_grad_term=CFG.lambda_grad_term)
    got = kernel_iter.iteration_packed(*args, **kw)
    torch.cuda.synchronize()
    _equal(got, kernel_iter.iteration_plain(*args, **kw))
