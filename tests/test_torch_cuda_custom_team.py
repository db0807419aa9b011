"""The custom models' team kernels against their plain versions on the card,
bit for bit: the line search (csrc/linesearch_team.cuh, 16 threads a
lane), the whole iteration and the split sweep of the stencils and dual
numbers (csrc/iteration_team.cuh ``iteration_team_kernel`` and
``sweep_small_team_kernel``) of the example's unicycle (n = 3, m = 2) and
unicycle_heading (n = 3, m = 1), 16 threads a lane, and of a dense model
registered here (tests/test_torch_custom_team.py ``dense_model``, n = 4,
m = 2), 32 threads a lane. Each library is built from the model's
generated header (ops/codegen.py), whose Params hold arrays where the
package's models hold scalars.

Cases: a partial last block (B not a multiple of the 8 or 4 lanes a
block) with NaN in one lane's x0, A = 1, A = 7 with every lane dead, every
lane dead at A = 11, T = 1, a horizon of 40 steps (the replay in segments),
limits on and off, λ mixed so that some lanes latch ``div``, and per-lane
params. Every test here needs a CUDA device and skips without one.

Like tests/test_torch_cuda.py this file imports neither JAX nor ilqr_tpu;
run it there as ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_custom_team.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from ilqr_tpu_torch import SolverConfig
from ilqr_tpu_torch.ops import _build, kernel_iter, kernel_rollout, kernel_sweep
from test_torch_custom_team import dense_model

DT = 0.05
CFG = SolverConfig()
# model: threads a lane of its whole iteration and dense split sweep
MODELS = {"unicycle": 16, "unicycle_heading": 16, "dense_n4_m2": 32}
# (integrator, mode)
FORMS = {"fd": ("euler", "fd"), "fd_rk4": ("rk4", "fd"),
         "jvp": ("euler", "jvp"), "jvp_rk4": ("rk4", "jvp")}
# B, T, A, live ("mixed", "dead"), the lane with NaN in x0
CASES = {"partial_block_nan": (67, 5, 11, "mixed", 5),
         "one_alpha": (33, 5, 1, "mixed", None),
         "seven_alphas_dead": (33, 5, 7, "dead", None),
         "all_dead": (24, 5, 11, "dead", None),
         "T1": (24, 1, 11, "mixed", None),
         "long_horizon": (37, 40, 11, "mixed", None)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _model(name):
    """The registered custom model ``name`` (registered at first use)."""
    from ilqr_tpu_torch.examples import custom_model as tcm
    from ilqr_tpu_torch.models import get_model, list_models, register

    if name == "dense_n4_m2":
        if name not in list_models():
            register(dense_model(4, 2, name))
        return get_model(name)
    return dict(zip(("unicycle", "unicycle_heading"),
                    tcm.register_models()))[name]


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


def _trajectory(dev, model, integrator, clamp, B, T, nan_lane, rng):
    """Per-lane params, x0 (NaN in one lane where asked) and its open-loop
    rollout around random controls."""
    n, m = model.n, model.m
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
    return pp, x0, us, xs.contiguous(), xT.contiguous(), c0, f


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        assert torch.equal(g[ok], w[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("clamp", (True, False), ids=("clamped", "free"))
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("integrator", ("euler", "rk4"))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_custom_team_linesearch_matches_plain(dev, name, integrator, case,
                                              clamp):
    model = _model(name)
    n, m = model.n, model.m
    B, T, A, gates, nan_lane = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    pp, x0, us, xs, xT, c0, f = _trajectory(dev, model, integrator, clamp,
                                            B, T, nan_lane, rng)
    dv = f(np.stack([-10.0 * np.abs(rng.normal(size=B)),
                     np.abs(rng.normal(size=B))]))
    cprev = (c0 * f(rng.choice([0.9, 1.0, 1.1, 2.0], size=B))).contiguous()
    if gates == "mixed":
        gate, keep = (f(rng.uniform(size=B) > 0.3),
                      f(rng.uniform(size=B) > 0.5))
    else:
        gate = keep = torch.zeros(B, device=dev)
    args = (model, integrator, clamp, pp, x0, us, xs, xT,
            f(0.1 * rng.normal(size=(T, m, n, B))),
            f(0.3 * rng.normal(size=(T, m, B))),
            f(rng.normal(size=(T, m, n, B))), f(rng.normal(size=(T, m, B))),
            f(CFG.alphas[:A]), dv, cprev, gate, keep, CFG.z_min)
    before = kernel_rollout.linesearch_packed.launches
    got = kernel_rollout.linesearch_packed(*args)
    torch.cuda.synchronize()
    assert kernel_rollout.linesearch_packed.launches == before + 1
    _equal(got, kernel_rollout.linesearch_plain(*args))
    if gates == "dead":   # the current state and the previous gains
        _equal(got[:5], (args[6], args[5], args[7], args[11], args[10]))
    if nan_lane is not None:
        assert torch.isnan(got[5][nan_lane]) and got[7][nan_lane] == 0.0


def _sweep_inputs(dev, model, integrator, clamp, B, T, nan_lane, rng):
    """_trajectory's and λ mixed over {1e-6, 1, 10, −50}: the −50 lanes
    latch div."""
    pp, x0, us, xs, xT, c0, f = _trajectory(dev, model, integrator, clamp, B,
                                            T, nan_lane, rng)
    lam = f(rng.choice([1e-6, 1.0, 10.0, -50.0], size=B))
    return pp, x0, us, xs, xT, c0, lam, f


@pytest.mark.cuda
@pytest.mark.parametrize("limits", (True, False), ids=("limits", "free"))
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_custom_team_iteration_matches_plain(dev, name, form, case, limits):
    model = _model(name)
    n, m = model.n, model.m
    integrator, mode = FORMS[form]
    B, T, A, live, nan_lane = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    pp, x0, us, xs, xT, c0, lam, f = _sweep_inputs(
        dev, model, integrator, limits, B, T, nan_lane, rng)
    cprev = (c0 * f(rng.choice([0.99, 1.0, 1.01, 2.0], size=B))).contiguous()
    live = (f(rng.uniform(size=B) > 0.3) if live == "mixed"
            else torch.zeros(B, device=dev))
    args = (model, integrator, limits, pp, x0, xs, xT, us,
            f(rng.normal(size=(T, m, B))), f(rng.normal(size=(T, m, n, B))),
            lam, cprev, live, f(CFG.alphas[:A]))
    kw = dict(mode=mode, use_limits=limits, z_min=CFG.z_min,
              tol_grad=CFG.tol_grad, lambda_grad_term=CFG.lambda_grad_term,
              eps=0.05)
    before = kernel_iter.iteration_packed.launches
    got = kernel_iter.iteration_packed(*args, **kw)
    torch.cuda.synchronize()
    assert kernel_iter.iteration_packed.launches == before + 1
    _equal(got, kernel_iter.iteration_plain(*args, **kw))
    if not bool(live.any()):   # no lane takes a step or keeps new gains
        _equal(got[:2] + got[3:5], (args[5], args[7], args[8], args[9]))
    if nan_lane is not None:
        assert torch.isnan(got[5][nan_lane]) and got[7][nan_lane] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("limits", (True, False), ids=("limits", "free"))
@pytest.mark.parametrize("case", ("partial_block_nan", "T1", "long_horizon"))
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_custom_team_sweep_matches_plain(dev, name, form, case, limits):
    model = _model(name)
    integrator, mode = FORMS[form]
    B, T, _A, _live, nan_lane = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    pp, _x0, us, xs, xT, _c0, lam, _f = _sweep_inputs(
        dev, model, integrator, limits, B, T, nan_lane, rng)
    args = (model, integrator, pp, xs, xT, us, lam, mode, limits, 0.05)
    before = kernel_sweep.sweep_packed.launches
    got = kernel_sweep.sweep_packed(*args)
    torch.cuda.synchronize()
    assert kernel_sweep.sweep_packed.launches == before + 1
    _equal(got, kernel_sweep.sweep_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MODELS))
def test_custom_team_is_launched(dev, name):
    """The model's library launches the teams: its iteration and split
    sweep launchers (stencils and dual numbers) MODELS' threads a lane,
    every one of them and the line search in blocks of 128 threads with no
    dynamic shared memory, at least one block an SM."""
    model = _model(name)
    lib = _build.lib_for(model)
    ptr = ctypes.POINTER(ctypes.c_int)
    for kind in ("iteration", "sweep"):
        for suffix in ("_fd", "_jvp"):
            width = getattr(lib, f"ilqr_{name}_{kind}{suffix}_lane_threads")
            width.restype = ctypes.c_int
            assert width() == MODELS[name]
            occ = getattr(lib, f"ilqr_{name}_{kind}{suffix}_blocks_per_sm")
            occ.argtypes, occ.restype = [ctypes.c_int, ptr, ptr], ctypes.c_int
            for limits in (1, 0):
                threads, smem = ctypes.c_int(0), ctypes.c_int(0)
                blocks = occ(limits, ctypes.byref(threads),
                             ctypes.byref(smem))
                assert (blocks >= 1 and threads.value == 128
                        and smem.value == 0)
    occ = getattr(lib, f"ilqr_{name}_linesearch_blocks_per_sm")
    occ.argtypes, occ.restype = [ptr, ptr], ctypes.c_int
    threads, smem = ctypes.c_int(0), ctypes.c_int(0)
    assert occ(ctypes.byref(threads), ctypes.byref(smem)) >= 1
    assert threads.value == 128 and smem.value == 0
