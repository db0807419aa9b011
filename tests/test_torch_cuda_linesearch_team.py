"""The line-search kernel of every model of the package, a team of 16
threads per lane (csrc/linesearch_team.cuh), against ``linesearch_plain``
on the card: with the Euler step and a clamped rollout, and with RK4
unclamped, on the team design's edge cases: a partial last block (B not a
multiple of the 8 lanes a block), A = 1, A = 7 and A = 11 candidates,
every lane dead (no step taken, no gain kept), and a lane with NaN in x0;
T is long enough for the selected candidate's replay to run in segments.
Every test here needs a CUDA device and skips without one.

Like tests/test_torch_cuda.py this file imports neither JAX nor ilqr_tpu;
run it there as ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_linesearch_team.py``. Kernel and plain version run
the same IEEE f32 operations in the same order (--fmad=false), so the
outputs are held bit for bit (NaNs in the same places), as chip_smoke.py
holds them.
"""

import numpy as np
import pytest
import torch

from ilqr_tpu_torch import SolverConfig, get_model
from ilqr_tpu_torch.ops import kernel_rollout

T, DT = 40, 0.05
CFG = SolverConfig()
# (integrator, clamp)
FORMS = {"euler": ("euler", True), "rk4": ("rk4", False)}
# B, A, gates ("mixed", "dead"), the lane with NaN in x0
CASES = {"partial_block_nan": (77, 11, "mixed", 5),
         "one_alpha": (24, 1, "mixed", None),
         "seven_alphas": (24, 7, "mixed", None),
         "all_dead": (24, 11, "dead", None)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, name, integrator, clamp, B, A, gates, nan_lane, seed):
    """linesearch_packed's arguments: x0, its open-loop rollout around
    random controls as the current trajectory, random gains and previous
    gains, dV, the previous cost and the gates mixed over the lanes."""
    model = get_model(name)
    n, m = model.n, model.m
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pp = kernel_rollout.pack_params(model.default_params(), DT, dev)
    x0 = 0.3 * rng.normal(size=(n, B))
    if nan_lane is not None:
        x0[:, nan_lane] = np.nan
    x0, us = f(x0), f(0.5 * rng.normal(size=(T, m, B)))
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    xs, _u, xT, c0 = kernel_rollout.rollout_plain(
        model, integrator, clamp, pp, x0, us, zeros(T, n, B),
        zeros(T, m, n, B))
    dv = f(np.stack([-10.0 * np.abs(rng.normal(size=B)),
                     np.abs(rng.normal(size=B))]))
    cprev = c0 * f(rng.choice([0.9, 1.0, 1.1, 2.0], size=B))
    if gates == "mixed":
        gate, keep = f(rng.uniform(size=B) > 0.3), f(rng.uniform(size=B) > 0.5)
    else:
        gate, keep = zeros(B), zeros(B)
    return (model, integrator, clamp, pp, x0, us, xs.contiguous(),
            xT.contiguous(), f(0.1 * rng.normal(size=(T, m, n, B))),
            f(0.3 * rng.normal(size=(T, m, B))),
            f(rng.normal(size=(T, m, n, B))), f(rng.normal(size=(T, m, B))),
            f(CFG.alphas[:A]), dv, cprev.contiguous(), gate, keep, CFG.z_min)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        assert torch.equal(g[ok], w[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name",
                         sorted(kernel_rollout.FUSED_KERNEL_MODELS))
def test_team_linesearch_matches_plain(dev, name, form, case):
    integrator, clamp = FORMS[form]
    B, A, gates, nan_lane = CASES[case]
    args = _inputs(dev, name, integrator, clamp, B, A, gates, nan_lane,
                   seed=sorted(CASES).index(case))
    before = kernel_rollout.linesearch_packed.launches
    got = kernel_rollout.linesearch_packed(*args)
    torch.cuda.synchronize()
    assert kernel_rollout.linesearch_packed.launches == before + 1
    want = kernel_rollout.linesearch_plain(*args)
    _equal(got, want)
    if gates == "dead":   # the current state and the previous gains
        _equal(got[:5], (args[6], args[5], args[7], args[11], args[10]))
    if nan_lane is not None:
        assert torch.isnan(got[5][nan_lane]) and got[7][nan_lane] == 0.0
