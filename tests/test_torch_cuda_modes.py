"""The modes of ``rollout_packed``'s second kernel (costs_only, candidates,
in-kernel α per candidate and per lane) against the plain version, on the
card. Every test here needs a CUDA device and skips without one.

Like tests/test_torch_cuda.py this file imports neither JAX nor ilqr_tpu;
run it there as ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_modes.py``. Kernel and plain version run the same
IEEE f32 operations in the same order (--fmad=false), so the outputs are
held bit for bit (NaNs in the same places), as chip_smoke.py holds them.
"""

import numpy as np
import pytest
import torch

from ilqr_tpu_torch import get_model
from ilqr_tpu_torch.models import acrobot as tac
from ilqr_tpu_torch.models import pendulum as tpd
from ilqr_tpu_torch.ops import kernel_rollout, launch_counts
from ilqr_tpu_torch.ops import reset_launch_counts

B, T = 256, 7
ALPHAS = (1.0, 0.5, 0.1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        assert torch.equal(g[ok], w[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("name, integrator, per_lane", [
    ("acrobot", "euler", False), ("acrobot", "rk4", False),
    ("pendulum", "euler", True)])
def test_rollout_modes_match_plain(dev, name, integrator, per_lane):
    model = get_model(name)
    n, m, A = model.n, model.m, len(ALPHAS)
    rng = np.random.default_rng(0)
    f = lambda sc, *s: torch.as_tensor(
        (sc * rng.normal(size=s)).astype(np.float32), device=dev)
    x0, us, k = f(0.2, n, B), f(0.3, T, m, B), f(0.1, T, m, B)
    xsr, K, uff_wide = f(0.2, T, n, B), f(0.1, T, m, n, B), f(0.3, T, m,
                                                                A * B)
    mod = tac if name == "acrobot" else tpd
    if per_lane:
        base = model.default_params()
        params = type(base)(*[
            np.asarray(v)[None] * rng.uniform(0.8, 1.2, (B,) + np.shape(v))
            for v in base])
        pp = kernel_rollout.pack_params_batched(params, 0.05, dev)
    else:
        pp = kernel_rollout.pack_params(mod.default_params(), 0.02, dev)
    al = torch.tensor(ALPHAS, device=dev)
    lanes = torch.as_tensor(rng.uniform(size=B).astype(np.float32),
                            device=dev)
    calls = {
        "costs_only": (us, dict(costs_only=True)),
        "candidates": (uff_wide, dict(costs_only=True, candidates=A)),
        "alphas": (us, dict(costs_only=True, candidates=A, k=k, alphas=al)),
        "alpha_lanes": (us, dict(k=k, alpha_lanes=lanes)),
    }
    reset_launch_counts()
    for mode, (uff, kw) in calls.items():
        args = (model, integrator, True, pp, x0, uff, xsr, K)
        got = kernel_rollout.rollout_packed(*args, **kw)
        torch.cuda.synchronize()
        _equal(got, kernel_rollout.rollout_plain(*args, **kw))
    assert launch_counts()["rollout_packed"] == 0
    assert kernel_rollout.rollout_packed.mode_launches == dict.fromkeys(
        calls, 1)
