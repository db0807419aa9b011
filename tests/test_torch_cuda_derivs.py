"""The derivative kernel (csrc/derivs.cuh, a thread per (t, lane) storing
each entry as it is made) against ``derivs_plain`` on the card, for every model of the package and a
registered custom model (the unicycle of ilqr_tpu_torch/examples/
custom_model.py, in its own library), in both modes (the dual numbers and
the reference's stencils), with the Euler and the RK4 step, on the
design's edge cases: B not a multiple of a warp's 32 lanes, T = 1, a lane
with NaN in x0, and per-lane params. Every test here needs a CUDA device
and skips without one.

Like tests/test_torch_cuda.py this file imports neither JAX nor ilqr_tpu;
run it there as ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_derivs.py``. Kernel and plain version run the same
IEEE f32 operations in the same order (--fmad=false), so the outputs are
held bit for bit (NaNs in the same places), as chip_smoke.py holds them.
"""

import numpy as np
import pytest
import torch

from ilqr_tpu_torch import get_model
from ilqr_tpu_torch.ops import kernel_derivs, kernel_rollout

DT = 0.05
MODELS = tuple(sorted(kernel_derivs.DERIVS_KERNEL_MODELS)) + ("unicycle",)
# B, T, per-lane params, the lane with NaN in x0: B = 45 is 13 lanes into
# its second warp; B = 7 is one partial warp
CASES = {"partial_block_nan": (45, 3, False, 5),
         "per_lane_T1": (7, 1, True, None)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _model(name):
    if name == "unicycle":
        from ilqr_tpu_torch.examples import custom_model as tcm

        uni, _head = tcm.register_models()
        return uni, tcm.default_params()
    model = get_model(name)
    return model, model.default_params()


def _inputs(dev, name, B, T, per_lane, nan_lane, seed):
    """derivs_packed's arguments after the integrator: the model, the
    packed params (per-lane goals where asked), states and controls drawn
    around the model's scale."""
    model, params = _model(name)
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    n, m = model.n, model.m
    if per_lane:
        leaves = {k: np.repeat(np.asarray(v, np.float32)[None], B, 0)
                  for k, v in params._asdict().items()}
        leaves["goal"] = leaves["goal"] + 0.1 * rng.normal(
            size=leaves["goal"].shape)
        pp = kernel_rollout.pack_params_batched(type(params)(**leaves), DT,
                                                dev)
    else:
        pp = kernel_rollout.pack_params(params, DT, dev)
    x = 0.3 * rng.normal(size=(T + 1, n, B))
    if nan_lane is not None:
        x[0, :, nan_lane] = np.nan
    us = 0.5 * rng.normal(size=(T, m, B))
    return model, pp, f(x), f(us)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        assert torch.equal(g[ok], w[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("integrator", ["euler", "rk4"])
@pytest.mark.parametrize("mode", ["jvp", "fd"])
@pytest.mark.parametrize("name", MODELS)
def test_derivs_kernel_matches_plain(dev, name, mode, integrator, case):
    B, T, per_lane, nan_lane = CASES[case]
    model, pp, xs, us = _inputs(
        dev, name, B, T, per_lane, nan_lane,
        seed=MODELS.index(name) * 10 + sorted(CASES).index(case))
    args = (model, integrator, pp, xs, us, mode)
    before = kernel_derivs.derivs_packed.launches
    got = kernel_derivs.derivs_packed(*args)
    torch.cuda.synchronize()
    assert kernel_derivs.derivs_packed.launches == before + 1
    want = kernel_derivs.derivs_plain(*args)
    _equal(got, want)
    if nan_lane is not None:   # the NaN reaches that lane's step 0 only
        assert bool(torch.isnan(got[2][0, :, nan_lane]).any())
        for out in got:
            assert not bool(torch.isnan(out[..., :nan_lane]).any())
            assert not bool(torch.isnan(out[1:, ..., nan_lane]).any())
