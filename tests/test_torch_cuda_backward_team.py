"""The m = 1 backward kernel (csrc/backward.cuh: a team of threads per lane
fed by a cp.async ring of shared-memory stages) against ``backward_plain``
on the card, bit for bit, at n = 2 and n = 4 (the main library's
``ilqr_backward_n2``, ``ilqr_backward_n4``) and n = 3 (the registered custom
model unicycle_heading's own library), on the design's edge cases: B not a
multiple of 4 nor of the lanes a block (the 4-byte copies), B a multiple of
4 but not of the lanes a block (the 16-byte copies, a partial last block),
T = 1, a NaN lane, lanes whose QuuF ≤ 0 latch ``div`` (negative cuu with
λ = 0), per-lane limits that clamp the control, mixed λ, a long horizon
that runs the ring many times round, and B large enough that a block takes
two warps (B = 8196 at n = 3 and 4, 16-byte copies; B = 16899 at every n,
4-byte copies).
Every test here needs a CUDA device and skips without one.

Like tests/test_torch_cuda.py this file imports neither JAX nor ilqr_tpu;
run it there as ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_backward_team.py``. Kernel and plain version run the
same IEEE f32 operations in the same order (--fmad=false), so the outputs
are held bit for bit (NaNs in the same places).
"""

import numpy as np
import pytest
import torch

from ilqr_tpu_torch.ops import kernel_backward

# case: (B, T, edge)
CASES = {"partial_block": (67, 9, None), "T1": (67, 1, None),
         "nan_lane": (67, 9, "nan"), "div_lanes": (67, 9, "bad"),
         "clamped": (67, 9, "clamp"), "mixed_lam": (67, 9, "lam"),
         "vector_nan_lane": (68, 9, "nan"), "long": (1028, 50, None),
         "two_warps": (8196, 6, None),
         "two_warps_4byte": (16899, 3, "nan")}
NS = (2, 3, 4)   # n = 3: the custom model unicycle_heading's library


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, n, B, T, edge, seed):
    """The kernel's twelve lane-last inputs from a seed: a near-identity
    fx, positive semi-definite cxx and terminal cxx, cuu > 0, lo < 0 < hi,
    λ ≥ 0; ``edge`` adds a NaN in one lane's fx, negative cuu with λ = 0
    on every third lane, limits a hundredth as wide, or λ drawn from
    {0, 1e-6, 1, 10, 1e3}."""
    rng = np.random.default_rng(seed)
    g = lambda *s: rng.standard_normal(s).astype(np.float32)
    fx = np.eye(n, dtype=np.float32)[None, :, :, None] + 0.1 * g(T, n, n, B)
    a = g(T, n, n, B)
    cxx = 0.1 * np.einsum("tikb,tjkb->tijb", a, a) + 0.02 * g(T, n, n, B)
    b = g(n, n, B)
    out = dict(fx=fx, fu=0.3 * g(T, n, B), cx=g(T, n, B), cu=g(T, B),
               cxx=cxx, cxu=0.1 * g(T, n, B), cuu=0.5 + np.abs(g(T, B)),
               lo=-0.5 - np.abs(g(T, B)), hi=0.5 + np.abs(g(T, B)),
               lam=0.3 * np.abs(g(B)), cxT=g(n, B),
               cxxT=np.einsum("ikb,jkb->ijb", b, b))
    if edge == "nan":
        out["fx"][T // 2, 0, 0, B // 2] = np.nan
    elif edge == "bad":
        out["cuu"][:, ::3] = -5.0
        out["lam"][::3] = 0.0
    elif edge == "clamp":
        out["lo"] *= 0.01
        out["hi"] *= 0.01
    elif edge == "lam":
        out["lam"] = rng.choice(np.array([0.0, 1e-6, 1.0, 10.0, 1e3],
                                         np.float32), B)
    return [torch.as_tensor(np.ascontiguousarray(v, np.float32), device=dev)
            for v in out.values()]


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        assert torch.equal(g[ok], w[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n", NS)
def test_backward_team_matches_plain(dev, n, case):
    if n not in kernel_backward.BACKWARD_KERNEL_NS:
        from ilqr_tpu_torch.examples import custom_model as tcm

        _uni, head = tcm.register_models()
        assert head.n == n and head.m == 1
        assert kernel_backward.backward_owner(n) is head
    B, T, edge = CASES[case]
    args = _inputs(dev, n, B, T, edge, seed=100 * n + sorted(CASES).index(case))
    before = kernel_backward.backward_sweep_packed.launches
    got = kernel_backward.backward_sweep_packed(*args)
    torch.cuda.synchronize()
    assert kernel_backward.backward_sweep_packed.launches == before + 1
    want = kernel_backward.backward_plain(*args)
    _equal(got, want)
    k, K, dv, div = got
    if edge == "bad":   # the lanes with QuuF ≤ 0 latch and zero their gains
        assert bool((div[::3] == 1.0).all())
    if edge == "clamp":   # some controls sit on their limits, K zero there
        lo, hi = args[7], args[8]
        on = (k == lo) | (k == hi)
        assert bool(on.any()) and bool((K.permute(1, 0, 2)[:, on] == 0).all())
    if edge == "nan":
        assert bool(torch.isnan(K[:, :, B // 2]).any() | (div[B // 2] == 1))
