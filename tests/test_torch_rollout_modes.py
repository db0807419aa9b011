"""The modes of ``rollout_packed`` beside its full output — ``costs_only``,
``candidates`` (materialized, and with the step α formed in the kernel)
and ``alpha_lanes`` — in ilqr_tpu_torch against ilqr_tpu's Pallas kernel.

On the CPU the op runs its plain version; the JAX kernel runs in Pallas
interpret mode at tests/test_pallas_rollout.py's shapes (one 1024-lane
block; acrobot T = 7, A = 3; pendulum T = 6). Inputs are drawn with numpy
and handed to both sides in their layouts (the port's lane-last (…, B) is
the JAX packed (…, 1, 8, 128) flattened; A candidates are A blocks,
candidate-major, on both sides).

Tolerance: tests/test_torch_kernels.py's TOL = 1e-4 on max |a − b| /
(1 + |b|), which measured ~2e-7 for rollouts (the two libraries' sinf/cosf
differ by an ulp, T steps carry it); here the six cases measure 2.4e-7 to
3.3e-7. Within the port the modes are held
bit for bit: candidate a equals the full-output rollout at u_ff + α_a·k.

The CUDA kernel is held against this plain version on the card by
tests/test_torch_cuda_modes.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import get_model as jax_get_model
from ilqr_tpu.ops import pallas_rollout
from ilqr_tpu_torch import get_model
from ilqr_tpu_torch.ops import (
    _build,
    kernel_rollout,
    launch_counts,
    reset_launch_counts,
)

B = 1024
TOL = 1e-4
ALPHAS = np.asarray([1.0, 0.5, 0.1], np.float32)


def _jp(a):
    """Lane-last numpy array (…, A·B) → JAX packed (…, A, 8, 128)."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a.reshape(a.shape[:-1] + (-1, 8, 128)))


def _tp(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _unj(y):
    """JAX packed output (…, A, 8, 128) → lane-last (…, A·B)."""
    y = np.asarray(y)
    return y.reshape(y.shape[:-3] + (-1,))


def _assert_close(got, want, what, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok]) / (1.0 + np.abs(want[ok]))
    assert err.max(initial=0.0) <= tol, (what, float(err.max()))


def _shared_params(name):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jax_get_model(name).default_params())


def _packs(name, dt, per_lane=False):
    """(JAX packed params, port packed params): shared defaults, or every
    leaf drawn per lane (× U(0.8, 1.2), one 1024-lane block)."""
    jp = _shared_params(name)
    mod = __import__(f"ilqr_tpu_torch.models.{name}", fromlist=["x"])
    if not per_lane:
        return (pallas_rollout.pack_params(
            jax.tree_util.tree_map(jnp.asarray, jp), dt),
            kernel_rollout.pack_params(mod.params_from_numpy(jp), dt))
    rng = np.random.default_rng(11)
    jp = type(jp)(**{f: (np.asarray(v)[None] * rng.uniform(
        0.8, 1.2, size=(B,) + np.shape(v))).astype(np.float32)
        for f, v in zip(jp._fields, jp)})
    return (pallas_rollout.pack_params_batched(
        jax.tree_util.tree_map(jnp.asarray, jp), dt, 1),
        kernel_rollout.pack_params_batched(mod.params_from_numpy(jp), dt))


def _inputs(name, T, seed, A=1):
    """x0 (n, B), us (T, m, B), k (T, m, B), x̄ (T, n, B), K (T, m, n, B)
    and a materialized u_ff (T, m, A·B), numpy f32, as
    tests/test_pallas_rollout.py draws them."""
    mo = jax_get_model(name)
    n, m = mo.n, mo.m
    rng = np.random.default_rng(seed)
    f = lambda sc, *s: (sc * rng.normal(size=s)).astype(np.float32)
    return dict(x0=f(0.2, n, B), us=f(0.3, T, m, B), k=f(0.1, T, m, B),
                xsr=f(0.2, T, n, B), K=f(0.1, T, m, n, B),
                uff_wide=f(0.3, T, m, A * B))


# name, integrator, clamp, dt, T, mode, A, per-lane params
CASES = {
    "alphas": ("acrobot", "euler", True, 0.02, 7, "alphas", 3, False),
    "alpha_lanes": ("pendulum", "euler", False, 0.05, 6, "alpha_lanes", 1,
                    False),
    "costs_only": ("acrobot", "euler", True, 0.02, 7, "costs_only", 1,
                   False),
    "candidates": ("acrobot", "euler", True, 0.02, 7, "candidates", 3,
                   False),
    "alphas_rk4": ("acrobot", "rk4", False, 0.02, 7, "alphas", 3, False),
    "alphas_per_lane": ("pendulum", "euler", True, 0.05, 6, "alphas", 3,
                        True),
}


def _call(case):
    """The port's and the JAX kernel's outputs of one case, lane-last."""
    name, integ, clamp, dt, T, mode, A, per_lane = CASES[case]
    d = _inputs(name, T, seed=5, A=A)
    al = (np.random.default_rng(6).uniform(0, 1, size=B).astype(np.float32)
          if mode == "alpha_lanes" else ALPHAS[:A])
    uff = d["uff_wide"] if mode == "candidates" else d["us"]
    kw_t = dict(costs_only=mode != "alpha_lanes", candidates=A)
    kw_j = dict(kw_t)
    if mode == "alphas":
        kw_t.update(k=_tp(d["k"]), alphas=_tp(al))
        kw_j.update(k_p=_jp(d["k"]), alphas=jnp.asarray(al))
    elif mode == "alpha_lanes":
        kw_t.update(k=_tp(d["k"]), alpha_lanes=_tp(al))
        kw_j.update(k_p=_jp(d["k"]), alpha_lanes=_jp(al))
    jpack, tpack = _packs(name, dt, per_lane)
    got = kernel_rollout.rollout_packed(
        get_model(name), integ, clamp, tpack, _tp(d["x0"]), _tp(uff),
        _tp(d["xsr"]), _tp(d["K"]), **kw_t)
    want = pallas_rollout.rollout_packed(
        jax_get_model(name), integ, clamp, jpack, _jp(d["x0"]), _jp(uff),
        _jp(d["xsr"]), _jp(d["K"]), interpret=True, **kw_j)
    return got, want, d, al, tpack


@pytest.mark.parametrize("case", list(CASES))
def test_mode_matches_jax(case):
    got, want, *_ = _call(case)
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_close(g, _unj(w), f"{case}[{i}]")


@pytest.mark.parametrize("case", ["alphas", "alphas_rk4", "alphas_per_lane",
                                  "candidates", "alpha_lanes"])
def test_candidates_equal_full_rollouts_bitwise(case):
    """Within the port: candidate a of a sweep equals the full-output
    rollout at u_ff + α_a·k (materialized: at its own u_ff column), bit for
    bit; so does each lane of an alpha_lanes rollout at its own α."""
    got, _want, d, al, tpack = _call(case)
    name, integ, clamp, _dt, T, mode, A, _pl = CASES[case]
    model = get_model(name)
    args = (_tp(d["x0"]), _tp(d["xsr"]), _tp(d["K"]))
    for a in range(A):
        if mode == "candidates":
            uff = _tp(d["uff_wide"][..., a * B:(a + 1) * B])
        else:
            step = torch.tensor(al[a]) if mode == "alphas" else _tp(al)
            uff = _tp(d["us"]) + step * _tp(d["k"])
        full = kernel_rollout.rollout_packed(model, integ, clamp, tpack,
                                             args[0], uff, *args[1:])
        if mode == "alpha_lanes":
            for g, w in zip(got, full):
                assert torch.equal(g, w)
        else:
            assert torch.equal(got[a * B:(a + 1) * B], full[3]), a


@pytest.mark.parametrize("kw, match", [
    (dict(candidates=3), "full outputs require candidates == 1"),
    (dict(costs_only=True, candidates=0), "candidates must be"),
    (dict(costs_only=True, candidates=3, alphas="a", alpha_lanes="l",
          k="k"), "exclude each other"),
    (dict(costs_only=True, candidates=3, alphas="a"), "needs k"),
    (dict(alpha_lanes="l"), "needs k"),
])
def test_invalid_modes_raise_before_any_launch(kw, match, monkeypatch):
    def no_kernels(*a, **k):
        raise AssertionError("a kernel launcher was called")

    monkeypatch.setattr(_build, "launch", no_kernels)
    monkeypatch.setattr(_build, "library", no_kernels)
    reset_launch_counts()
    d = _inputs("acrobot", 3, seed=1)
    _j, tpack = _packs("acrobot", 0.02)
    with pytest.raises(ValueError, match=match):
        kernel_rollout.rollout_packed(
            get_model("acrobot"), "euler", True, tpack, _tp(d["x0"]),
            _tp(d["us"]), _tp(d["xsr"]), _tp(d["K"]), **kw)
    assert not any(launch_counts().values())
    assert not any(kernel_rollout.rollout_packed.mode_launches.values())
