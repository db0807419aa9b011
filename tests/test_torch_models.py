"""The port's models of m ≥ 2 (double_integrator, point_mass_3d,
quadrotor, omni_thruster, free_flyer and the four thruster rings) against
the JAX package's models, and the structural patterns that the CUDA kernels
compile in (csrc/<model>.cuh ``a_kind``/``b_kind``) against the constants
the JAX package's ``jac_soa`` returns.

Inputs are drawn with numpy in f32 and handed to both sides. Tolerance:
|port − JAX| ≤ 1e-5·(1 + |JAX|). The two sides run the same f32
operations in the same order, so the models without trig agree to the bit;
the quadrotor's and the rings' sin/cos (torch vs XLA) may differ by an
ulp, which the Jacobian's divisions by cos θ carry to a few ulps. The
rings' geometry tables in csrc/thruster_ring.cuh are held to the JAX
package's ``_ring_geometry`` cast to f32 bit for bit.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import get_model as jax_get_model
from ilqr_tpu.models import acrobot as jac_acrobot
from ilqr_tpu.models import double_integrator as jdi
from ilqr_tpu.models import free_flyer as jff
from ilqr_tpu.models import omni_thruster as jot
from ilqr_tpu.models import point_mass_3d as jpm
from ilqr_tpu.models import quadrotor as jqd
from ilqr_tpu.models import thruster_ring as jtr
from ilqr_tpu_torch import get_model
from ilqr_tpu_torch.models import acrobot as tac
from ilqr_tpu_torch.models import double_integrator as tdi
from ilqr_tpu_torch.models import free_flyer as tff
from ilqr_tpu_torch.models import omni_thruster as tot
from ilqr_tpu_torch.models import point_mass_3d as tpm
from ilqr_tpu_torch.models import quadrotor as tqd
from ilqr_tpu_torch.models import thruster_ring as ttr
from ilqr_tpu_torch.ops import kernel_rollout

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "ilqr_tpu_torch"
        / "csrc")
TOL = 1e-5
RINGS = {"thruster_ring": 12, "thruster_ring16": 16, "thruster_ring20": 20,
         "thruster_ring24": 24}
# name → (JAX module, port module): the port module's params_from_numpy
PAIRS = {
    "acrobot": (jac_acrobot, tac),
    "double_integrator": (jdi, tdi),
    "point_mass_3d": (jpm, tpm),
    "quadrotor": (jqd, tqd),
    "omni_thruster": (jot, tot),
    "free_flyer": (jff, tff),
    **{name: (jtr, ttr) for name in RINGS},
}
NEW = ("double_integrator", "point_mass_3d", "quadrotor", "omni_thruster",
       "free_flyer", *RINGS)


def _params(name):
    _jmod, tmod = PAIRS[name]
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                jax_get_model(name).default_params())
    return jax.tree_util.tree_map(jnp.asarray, jp), tmod.params_from_numpy(jp)


def _xu(name, B=64, seed=0):
    m = get_model(name)
    rng = np.random.default_rng(seed)
    x = (0.4 * rng.normal(size=(m.n, B))).astype(np.float32)
    u = (1.0 + 0.5 * rng.normal(size=(m.m, B))).astype(np.float32)
    return x, u


def _close(got, want, what):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max(initial=0.0) <= TOL, (what, float(err.max()))


def _same_entries(got, want, what):
    """Nested lists with the same structure: a Python float where JAX has
    one (equal), a tensor where JAX has an array (close)."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same_entries(g, w, f"{what}[{i}]")
    elif isinstance(want, (int, float)):
        assert isinstance(got, (int, float)) and got == want, what
    else:
        assert isinstance(got, torch.Tensor), what
        _close(got, np.broadcast_to(np.asarray(want), tuple(got.shape)),
               what)


@pytest.mark.parametrize("name", NEW)
def test_soa_functions_match_jax(name):
    jmod, tmod = jax_get_model(name), get_model(name)
    jp, tp = _params(name)
    x, u = _xu(name)
    jx, ju = jnp.asarray(x), jnp.asarray(u)
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    _close(tmod.dynamics_soa(tp, tx, tu), jmod.dynamics_soa(jp, jx, ju),
           "dynamics_soa")
    _close(tmod.cost_soa(tp, tx, tu), jmod.cost_soa(jp, jx, ju), "cost_soa")
    _close(tmod.final_cost_soa(tp, tx), jmod.final_cost_soa(jp, jx),
           "final_cost_soa")
    _same_entries(tmod.jac_soa(tp, tx, tu), jmod.jac_soa(jp, jx, ju),
                  "jac_soa")
    _same_entries(tmod.cost_derivs_soa(tp, tx, tu),
                  jmod.cost_derivs_soa(jp, jx, ju), "cost_derivs_soa")
    _same_entries(tmod.final_cost_derivs_soa(tp, tx),
                  jmod.final_cost_derivs_soa(jp, jx), "final_cost_derivs_soa")


@pytest.mark.parametrize("name", NEW)
def test_single_problem_functions_match_jax(name):
    jmod, tmod = jax_get_model(name), get_model(name)
    jp, tp = _params(name)
    x, u = _xu(name, B=3, seed=1)
    for b in range(3):
        xb, ub = x[:, b], u[:, b]
        jx, ju = jnp.asarray(xb), jnp.asarray(ub)
        tx, tu = torch.from_numpy(xb.copy()), torch.from_numpy(ub.copy())
        _close(tmod.dynamics(tp, tx, tu), jmod.dynamics(jp, jx, ju),
               "dynamics")
        _close(tmod.cost(tp, tx, tu), jmod.cost(jp, jx, ju), "cost")
        _close(tmod.final_cost(tp, tx), jmod.final_cost(jp, jx),
               "final_cost")


def test_default_params_and_hover_control_match_jax():
    for name in NEW:
        jd = jax_get_model(name).default_params()
        td = get_model(name).default_params()
        assert type(td)._fields == type(jd)._fields
        for f in type(jd)._fields:   # in the port's default dtype, f32
            np.testing.assert_array_equal(
                getattr(td, f).to(torch.float32).numpy(),
                np.asarray(getattr(jd, f), np.float32))
    for jmod, tmod in ((jqd, tqd), (jot, tot)):
        jp, tp = _params(tmod.MODEL.name)
        np.testing.assert_array_equal(
            tmod.hover_control(tp).to(torch.float32).numpy(),
            np.asarray(jmod.hover_control(jp), np.float32))
    assert float(tqd.hover_control(_params("quadrotor")[1])[0]) == (
        pytest.approx(0.5 * 9.81 / 4))
    hover = tot.hover_control(_params("omni_thruster")[1])
    assert float(hover[4]) == pytest.approx(9.81)
    assert float(hover.abs().sum()) == pytest.approx(9.81)


@pytest.mark.parametrize("name", sorted(RINGS))
def test_ring_tables_match_jax_geometry(name):
    """csrc/thruster_ring.cuh's Geometry<M> literals are the JAX package's
    _ring_geometry(M) cast to f32, bit for bit, zeros where it snapped them
    to zero; the port's own copy of the geometry is the same."""
    M = RINGS[name]
    dirs, torque = jtr._ring_geometry(M)
    src = (CSRC / "thruster_ring.cuh").read_text()
    block = re.search(rf"struct Geometry<{M}> \{{(.*?)\n\}};", src,
                      re.S).group(1)
    for fn, want in (("d0", dirs[:, 0]), ("d1", dirs[:, 1]),
                     ("arm", torque)):
        body = re.search(rf"float {fn}\(int i\) \{{\s*constexpr float "
                         rf"v\[{M}\] = \{{(.*?)\}};", block, re.S).group(1)
        got = np.array([np.float32(w.strip().rstrip("f"))
                        for w in body.split(",")], np.float32)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.astype(np.float32).view(np.uint32))
        assert np.array_equal(got == 0.0, want == 0.0), fn
    pdirs, ptorque = ttr.ring_geometry(M)
    np.testing.assert_array_equal(pdirs, dirs)
    np.testing.assert_array_equal(ptorque, torque)


def _cuda_pattern(name, fn):
    """The string rows of ``fn`` (a_kind or b_kind) in csrc/<name>.cuh; a
    ring's b_kind is its Geometry<M>'s in csrc/thruster_ring.cuh."""
    if name in RINGS:
        src = (CSRC / "thruster_ring.cuh").read_text()
        if fn == "b_kind":
            src = re.search(rf"struct Geometry<{RINGS[name]}> \{{(.*?)\n\}};",
                            src, re.S).group(1)
        else:
            src = src[src.index("struct Model {"):]
    else:
        src = (CSRC / f"{name}.cuh").read_text()
    body = re.search(rf"constexpr char {fn}\(int r, int \w\) \{{(.*?)\}}",
                     src, re.S).group(1)
    return re.findall(r'"([.1x]+)"', body)


def _kind(v):
    if isinstance(v, (int, float)):
        return {0.0: ".", 1.0: "1"}[float(v)]
    return "x"


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_cuda_structural_patterns_match_jax(name):
    """Every entry the kernel treats as a structural zero or one is the
    Python float the JAX package's jac_soa returns there, and every live
    entry is an array; the cost Hessians the kernels take as diagonal (and
    cxu as zero) are so in the JAX package."""
    jmod, m = jax_get_model(name), get_model(name)
    jp, _tp = _params(name)
    x, u = _xu(name, B=8)
    A, Bm = jmod.jac_soa(jp, jnp.asarray(x), jnp.asarray(u))
    assert _cuda_pattern(name, "a_kind") == [
        "".join(_kind(v) for v in row) for row in A]
    assert _cuda_pattern(name, "b_kind") == [
        "".join(_kind(v) for v in row) for row in Bm]
    _cx, _cu, cxx, cxu, cuu = jmod.cost_derivs_soa(jp, jnp.asarray(x),
                                                   jnp.asarray(u))
    _fcx, fcxx = jmod.final_cost_derivs_soa(jp, jnp.asarray(x))
    for H, d in ((cxx, m.n), (cuu, m.m), (fcxx, m.n)):
        for i in range(d):
            for j in range(d):
                assert (_kind(H[i][j]) == "x") == (i == j), (name, i, j)
    assert all(_kind(v) == "." for row in cxu for v in row)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_packed_params_match_cuda_loader(name):
    """The flat params vector has the length the model's CUDA loader reads:
    dt is its last entry (csrc/<name>.cuh load)."""
    src = (CSRC / ("thruster_ring.cuh" if name in RINGS
                   else f"{name}.cuh")).read_text()
    at = re.search(r"q\.dt = p\[([^\]]+)\];", src).group(1)
    dt_at = int(eval(at, {"M": RINGS.get(name)}))   # e.g. "23 + 3 * M"
    pp = kernel_rollout.pack_params(get_model(name).default_params(), 0.02)
    assert pp.vec.numel() == dt_at + 1
    assert pp.vec[dt_at].item() == pytest.approx(0.02)
