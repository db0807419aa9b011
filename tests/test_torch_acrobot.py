"""ilqr_tpu_torch's acrobot model against ilqr_tpu's, on the same inputs.

Inputs are drawn with numpy from a seed and handed to both; the JAX params
are carried over with ``params_from_numpy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.models import acrobot as jac
from ilqr_tpu_torch.models import acrobot as tac
from ilqr_tpu_torch.models import get_model

# f32 SoA values: the two libraries' sinf/cosf may differ by an ulp, and the
# dynamics carry that through the 1/det(H) factor and sums of terms of
# opposite sign; 2e-5 relative (about 170 ulps) plus 2e-5 absolute for values
# near zero bounds that with room, and is still far below any modelling
# difference (a wrong sign or term moves values by O(1)).
RTOL32, ATOL32 = 2e-5, 2e-5
# f64 AoS: the same formulas in double; only the 2×2 solve's rounding differs.
RTOL64, ATOL64 = 1e-12, 1e-12


def _params(dtype):
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, dtype),
                                jac.default_params())
    return jax.tree_util.tree_map(jnp.asarray, jp), tac.params_from_numpy(jp)


def _draw(seed, nb=256):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(-np.pi, np.pi, size=(2, nb)),
                        rng.normal(size=(2, nb)) * 2.0]).astype(np.float32)
    u = (rng.normal(size=(1, nb)) * 2.0).astype(np.float32)
    return x, u


def _np(v, nb):
    """A model output entry (tensor, jax array or Python float) as an (nb,)
    float64 array."""
    if isinstance(v, torch.Tensor):
        v = v.numpy()
    return np.broadcast_to(np.asarray(v, np.float64), (nb,))


def _close(got, want, nb, rtol=RTOL32, atol=ATOL32):
    np.testing.assert_allclose(_np(got, nb), _np(want, nb), rtol=rtol,
                               atol=atol)


def test_soa_values_match_jax():
    jp, tp = _params(np.float32)
    x, u = _draw(0)
    nb = x.shape[1]
    X, U = torch.from_numpy(x), torch.from_numpy(u)
    np.testing.assert_allclose(
        tac.dynamics_soa(tp, X, U).numpy(),
        np.asarray(jac.dynamics_soa(jp, jnp.asarray(x), jnp.asarray(u))),
        rtol=RTOL32, atol=ATOL32)
    _close(tac.cost_soa(tp, X, U), jac.cost_soa(jp, x, u), nb)
    _close(tac.final_cost_soa(tp, X), jac.final_cost_soa(jp, x), nb)


def test_analytic_derivatives_match_jax():
    jp, tp = _params(np.float32)
    x, u = _draw(1)
    nb = x.shape[1]
    X, U = torch.from_numpy(x), torch.from_numpy(u)
    (tA, tB), (jA, jB) = (tac.jac_soa(tp, X, U),
                          jac.jac_soa(jp, jnp.asarray(x), jnp.asarray(u)))
    for r in range(4):
        for i in range(4):
            # structural entries stay Python floats on both sides
            assert isinstance(tA[r][i], float) == isinstance(jA[r][i], float)
            _close(tA[r][i], jA[r][i], nb)
        assert isinstance(tB[r][0], float) == isinstance(jB[r][0], float)
        _close(tB[r][0], jB[r][0], nb)

    tc, jc = tac.cost_derivs_soa(tp, X, U), jac.cost_derivs_soa(jp, x, u)
    for got, want in zip(tc, jc):
        flat_g = np.ravel(np.asarray(got, dtype=object))
        flat_w = np.ravel(np.asarray(want, dtype=object))
        assert len(flat_g) == len(flat_w)
        for g, w in zip(flat_g, flat_w):
            assert isinstance(g, float) == isinstance(w, float)
            _close(g, w, nb)

    tf, jf = tac.final_cost_derivs_soa(tp, X), jac.final_cost_derivs_soa(jp, x)
    for i in range(4):
        _close(tf[0][i], jf[0][i], nb)
        for j in range(4):
            assert isinstance(tf[1][i][j], float) == isinstance(jf[1][i][j],
                                                                float)
            _close(tf[1][i][j], jf[1][i][j], nb)


def test_jacobians_match_autograd_of_dynamics():
    """jac_soa is the derivative of dynamics_soa (checked in f64 against
    torch.autograd, independently of the JAX package)."""
    _, tp = _params(np.float64)
    x, u = _draw(2, nb=8)
    X = torch.from_numpy(x.astype(np.float64))
    U = torch.from_numpy(u.astype(np.float64))
    A, B = tac.jac_soa(tp, X, U)
    for b in range(X.shape[1]):
        ja, jb = torch.autograd.functional.jacobian(
            lambda xx, uu: tac.dynamics_soa(tp, xx[:, None], uu[:, None])[:, 0],
            (X[:, b], U[:, b]))
        for r in range(4):
            for i in range(4):
                np.testing.assert_allclose(_np(A[r][i], 8)[b], ja[r, i].item(),
                                           rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(_np(B[r][0], 8)[b], jb[r, 0].item(),
                                       rtol=1e-9, atol=1e-9)


def test_aos_functions_match_jax_f64():
    jp, tp = _params(np.float64)
    rng = np.random.default_rng(3)
    for _ in range(8):
        x = np.concatenate([rng.uniform(-np.pi, np.pi, 2), rng.normal(size=2)])
        u = rng.normal(size=1) * 2.0
        X, U = torch.from_numpy(x), torch.from_numpy(u)
        np.testing.assert_allclose(
            tac.dynamics(tp, X, U).numpy(),
            np.asarray(jac.dynamics(jp, jnp.asarray(x), jnp.asarray(u))),
            rtol=RTOL64, atol=ATOL64)
        np.testing.assert_allclose(tac.cost(tp, X, U).item(),
                                   float(jac.cost(jp, x, u)),
                                   rtol=RTOL64, atol=ATOL64)
        np.testing.assert_allclose(tac.final_cost(tp, X).item(),
                                   float(jac.final_cost(jp, x)),
                                   rtol=RTOL64, atol=ATOL64)


@pytest.mark.parametrize("integrator", ["euler", "rk4"])
def test_integrators_match_jax_f64(integrator):
    """models/base.py's Euler and RK4 steps on the AoS dynamics, in f64."""
    from ilqr_tpu.models.base import get_integrator as jax_integrator
    from ilqr_tpu_torch.models import get_integrator

    jp, tp = _params(np.float64)
    rng = np.random.default_rng(5)
    for _ in range(4):
        x = np.concatenate([rng.uniform(-np.pi, np.pi, 2), rng.normal(size=2)])
        u = rng.normal(size=1) * 2.0
        got = get_integrator(integrator)(tac.MODEL, tp, torch.from_numpy(x),
                                         torch.from_numpy(u), 0.02)
        want = jax_integrator(integrator)(jac.MODEL, jp, jnp.asarray(x),
                                          jnp.asarray(u), 0.02)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL64, atol=ATOL64)
    with pytest.raises(ValueError):
        get_integrator("midpoint")


def test_soa_matches_aos_within_port():
    """The port's SoA functions agree with its own AoS functions (f64)."""
    _, tp = _params(np.float64)
    x, u = _draw(4, nb=6)
    X = torch.from_numpy(x.astype(np.float64))
    U = torch.from_numpy(u.astype(np.float64))
    dx = tac.dynamics_soa(tp, X, U)
    for b in range(6):
        np.testing.assert_allclose(dx[:, b].numpy(),
                                   tac.dynamics(tp, X[:, b], U[:, b]).numpy(),
                                   rtol=1e-10, atol=1e-10)


def test_params_from_numpy_round_trips_default_params():
    p = tac.default_params()
    back = tac.params_from_numpy(
        type(p)(*(np.asarray(v) for v in p)))
    for f in tac.AcrobotParams._fields:
        assert getattr(back, f).dtype == getattr(p, f).dtype
        assert torch.equal(getattr(back, f), getattr(p, f)), f
    # the JAX package's defaults carry over field by field
    _, from_jax = _params(np.float32)
    for f in tac.AcrobotParams._fields:
        np.testing.assert_array_equal(getattr(from_jax, f).numpy(),
                                      getattr(p, f).numpy().astype(np.float32))


def test_registry_has_acrobot_only():
    """The registry holds acrobot as the JAX package's (n, m); every model
    of the JAX package's 14 is registered now, and an unknown name
    raises."""
    from ilqr_tpu.models import list_models as jax_list_models
    from ilqr_tpu_torch.models import list_models

    assert get_model("acrobot") is tac.MODEL
    assert (get_model("acrobot").n, get_model("acrobot").m) == (4, 1)
    assert len(list_models()) == 14
    assert set(list_models()) <= set(jax_list_models())
    for name in ("pendulum", "bicycle"):
        assert get_model(name).name == name
    with pytest.raises(NotImplementedError):
        get_model("no_such_model")
