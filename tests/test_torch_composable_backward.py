"""The composable backward pass at any m (ops/backward.py ``_backward_scan``)
against ilqr_tpu's ``backward_pass``, vmapped, on the same derivatives.

The derivatives are the port's plain derivative stage on random
trajectories (drawn with numpy from a seed) of the double integrator
(m = 2), the quadrotor (m = 4) and omni_thruster (m = 6), B = 8 lanes,
T = 6, with λ per lane (one lane negative, so that its QuuF loses positive
definiteness and the lane diverges) and the previous sweep's k[T-1] as the
first QP's warm start. Every QP mode of the JAX scan runs: the iterative
box QP ("auto" at m ≥ 2 and "iterative"), "enum" (m ≤ 4; above it the
iterative QP), "pn_fixed", and the unconstrained Cholesky step; shared or
per-lane limits (both on the double integrator's iterative QP).

Tolerance: max |a − b| / (1 + |b|) ≤ 1e-4 on k, K and dV of the lanes that
did not diverge, diverged flags equal (the QPs' own rounding,
tests/test_torch_composable_boxqp.py, carried through T steps of V).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu.ops.backward import backward_pass as jax_backward_pass
from ilqr_tpu.types import Derivs as JaxDerivs
from ilqr_tpu_torch import SolverConfig, get_model
from ilqr_tpu_torch.ops import backward, kernel_derivs, kernel_rollout
from ilqr_tpu_torch.types import Derivs

B, T, DT = 8, 6, 0.05
TOL = 1e-4


def _problem(name, seed):
    model = get_model(name)
    n, m = model.n, model.m
    rng = np.random.default_rng(seed)
    xs = (0.5 * rng.normal(size=(B, T + 1, n))).astype(np.float32)
    us = (1.5 * rng.normal(size=(B, T, m))).astype(np.float32)
    pp = kernel_rollout.pack_params(model.default_params(), DT)
    d = kernel_derivs.derivs_batched(model, "euler", pp, torch.from_numpy(xs),
                                     torch.from_numpy(us))
    lam = rng.uniform(0.0, 2.0, size=B).astype(np.float32)
    lam[3] = -100.0
    prev = rng.normal(size=(B, m)).astype(np.float32)
    p, _dt = kernel_rollout.unpack_params(pp)
    lo = np.broadcast_to(p.u_min.numpy(), (B, m)).copy()
    hi = np.broadcast_to(p.u_max.numpy(), (B, m)).copy()
    lo[1::2] *= 0.5       # per-lane limits differ on every other lane
    return [a.numpy() for a in d], us, lam, prev, lo, hi


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / (1.0 + np.abs(want))


CASES = [("double_integrator", "auto", True, False),
         ("double_integrator", "auto", True, True),
         ("double_integrator", "enum", True, True),
         ("double_integrator", "pn_fixed", True, False),
         ("double_integrator", "auto", False, False),
         ("quadrotor", "iterative", True, True),
         ("quadrotor", "enum", True, False),
         ("quadrotor", "auto", False, False),
         ("omni_thruster", "auto", True, False),
         ("omni_thruster", "pn_fixed", True, True),
         ("omni_thruster", "enum", True, False),
         ("omni_thruster", "auto", False, False)]


@pytest.mark.parametrize("name,mode,use_limits,per_lane", CASES)
def test_backward_scan_matches_jax(name, mode, use_limits, per_lane):
    d, us, lam, prev, lo, hi = _problem(name, 5 + CASES.index(
        (name, mode, use_limits, per_lane)))
    if not per_lane:
        lo, hi = lo[0], hi[0]
    jcfg = JaxConfig(boxqp_mode=mode, use_control_limits=use_limits,
                     backward_kernel="xla")
    lim_ax = 0 if per_lane else None
    want = jax.vmap(
        lambda dd, u, lm, pk, a, b: jax_backward_pass(
            JaxDerivs(*dd), u, lm, a, b, jcfg, prev_k_last=pk),
        in_axes=(0, 0, 0, 0, lim_ax, lim_ax))(
            tuple(jnp.asarray(a) for a in d), us, lam, prev, lo, hi)
    cfg = SolverConfig(boxqp_mode=mode, use_control_limits=use_limits)
    t = torch.from_numpy
    got = backward.backward_pass(Derivs(*(t(a) for a in d)), t(us), t(lam),
                                 t(lo), t(hi), cfg, prev_k_last=t(prev))
    div = np.asarray(want.diverged)
    np.testing.assert_array_equal(got.diverged.numpy(), div)
    assert div[3] and not div.all()
    ok = ~div
    for what, g, w in (("k", got.k, want.k), ("K", got.K, want.K),
                       ("dV", got.dV, want.dV)):
        err = _rel(g.numpy()[ok], np.asarray(w)[ok])
        assert err.max() <= TOL, (what, float(err.max()))


def test_prev_k_last_warm_starts_the_first_qp():
    """The iterative QP at t = T−1 starts from the previous sweep's k[T-1]
    (clamped to the box), as the JAX scan does: another start changes its
    iterates, and the port follows JAX's for both."""
    d, us, lam, prev, lo, hi = _problem("quadrotor", 40)
    lam = np.abs(lam)
    cfg = SolverConfig(boxqp_mode="iterative")
    jcfg = JaxConfig(boxqp_mode="iterative", backward_kernel="xla")
    t = torch.from_numpy
    outs = []
    for start in (prev, 3.0 * prev):
        want = jax.vmap(
            lambda dd, u, lm, pk: jax_backward_pass(
                JaxDerivs(*dd), u, lm, lo[0], hi[0], jcfg, prev_k_last=pk))(
                    tuple(jnp.asarray(a) for a in d), us, lam, start)
        got = backward.backward_pass(
            Derivs(*(t(a) for a in d)), t(us), t(lam), t(lo[0]), t(hi[0]),
            cfg, prev_k_last=t(start))
        assert _rel(got.k.numpy(), want.k).max() <= TOL
        outs.append(got.k.numpy())
    assert np.abs(outs[0] - outs[1]).max() > 0


def test_unported_modes_raise():
    """Full DDP and the parallel-in-time assoc modes stay unported."""
    d, us, lam, prev, lo, hi = _problem("double_integrator", 50)
    t = torch.from_numpy
    for bad in (dict(full_ddp=True), dict(backward_mode="assoc"),
                dict(backward_mode="assoc_frozen")):
        with pytest.raises(NotImplementedError):
            backward.backward_pass(Derivs(*(t(a) for a in d)), t(us), t(lam),
                                   t(lo[0]), t(hi[0]), SolverConfig(**bad))
