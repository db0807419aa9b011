"""The fused solver's split sweep (``sweep_kernel="split"``: the derivative
stage once per iteration, then the m = 1 backward recursion per λ attempt)
for pendulum and cartpole, and RK4 in the derivative stage, against the JAX
package on the CPU.

- ``kernel_derivs.derivs_batched`` (on the CPU: the plain version of
  csrc/derivs.cuh) against ``pallas_derivs.derivs_batched`` in Pallas
  interpret mode: acrobot with RK4, pendulum and cartpole with Euler and
  RK4, in jvp mode at tests/test_pallas_derivs.py's atol 1e-4 and in fd
  mode at eps = 0.05 (acrobot's Euler cases are tests/test_torch_derivs.py).
- The m = 1 backward recursion at n = 2 (pendulum) against
  ``pallas_backward.backward_sweep_batched`` in interpret mode and the JAX
  scan oracle.
- Whole split-sweep solves of pendulum and cartpole (Euler and RK4,
  deriv_mode="analytic") against the JAX XLA ``solve_batch``: costs to
  rtol 1e-4, equal iteration counts (tests/test_fused_solver.py:31-47).

Inputs are drawn with numpy (B = 5 problems, T = 6) and handed to both
sides; params go through ``params_from_numpy``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu import SolverConfig as JaxConfig
from ilqr_tpu import get_model as jax_get_model
from ilqr_tpu.batch import solve_batch as jax_solve_batch
from ilqr_tpu.ops import pallas_backward, pallas_derivs
from ilqr_tpu_torch import SolverConfig, get_model, solve_batch_fused
from ilqr_tpu_torch.ops import kernel_backward, kernel_derivs, kernel_rollout
from ilqr_tpu_torch.ops import launch_counts, reset_launch_counts

B, T, DT, EPS = 5, 6, 0.02, 0.05
JVP_ATOL = 1e-4   # tests/test_pallas_derivs.py's bound for the kernel
FD_ULPS = 8
NAMES = ("fx", "fu", "cx", "cu", "cxx", "cxu", "cuu")


def _params(name):
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                jax_get_model(name).default_params())
    mod = importlib.import_module(f"ilqr_tpu_torch.models.{name}")
    return jax.tree_util.tree_map(jnp.asarray, jp), mod.params_from_numpy(jp)


def _inputs(name, seed):
    n = get_model(name).n
    rng = np.random.default_rng(seed)
    xs = (0.5 * rng.normal(size=(B, T + 1, n))).astype(np.float32)
    us = (2.0 * rng.normal(size=(B, T, 1))).astype(np.float32)
    return xs, us


def _fd_tolerances(name, tp, xs, us):
    """Per-output absolute tolerance: FD_ULPS ulps of the largest function
    value each stencil differences, over its denominator (an ulp of f that
    XLA and PyTorch round differently becomes ulp(f)/(2·eps) in a gradient
    and ulp(f)/(4·eps²) in a Hessian)."""
    tm = get_model(name)
    p = tp
    x = torch.from_numpy(xs).permute(2, 0, 1)            # (n, B, T+1)
    u = torch.from_numpy(us).permute(2, 0, 1)
    run = tm.cost_soa(p, x[:, :, :-1], u).abs().max().item()
    fin = tm.final_cost_soa(p, x[:, :, -1]).abs().max().item()
    step = np.abs(xs).max() + 1.0
    ulp = lambda f: FD_ULPS * float(np.spacing(np.float32(f)))
    g, h = 2.0 * EPS, 4.0 * EPS * EPS
    return {"fx": ulp(step) / g, "fu": ulp(step) / g,
            "cx": (ulp(run) / g, ulp(fin) / g), "cu": ulp(run) / g,
            "cxx": (ulp(run) / h, ulp(fin) / h), "cxu": ulp(run) / h,
            "cuu": ulp(run) / h}


def _fd_close(got, want, what, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if isinstance(tol, tuple):       # running rows, then the terminal row
        np.testing.assert_allclose(got[:, :-1], want[:, :-1], rtol=0,
                                   atol=tol[0], err_msg=what)
        np.testing.assert_allclose(got[:, -1], want[:, -1], rtol=0,
                                   atol=tol[1], err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("name,integrator,mode", [
    ("acrobot", "rk4", "jvp"), ("acrobot", "rk4", "fd"),
    ("pendulum", "euler", "jvp"), ("pendulum", "euler", "fd"),
    ("pendulum", "rk4", "jvp"), ("pendulum", "rk4", "fd"),
    ("cartpole", "euler", "jvp"), ("cartpole", "euler", "fd"),
    ("cartpole", "rk4", "jvp"), ("cartpole", "rk4", "fd")])
def test_derivs_plain_matches_pallas(name, integrator, mode):
    """Every output, the terminal row included: jvp mode to atol 1e-4, fd
    mode (eps = 0.05) to FD_ULPS ulps of the differenced values over the
    stencil's denominator. Measured in jvp mode max |a − b|: acrobot RK4
    3.0e-8, pendulum 0 / 3.0e-8, cartpole 6.0e-8 / 6.0e-8 (Euler / RK4)."""
    jp, tp = _params(name)
    xs, us = _inputs(name, 21)
    want = pallas_derivs.derivs_batched(
        jax_get_model(name), integrator, jp, DT, jnp.asarray(xs),
        jnp.asarray(us), mode=mode, eps=EPS, interpret=True)
    reset_launch_counts()
    got = kernel_derivs.derivs_batched(
        get_model(name), integrator, kernel_rollout.pack_params(tp, DT),
        torch.from_numpy(xs), torch.from_numpy(us), mode=mode, eps=EPS)
    assert launch_counts()["derivs_packed"] == 0
    tols = _fd_tolerances(name, tp, xs, us)
    for what, g, w in zip(NAMES, got, want):
        if mode == "jvp":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=JVP_ATOL, err_msg=what)
        else:
            _fd_close(g, w, what, tols[what])
    if integrator == "rk4":   # the RK4 step's Jacobian, not the Euler one's
        euler = kernel_derivs.derivs_batched(
            get_model(name), "euler", kernel_rollout.pack_params(tp, DT),
            torch.from_numpy(xs), torch.from_numpy(us), mode=mode, eps=EPS)
        assert np.abs(euler[0].numpy() - got[0].numpy()).max() > 1e-4


def test_backward_n2_matches_pallas_and_scan():
    """The plain m = 1 backward recursion at n = 2 (pendulum, the
    derivatives of the plain jvp stage on a random trajectory with large
    controls, so that some steps clamp at the ±2.5 box; λ = −100 on one lane
    fires the divergence latch) against the JAX kernel in interpret mode,
    max |a − b| / (1 + |b|) ≤ 1e-6 (the same operations in the same order;
    measured 1.0e-7, on dV), and against the JAX scan oracle ≤ 1e-4
    (measured 1.0e-7)."""
    _jp, tp = _params("pendulum")
    rng = np.random.default_rng(30)
    xs = (0.5 * rng.normal(size=(B, T + 1, 2))).astype(np.float32)
    us = (3.0 * rng.normal(size=(B, T, 1))).astype(np.float32)
    d = kernel_derivs.derivs_batched(
        get_model("pendulum"), "euler", kernel_rollout.pack_params(tp, DT),
        torch.from_numpy(xs), torch.from_numpy(us))
    d = [np.ascontiguousarray(a.numpy()) for a in d]
    lo = (float(tp.u_min[0]) - us).astype(np.float32)
    hi = (float(tp.u_max[0]) - us).astype(np.float32)
    lam = np.ones(B, np.float32)
    lam[1] = 1e-3
    lam[3] = -100.0
    reset_launch_counts()
    got = kernel_backward.backward_sweep_batched(
        *(torch.from_numpy(a) for a in (*d, lo, hi, lam)))
    assert launch_counts()["backward_sweep_packed"] == 0
    jargs = [jnp.asarray(a) for a in (*d, lo, hi, lam)]
    want = pallas_backward.backward_sweep_batched(*jargs, interpret=True)
    scan = jax.vmap(pallas_backward._backward_m1_scan)(*jargs)
    for i, what in enumerate(("k", "K", "dV")):
        g = got[i].numpy().astype(np.float64)
        for ref, tol in ((want[i], 1e-6), (scan[i], 1e-4)):
            r = np.asarray(ref, np.float64)
            assert g.shape == r.shape, what
            err = np.abs(g - r) / (1.0 + np.abs(r))
            assert err.max() <= tol, (what, float(err.max()))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[3].numpy()[3] and not got[3].numpy()[0]
    k = got[0].numpy()[[0, 1, 2, 4]] + us[[0, 1, 2, 4]]
    # the box binds somewhere
    assert np.any(np.isclose(np.abs(k), float(tp.u_max[0])))


XLA = dict(backward_kernel="xla", rollout_kernel="xla", deriv_kernel="xla")


def _case(name):
    """(x0, T, dt, max_iter) of the JAX package's fused test of ``name``
    (tests/test_torch_fused_models.py)."""
    if name == "cartpole":
        return 0.3 * np.random.default_rng(3).normal(size=(4, 4)), 12, 0.02, 6
    return np.zeros((2, 2)), 10, 0.05, 10


@pytest.mark.parametrize("name", ["pendulum", "cartpole"])
@pytest.mark.parametrize("integrator", ["euler", "rk4"])
def test_split_sweep_solve_matches_jax_xla(name, integrator):
    """The split sweep's whole solve (derivative stage in jvp mode, the
    backward recursion, the line search) with deriv_mode="analytic" against
    the JAX XLA solve_batch on the JAX fused tests' inputs: costs to rtol
    1e-4, equal iteration counts, controls within 5e-3. Measured (costs
    relative, controls absolute): pendulum 0 and 0 (Euler), 0 and 1.1e-6
    (RK4); cartpole 0 and 4.3e-6, 1.9e-7 and 8.9e-6."""
    x0, t, dt, max_iter = _case(name)
    x0 = x0.astype(np.float32)
    u0 = np.zeros((t, 1), np.float32)
    jp, tp = _params(name)
    kw = dict(deriv_mode="analytic", integrator=integrator,
              clamp_forward=True, max_iter=max_iter,
              alphas=(1.0, 0.3, 0.03))
    ref = jax_solve_batch(jax_get_model(name), jp, JaxConfig(**XLA, **kw),
                          dt, jnp.asarray(x0), jnp.asarray(u0))
    reset_launch_counts()
    got = solve_batch_fused(get_model(name), tp,
                            SolverConfig(sweep_kernel="split", **kw), dt, x0,
                            u0, device="cpu")
    assert launch_counts()["derivs_packed"] == 0
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-4)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(ref.iterations))
    assert np.abs(got.us.numpy() - np.asarray(ref.us)).max() < 5e-3
