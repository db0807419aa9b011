"""ilqr_tpu_torch's utilities and native runtime against the JAX package's,
on the CPU.

- io: a CSV round trip (six decimals: |a − b| ≤ 5e-7 + the f64 rounding of
  the parse), and the bytes of the port's native and Python writers equal
  to the JAX writer's on the same arrays.
- trajio: the native CSV's bytes equal the Python writer's and the JAX
  package's libtrajio's; the binary batch format equal in bytes to JAX's
  and read back bit for bit.
- checkpoint: a Solution and a fleet's MPCState saved and restored bit for
  bit, dtypes and devices kept.
- math: every helper against ``ilqr_tpu.utils.math`` on the same f32 numpy
  inputs (±0, NaN, ±∞, multiples of π), bit for bit but for NaN payloads.
- timing: PhaseTimer's report equal to JAX's for the same totals;
  profile_phases on the pendulum (T = 20) with the reference's TIMESTUFF
  phase names; the profiler trace reduced to its planes.
- plotting: a PNG, from arrays and from a CSV; without matplotlib, an
  ImportError.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilqr_tpu.utils import io as jax_io
from ilqr_tpu.utils import math as jax_math
from ilqr_tpu.utils import timing as jax_timing
from ilqr_tpu_torch import SolverConfig, get_model, mpc, solve_batch_fused
from ilqr_tpu_torch.models import pendulum as tpd
from ilqr_tpu_torch.runtime import trajio
from ilqr_tpu_torch.utils import checkpoint, io, plotting, timing
from ilqr_tpu_torch.utils import math as tmath


def _traj(seed=0, T=7, n=4, m=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T + 1, n)).astype(np.float32),
            rng.normal(size=(T, m)).astype(np.float32))


def test_csv_round_trip_and_bytes_equal_jax(tmp_path, monkeypatch):
    xs, us = _traj()
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    assert io.write_trajectory_csv(str(ours), torch.from_numpy(xs),
                                   torch.from_numpy(us)) == "native"
    jax_io.write_trajectory_csv(str(theirs), xs, us)
    assert ours.read_bytes() == theirs.read_bytes()
    x2, u2 = io.read_trajectory_csv(str(ours), 4, 2)
    assert np.abs(x2 - xs).max() <= 5e-7 + 1e-12
    assert np.abs(u2 - us).max() <= 5e-7 + 1e-12

    def no_native(*a, **k):
        raise OSError("no native writer")

    monkeypatch.setattr(trajio, "write_csv", no_native)
    python = tmp_path / "python.csv"
    assert io.write_trajectory_csv(str(python), xs, us) == "python"
    assert python.read_bytes() == theirs.read_bytes()


def test_trajio_bytes_equal_jax_libtrajio(tmp_path):
    jax_trajio = pytest.importorskip("ilqr_tpu.runtime.trajio")
    rng = np.random.default_rng(1)
    B, T, n, m = 3, 11, 4, 1
    xs, us = rng.normal(size=(B, T + 1, n)), rng.normal(size=(B, T, m))
    trajio.write_csv(str(tmp_path / "a.csv"), xs[0], us[0])
    jax_trajio.write_csv(str(tmp_path / "b.csv"), xs[0], us[0])
    assert ((tmp_path / "a.csv").read_bytes()
            == (tmp_path / "b.csv").read_bytes())
    trajio.write_batch(str(tmp_path / "a.ilqt"), torch.from_numpy(xs), us)
    jax_trajio.write_batch(str(tmp_path / "b.ilqt"), xs, us)
    assert ((tmp_path / "a.ilqt").read_bytes()
            == (tmp_path / "b.ilqt").read_bytes())
    x2, u2 = trajio.read_batch(str(tmp_path / "b.ilqt"))
    np.testing.assert_array_equal(x2, xs)
    np.testing.assert_array_equal(u2, us)
    x1, _u1 = trajio.read_batch(_one(tmp_path, xs[1], us[1]))
    assert x1.shape == (1, T + 1, n)
    np.testing.assert_array_equal(x1[0], xs[1])
    assert trajio.library_path().parts[-4:-2] == ("ilqr_tpu_torch",
                                                  "runtime")


def _one(tmp_path, xs, us):
    path = str(tmp_path / "one.ilqt")
    trajio.write_batch(path, xs, us)
    return path


def _leaves_equal(a, b):
    fa, fb = [], []
    checkpoint._flatten(a, fa)
    checkpoint._flatten(b, fb)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert type(x) is type(y)
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(torch.isnan(x), torch.isnan(y))
        assert torch.equal(x[~torch.isnan(x)], y[~torch.isnan(y)])


def test_checkpoint_solution_and_mpc_state_bitwise(tmp_path):
    model, params = get_model("pendulum"), tpd.default_params()
    cfg = SolverConfig(deriv_mode="analytic", clamp_forward=True, max_iter=3)
    rng = np.random.default_rng(2)
    x0 = (0.3 * rng.normal(size=(4, 2))).astype(np.float32)
    u0 = np.zeros((12, 1), np.float32)
    sol = solve_batch_fused(model, params, cfg, 0.05, x0, u0, device="cpu")
    path = str(tmp_path / "sol.npz")
    checkpoint.save(path, sol)
    assert not os.path.exists(path + ".tmp")
    back = checkpoint.restore(path, sol)
    assert type(back) is type(sol)
    _leaves_equal(back, sol)

    state = mpc.fleet_step(model, params, cfg, 0.05, mpc.fleet_init(
        model, params, cfg, 0.05, x0, u0, device="cpu"))
    checkpoint.save(path, state)
    back = checkpoint.restore(path, state)
    assert type(back.plan) is type(state.plan)
    _leaves_equal(back, state)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(path, sol)


def _math_inputs():
    rng = np.random.default_rng(3)
    special = np.asarray([0.0, -0.0, np.nan, np.inf, -np.inf, np.pi,
                          -np.pi, 2 * np.pi, 7 * np.pi, -6 * np.pi + 0.3,
                          1e-30, -1e30], np.float32)
    return np.concatenate([special, (10.0 * rng.normal(size=500))
                           .astype(np.float32)])


@pytest.mark.parametrize("name", ["sqr", "cube", "sgn", "smooth_abs",
                                  "wrap_to_pi", "angle_diff"])
def test_math_matches_jax_bitwise(name):
    x = _math_inputs()
    args = (x, x[::-1].copy()) if name == "angle_diff" else (x,)
    got = getattr(tmath, name)(*(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(getattr(jax_math, name)(*(jnp.asarray(a)
                                                  for a in args)))
    assert got.dtype == want.dtype == np.float32
    # NaNs in the same places (their payload bits are the libraries' own),
    # every other value bit for bit, signed zeros included
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32),
                          want[~nan].view(np.uint32))


def test_phase_timer_report_matches_jax():
    ours, theirs = timing.PhaseTimer(), jax_timing.PhaseTimer()
    for t in (ours, theirs):
        for name, secs in (("alpha", 0.25), ("beta", 1.5), ("alpha", 0.5)):
            t.totals[name] += secs
            t.counts[name] += 1
    assert ours.report() == theirs.report()
    with ours.phase("gamma", torch.zeros(1), None):
        pass
    assert ours.counts["gamma"] == 1


def test_profile_phases_reports_reference_breakdown():
    model, params = get_model("pendulum"), tpd.default_params()
    cfg = SolverConfig(deriv_mode="analytic", max_iter=10)
    timer, report = timing.profile_phases(
        model, params, cfg, 0.05, torch.zeros(2), torch.zeros((20, 1)),
        n_iters=2, device="cpu")
    for phase in ("derivatives", "backward_pass", "forward_pass", "other"):
        assert phase in report
        assert timer.counts[phase] == 2
    assert report.startswith("phase breakdown (seconds):")


def test_profile_trace_summary(tmp_path):
    with timing.profile(str(tmp_path)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    planes, path = timing.summarize_trace(str(tmp_path))
    assert path.endswith(".json")
    host = planes["/host:CPU"]
    assert host["n_events"] > 0 and host["n_lines"] >= 1
    assert {"name", "total_us", "count", "mean_us"} <= set(
        host["top_events"][0])
    assert any("mm" in e["name"] for e in host["top_events"])


def test_plots_write_png(tmp_path):
    pytest.importorskip("matplotlib")
    xs, us = _traj(seed=4, T=20)
    png = tmp_path / "traj.png"
    fig = plotting.plot_trajectory(torch.from_numpy(xs), us, dt=0.05,
                                   save_path=str(png))
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(fig.axes) == 2
    csv, png2 = tmp_path / "t.csv", tmp_path / "t.png"
    io.write_trajectory_csv(str(csv), xs, us)
    fig = plotting.plot_csv(str(csv), 4, 2, dt=0.05, save_path=str(png2))
    assert png2.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(fig.axes[0].lines) == 4 and len(fig.axes[1].lines) == 2


def test_plot_without_matplotlib_raises(monkeypatch):
    """As in the JAX package, a plot needs matplotlib: without it the
    import error reaches the caller."""
    xs, us = _traj(seed=5, T=30)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        plotting.plot_trajectory(xs, us, save_path="unused.png")
