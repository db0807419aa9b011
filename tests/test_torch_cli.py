"""``python -m ilqr_tpu_torch`` against ``python -m ilqr_tpu``, on the CPU.

- The parser: every option of the JAX CLI, with the same names, defaults,
  choices, types and actions (help texts and the program name differ), and
  the same canonical problems (``_PROBLEMS``), compared programmatically.
- ``--cpu integrator --quiet --max-iter 20`` against the reference binary's
  golden/integrator_golden.csv: controls within 1e-3 and the cost within
  1e-2 of 356.1685, as chip_smoke.py's phase 14(a) holds the card (f32
  ends at LAMBDA_MAX after 15 iterations, ROADMAP.md §C).
- A single pendulum solve and a batch of 4 (the composable path on the
  CPU in both CLIs) against the JAX CLI's ``main`` on the same arguments:
  the CSVs within 1e-4, |a − b| / (1 + |b|) (tests/test_torch_kernels.py's
  tolerance; both are printed to six decimals; measured: equal, and 2.4e-6
  / 3.9e-5 on the single solve's states / controls, which end on steps
  taken at an ulp of the cost). Both take analytic derivatives: the CLIs'
  default fd differs by algorithm at f32 rounding (the port's CPU route is
  the kernel's stencil, the JAX one its XLA differences), which the
  unconverged 5-iteration batch carries to 0.4 in a control at the same
  six-digit mean cost. The JAX CLI runs in f32 (the suite enables x64).
- The options the port does not carry raise before anything runs, and
  without ``--cpu`` and without a card it raises.
"""

import argparse

import jax
import numpy as np
import pytest
import torch

from ilqr_tpu import __main__ as jax_cli
from ilqr_tpu.utils.io import read_trajectory_csv as jax_read
from ilqr_tpu_torch import __main__ as cli
from ilqr_tpu_torch.ops import launch_counts, reset_launch_counts
from ilqr_tpu_torch.utils.io import read_trajectory_csv

TOL = 1e-4
GOLDEN_US_TOL, GOLDEN_COST, GOLDEN_COST_TOL = 1e-3, 356.1685, 1e-2

_FIELDS = ("dest", "option_strings", "default", "choices", "type", "nargs",
           "const", "required", "metavar")


def _actions(parser):
    return {a.dest: (type(a).__name__,) + tuple(
        getattr(a, f) for f in _FIELDS) for a in parser._actions
        if not isinstance(a, argparse._HelpAction)}


def test_parser_matches_jax():
    ours, theirs = _actions(cli.build_parser()), _actions(
        jax_cli.build_parser())
    assert ours == theirs
    assert cli.build_parser().prog == "python -m ilqr_tpu_torch"


def test_problems_match_jax():
    assert cli._PROBLEMS == jax_cli._PROBLEMS


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want) / (1.0 + np.abs(want))
    assert err.max(initial=0.0) <= TOL, (what, float(err.max()))


def test_integrator_matches_golden(tmp_path, capsys):
    out = str(tmp_path / "i.csv")
    assert cli.main(["--cpu", "integrator", "--quiet", "--max-iter", "20",
                     "--output", out]) == 0
    printed = capsys.readouterr().out
    cost = float(printed.split("Final cost:")[1].split()[0])
    assert abs(cost - GOLDEN_COST) <= GOLDEN_COST_TOL, cost
    xs, us = read_trajectory_csv(out, 4, 2)
    assert xs.shape == (100, 4) and us.shape == (99, 2)
    rows = [[float(v) for v in line.replace(",", " ").split()] for line in
            open("golden/integrator_golden.csv").read().splitlines()[1:]]
    golden_us = np.asarray([r[4:6] for r in rows[:-1]])
    assert np.abs(us - golden_us).max() <= GOLDEN_US_TOL


@pytest.mark.parametrize("argv, n, m", [
    (["pendulum", "--quiet", "-T", "60", "--max-iter", "15", "--deriv-mode",
      "analytic"], 2, 1),
    (["pendulum", "--batch", "4", "-T", "30", "--max-iter", "5",
      "--deriv-mode", "analytic"], 2, 1),
])
def test_csv_matches_jax_cli(argv, n, m, tmp_path, capsys):
    ours, theirs = str(tmp_path / "ours.csv"), str(tmp_path / "theirs.csv")
    assert cli.main(["--cpu", *argv, "--output", ours]) == 0
    with jax.enable_x64(False):   # the JAX CLI's own f32 (conftest: x64)
        assert jax_cli.main(["--cpu", *argv, "--output", theirs]) == 0
    capsys.readouterr()
    xs, us = read_trajectory_csv(ours, n, m)
    jxs, jus = jax_read(theirs, n, m)
    _close(xs, jxs, "xs")
    _close(us, jus, "us")
    with open(ours) as a, open(theirs) as b:
        assert a.readline() == b.readline()   # the header


@pytest.mark.parametrize("flags, err", [
    (["--x64"], NotImplementedError),
    (["--full-ddp"], NotImplementedError),
    (["--backward-mode", "assoc", "--no-control-limits"],
     NotImplementedError),
    (["--backward-mode", "assoc_frozen"], NotImplementedError),
    (["--backward-mode", "assoc"], SystemExit),   # the JAX CLI's own error
])
def test_unported_options_raise_before_running(flags, err, tmp_path):
    reset_launch_counts()
    with pytest.raises(err):
        cli.main(["integrator", "--quiet", *flags,
                  "--output", str(tmp_path / "x.csv")])
    assert not (tmp_path / "x.csv").exists()
    assert not any(launch_counts().values())


def test_without_cpu_flag_needs_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["integrator", "--quiet", "--output",
                  str(tmp_path / "x.csv")])
