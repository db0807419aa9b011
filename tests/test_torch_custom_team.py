"""Which kernels a custom model's library launches: the team kernels of the
package's models where the model's n and m fit them, by a rule its
generated header applies at compile time (csrc/custom.cuh
``team_iteration``, ops/codegen.py), and ``chip_smoke.launched_kernel``,
which names the kernel each launcher runs, follows the same rule.

- The line search is the team of csrc/linesearch_team.cuh for every
  model: the one-thread kernel is gone.
- The whole iteration, and the split sweep of the stencils and the dual
  numbers, are the team of csrc/iteration_team.cuh where m·n < 32,
  2(n + m) ≤ 32 and m(n + 1) ≤ 32: 16 threads a lane where half a warp
  holds the stencil's sides, the cost-Hessian pairs and a gain row one a
  thread (team::kTeamWidth), else 32. Outside the rule (m = 1 with n ≥ 16,
  m = 3 with n = 10, every m·n ≥ 32) the one-thread kernels.

The headers are held to the rule over a grid of (n, m), inside and outside
its limits; g++ checks what the C++ computes from them (the rule and
kTeamWidth as the sources write them) against the same table. Runs on the
CPU in seconds; ``dense_model`` is also the test-registered model of
tests/test_torch_cuda_custom_team.py.
"""

import re
import shutil
import subprocess
from typing import NamedTuple

import pytest
import torch

import chip_smoke
from ilqr_tpu_torch.models.base import Model
from ilqr_tpu_torch.ops import _build, codegen

# (n, m): inside the team's rule at 16 and at 32 threads, and outside it
GRID = {(1, 1): 16, (2, 1): 16, (3, 1): 16, (3, 2): 16, (4, 1): 16,
        (4, 2): 32, (6, 3): 32, (5, 1): 32, (7, 4): 32, (15, 1): 32,
        (7, 1): 32, (6, 4): 32, (16, 1): 1, (10, 3): 1, (8, 4): 1,
        (12, 4): 1, (6, 6): 1, (2, 16): 1}


class DenseParams(NamedTuple):
    goal: torch.Tensor   # (n,)
    w: torch.Tensor      # (n,) state weights
    r: torch.Tensor      # (m,) control weights
    u_min: torch.Tensor  # (m,)
    u_max: torch.Tensor  # (m,)


def dense_model(n: int, m: int, name: str = None) -> Model:
    """A custom model with n states and m controls whose Jacobians and
    cost Hessians are dense: ẋ_i = u_{i mod m} · cos(x_{i+1 mod n}) −
    0.3 · x_i · u_{i+1 mod m} + 0.1 · sin(x_i), cost Σ w_i (x_i − g_i)² +
    Σ r_j u_j² + 0.05 · x_0 · u_0, final cost 10 Σ w_i (x_i − g_i)²; its
    SoA functions are its functions (leading axes only)."""

    def params():
        return DenseParams(
            goal=torch.linspace(-0.5, 0.5, n), w=torch.linspace(1.0, 2.0, n),
            r=torch.full((m,), 0.1), u_min=torch.full((m,), -1.5),
            u_max=torch.full((m,), 1.0))

    def dynamics(p, x, u):
        return torch.stack([
            u[i % m] * torch.cos(x[(i + 1) % n])
            - 0.3 * x[i] * u[(i + 1) % m] + 0.1 * torch.sin(x[i])
            for i in range(n)])

    def err(p, x):
        out = 0.0
        for i in range(n):
            e = x[i] - p.goal[i]
            out = out + p.w[i] * e * e
        return out

    def cost(p, x, u):
        c = err(p, x) + 0.05 * x[0] * u[0]
        for j in range(m):
            c = c + p.r[j] * u[j] * u[j]
        return c

    def final_cost(p, x):
        return 10.0 * err(p, x)

    return Model(name=name or f"dense_n{n}_m{m}", n=n, m=m,
                 dynamics=dynamics, cost=cost, final_cost=final_cost,
                 default_params=params, dynamics_soa=dynamics,
                 cost_soa=cost, final_cost_soa=final_cost)


def spec_width(n: int, m: int) -> int:
    """The rule as the package's team models meet it, written out."""
    if not (m * n < 32 and 2 * (n + m) <= 32 and m * (n + 1) <= 32):
        return 1
    nz = n + m
    return 16 if (2 * nz <= 16 and nz * (nz + 1) // 2 <= 16
                  and m * (n + 1) <= 16) else 32


def test_grid_is_the_rule():
    """GRID's widths are the rule's, and it has both widths and both sides
    of each limit: m·n ≥ 32, 2(n + m) > 32 with m·n < 32 (m = 1, n = 16),
    m(n + 1) > 32 with the other two held (m = 3, n = 10)."""
    assert all(spec_width(n, m) == w for (n, m), w in GRID.items())
    assert {16, 32, 1} == set(GRID.values())
    assert GRID[(16, 1)] == 1 and 16 * 1 < 32 and 2 * 17 > 32
    assert GRID[(10, 3)] == 1 and 30 < 32 and 2 * 13 <= 32 and 3 * 11 > 32


@pytest.mark.parametrize("n, m", sorted(GRID))
def test_generated_header_declares_the_team_rule(n, m):
    """The generated header declares kTeamIteration from its own N and M by
    custom::team_iteration (no list of names), derives from DensePattern,
    which keeps every custom model off the m·n ≥ 32 warp, and
    codegen.team_width gives the table's width."""
    text = codegen.emit_header(codegen.record(dense_model(n, m)))
    assert f"static constexpr int N = {n};" in text
    assert f"static constexpr int M = {m};" in text
    assert re.findall(r"static constexpr bool kTeamIteration = ([^;]*);",
                      text) == ["custom::team_iteration(N, M)"]
    assert "struct Model : custom::DensePattern" in text
    assert "kTeamSweep" not in text and "kTeamLineSearch" not in text
    assert codegen.team_width(n, m) == GRID[(n, m)]


@pytest.mark.parametrize("n, m", sorted(GRID))
def test_launched_kernel_follows_the_team_rule(n, m, monkeypatch):
    """chip_smoke names, for a registered custom model of that (n, m), the
    team of its width for the whole iteration and the dense split sweeps,
    the one-thread kernels outside the rule and for the closed forms a
    custom model does not have, never a warp; the line search's team
    always."""
    from ilqr_tpu_torch.models import _REGISTRY

    model = dense_model(n, m)
    monkeypatch.setitem(_REGISTRY, model.name, model)
    width = GRID[(n, m)]
    team = width > 1
    assert chip_smoke.team_width(model) == (width if team else 0)
    assert chip_smoke.launched_kernel("linesearch", model) == (
        "linesearch_team_kernel")
    assert chip_smoke.launched_kernel("iteration", model, "jvp") == (
        "iteration_team_kernel" if team else "iteration_kernel")
    for form in ("fd", "jvp"):
        assert chip_smoke.launched_kernel("sweep", model, form) == (
            "sweep_small_team_kernel" if team else "sweep_kernel")
        assert chip_smoke.launched_kernel("iteration", model, form) == (
            "iteration_team_kernel" if team else "iteration_kernel")
    assert chip_smoke.launched_kernel("sweep", model) == "sweep_kernel"
    assert chip_smoke.held_bitwise(
        chip_smoke.launched_kernel("iteration", model, "fd")) == team


def test_example_models_take_the_half_warp_team():
    """The example's unicycle (n = 3, m = 2) and unicycle_heading (n = 3,
    m = 1) take 16 threads a lane, and chip_smoke holds their phase-3 team
    rows bit for bit; a package model's pick is unchanged."""
    models = chip_smoke.custom_models()
    for name in ("unicycle", "unicycle_heading"):
        assert chip_smoke.team_width(models[name]) == 16
        for kind in ("iteration", "linesearch"):
            assert chip_smoke.held_bitwise(
                chip_smoke.launched_kernel(kind, models[name], "jvp"))
    from ilqr_tpu_torch import get_model

    assert chip_smoke.team_width(get_model("point_mass_3d")) == 32
    assert chip_smoke.launched_kernel(
        "iteration", get_model("quadrotor"), "fd") == "iteration_warp_kernel"


def test_team_rule_compiles_to_the_table():
    """g++ (syntax only) on csrc/custom.cuh and every GRID header: each
    Model::kTeamIteration is the table's (width > 1), and where it holds,
    iteration_team.cuh's kTeamWidth expression, as the source writes it,
    gives the table's width; the warp kernels' TeamSweep stays false."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the generated headers")
    csrc = _build.CSRC
    width = re.search(r"constexpr int kTeamWidth =([^;]*);",
                      (csrc / "iteration_team.cuh").read_text()).group(1)
    parts = ['#include "custom.cuh"', "constexpr int kTeam = 16;",
             f"template <class Model> constexpr int kTeamWidth ={width};"]
    for (n, m), w in sorted(GRID.items()):
        ns = f"grid_{n}_{m}"
        text = codegen.emit_header(codegen.record(dense_model(n, m)))
        text = (text.replace("#pragma once", "")
                .replace('#include "custom.cuh"', "")
                .replace("namespace custom_model", f"namespace {ns}"))
        parts += [text,
                  f"static_assert({ns}::Model::kTeamIteration == "
                  f"{'true' if w > 1 else 'false'});",
                  f"static_assert(!{ns}::Model::kTeamSweep);"]
        if w > 1:
            parts.append(f"static_assert(kTeamWidth<{ns}::Model> == {w});")
    proc = subprocess.run(
        [gxx, "-std=c++17", "-fsyntax-only", "-x", "c++", "-include",
         "cmath", "-D__host__=", "-D__device__=",
         "-D__forceinline__=inline", "-D__restrict__=", f"-I{csrc}", "-"],
        input="\n".join(parts), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
