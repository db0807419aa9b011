"""ilqr_tpu_torch stands alone: it imports neither JAX nor ilqr_tpu, runs on
the card unless asked for the CPU, and on the CPU never touches a kernel."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from ilqr_tpu_torch import (
    SolverConfig,
    get_model,
    solve,
    solve_batch,
    solve_batch_fused,
)
from ilqr_tpu_torch.models import acrobot as tac
from ilqr_tpu_torch.ops import (
    KERNEL_OPS,
    _build,
    kernel_backward,
    kernel_derivs,
    kernel_iter,
    kernel_rollout,
    kernel_sweep,
    launch_counts,
    reset_launch_counts,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = """
import sys
{imports}
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "ilqr_tpu" or m.startswith("ilqr_tpu."))
print("BAD", bad)
"""


def _run(code, cwd=REPO, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra_env or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("imports", [
    "import ilqr_tpu_torch, ilqr_tpu_torch.fused, ilqr_tpu_torch.ops\n"
    "import ilqr_tpu_torch.models.acrobot, ilqr_tpu_torch.ops._build\n"
    "import ilqr_tpu_torch.batch, ilqr_tpu_torch.solver\n"
    "import ilqr_tpu_torch.ops.derivatives, ilqr_tpu_torch.ops.backward\n"
    "import ilqr_tpu_torch.ops.rollout, ilqr_tpu_torch.ops.kernel_derivs\n"
    "import ilqr_tpu_torch.ops.kernel_backward, ilqr_tpu_torch.ops.qp\n"
    "import ilqr_tpu_torch.models.double_integrator\n"
    "import ilqr_tpu_torch.models.point_mass_3d\n"
    "import ilqr_tpu_torch.models.quadrotor\n"
    "import ilqr_tpu_torch.models.omni_thruster\n"
    "import ilqr_tpu_torch.models.free_flyer\n"
    "import ilqr_tpu_torch.models.thruster_ring",
    "import chip_smoke",
    "import ilqr_tpu_torch.ops.boxqp, ilqr_tpu_torch.mpc\n"
    "import ilqr_tpu_torch.models.bicycle, ilqr_tpu_torch.models.power_mass",
    "import ilqr_tpu_torch.ops.codegen, ilqr_tpu_torch.examples\n"
    "import ilqr_tpu_torch.examples.custom_model as cm\n"
    "cm.register_models()\n"
    "ilqr_tpu_torch.ops._build.model_sources(cm.UNICYCLE_HEADING)",
    "import ilqr_tpu_torch.__main__, ilqr_tpu_torch.utils\n"
    "import ilqr_tpu_torch.utils.io, ilqr_tpu_torch.utils.math\n"
    "import ilqr_tpu_torch.utils.checkpoint, ilqr_tpu_torch.utils.timing\n"
    "import ilqr_tpu_torch.utils.plotting, ilqr_tpu_torch.runtime\n"
    "import ilqr_tpu_torch.runtime.trajio\n"
    "import ilqr_tpu_torch.examples.quadrotor_waypoints\n"
    "import ilqr_tpu_torch.examples.free_flyer_docking\n"
    "import ilqr_tpu_torch.examples.mpc_fleet\n"
    "import os, tempfile\n"
    "ilqr_tpu_torch.__main__.main(['--cpu', 'integrator', '--quiet',\n"
    "    '--max-iter', '2', '-T', '5', '--output',\n"
    "    os.path.join(tempfile.mkdtemp(), 'x.csv')])",
])
def test_imports_no_jax_nor_ilqr_tpu(imports):
    out = _run(_NO_JAX.format(imports=imports))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("entry", ["solve_batch_fused", "solve_batch",
                                   "solve"])
def test_default_device_is_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    fn = {"solve_batch_fused": solve_batch_fused, "solve_batch": solve_batch,
          "solve": solve}[entry]
    x0 = np.zeros((4,) if entry == "solve" else (2, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(get_model("acrobot"), tac.default_params(),
           SolverConfig(max_iter=1), 0.02, x0, np.zeros((5, 1), np.float32))


def test_chip_smoke_refuses_without_card_or_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    out = _run("import runpy; runpy.run_path('chip_smoke.py', "
               "run_name='__main__')")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the package beside it
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_cpu_tensors_run_plain_versions_and_launch_nothing(monkeypatch):
    """Every op, given CPU tensors, returns its plain version's result and
    never reaches the kernel library."""
    def no_kernels(*a, **k):
        raise AssertionError("a kernel launcher was called for CPU tensors")

    monkeypatch.setattr(_build, "launch", no_kernels)
    monkeypatch.setattr(_build, "library", no_kernels)
    reset_launch_counts()
    T, N, M, B = 5, 4, 1, 6
    rng = np.random.default_rng(0)
    f = lambda *s, sc=0.3: torch.as_tensor(
        (sc * rng.normal(size=s)).astype(np.float32))
    pp = kernel_rollout.pack_params(tac.default_params(), 0.02)
    m = tac.MODEL
    x0, us, xs, xT = f(N, B), f(T, M, B, sc=2.0), f(T, N, B), f(N, B)
    K, k = f(T, M, N, B, sc=0.1), f(T, M, B)
    lam, live = torch.ones(B), (torch.arange(B) % 2).float()
    al = torch.tensor([1.0, 0.5, 0.1])
    dv, cprev = torch.stack([-torch.ones(B), 0.1 * torch.ones(B)]), f(B)
    xs_full = torch.cat([xs, xT[None]])
    d = kernel_derivs.derivs_plain(m, "euler", pp, xs_full, us)
    bargs = (d[0], d[1][:, :, 0], d[2][:-1], d[3][:, 0], d[4][:-1],
             d[5][:, :, 0], d[6][:, 0, 0], -5.0 - us[:, 0], 5.0 - us[:, 0],
             lam, d[2][-1], d[4][-1])
    cases = [
        (kernel_rollout.rollout_packed, kernel_rollout.rollout_plain,
         (m, "euler", True, pp, x0, us, xs, K)),
        (kernel_sweep.sweep_packed, kernel_sweep.sweep_plain,
         (m, "euler", pp, xs, xT, us, lam)),
        (kernel_rollout.linesearch_packed, kernel_rollout.linesearch_plain,
         (m, "euler", True, pp, x0, us, xs, xT, K, k, K, k, al, dv, cprev,
          live, live, 0.0)),
        (kernel_iter.iteration_packed, kernel_iter.iteration_plain,
         (m, "euler", True, pp, x0, xs, xT, us, k, K, lam, cprev, live, al)),
        (kernel_derivs.derivs_packed, kernel_derivs.derivs_plain,
         (m, "euler", pp, xs_full, us, "jvp")),
        (kernel_derivs.derivs_packed, kernel_derivs.derivs_plain,
         (m, "euler", pp, xs_full, us, "fd")),
        (kernel_backward.backward_sweep_packed,
         kernel_backward.backward_plain, bargs),
    ]
    for op, plain, args in cases:
        for g, w in zip(op(*args), plain(*args)):
            assert torch.equal(g, w), op.__name__
    # and whole solves on every path
    cfg = SolverConfig(max_iter=2, clamp_forward=True, alphas=(1.0, 0.3))
    x0b, u0 = np.zeros((2, 4), np.float32), np.zeros((5, 1), np.float32)
    solve_batch(m, tac.default_params(), cfg, 0.02, x0b, u0, device="cpu")
    solve(m, tac.default_params(), cfg, 0.02, x0b[0], u0, device="cpu")
    for extra in ({}, dict(iter_kernel="split"), dict(sweep_kernel="split")):
        solve_batch_fused(m, tac.default_params(), cfg.replace(**extra), 0.02,
                          x0b, u0, device="cpu")
    assert launch_counts() == {op.__name__: 0 for op in KERNEL_OPS}
    assert len(KERNEL_OPS) == 6


@pytest.mark.parametrize("case", [
    "other_model", "guards_take_rk4", "derivs_refuses_rk4", "analytic_rk4",
    "split_rk4", "jvp_without_jac_soa"])
def test_kernel_path_rejects_other_models_and_integrators(case, monkeypatch):
    """The CUDA kernels are compiled for the registered models and take the
    Euler or the RK4 step: the rollout, line-search, sweep and iteration
    guards accept rk4 in both derivative modes, and derivs_packed takes it
    (its kernel instantiated for every model of the package, an unregistered
    other raising NotImplementedError before a launch).
    solve_batch_fused carries analytic + RK4 (the in-kernel JVP route) and
    RK4 on the split sweep: each reaches its first stage with the RK4 step
    (every stage a tripwire that records its integrator). A jvp request
    without jac_soa (a custom model) takes the dual numbers with the Euler
    step: it reaches its first stage too. Checked without a card through
    the guards the wrappers call first."""
    pp = kernel_rollout.pack_params(tac.default_params(), 0.02)
    dev = pp.vec.device
    if case == "other_model":
        other = tac.MODEL.__class__(**{**tac.MODEL.__dict__, "name": "other"})
        with pytest.raises(NotImplementedError, match="acrobot"):
            kernel_rollout.require_kernel_model(other, "euler", pp, dev)
        kernel_rollout.require_kernel_model(tac.MODEL, "euler", pp, dev)
    elif case == "guards_take_rk4":
        assert kernel_rollout.require_kernel_model(
            tac.MODEL, "rk4", pp, dev) == "ilqr_acrobot"
        assert kernel_rollout.scheme("rk4") == 1
        kernel_sweep.check_supported(tac.MODEL, "rk4", "fd")
        kernel_sweep.check_supported(tac.MODEL, "rk4", "jvp")
        assert kernel_sweep.kernel_args("jvp", "rk4", 1e-3) == ("_jvp", (1,))
        assert kernel_sweep.kernel_args("jvp", "euler", 1e-3) == ("", ())
        with pytest.raises(ValueError, match="integrator"):
            kernel_rollout.require_kernel_model(tac.MODEL, "midpoint", pp,
                                                dev)
    elif case == "derivs_refuses_rk4":
        # carried now: the plain version runs RK4, and the kernel's guard
        # takes it for the split sweep's models
        xs, us = 0.1 * torch.ones(6, 4, 2), torch.zeros(5, 1, 2)
        for mode in ("jvp", "fd"):
            out = kernel_derivs.derivs_packed(tac.MODEL, "rk4", pp, xs, us,
                                              mode=mode)
            euler = kernel_derivs.derivs_plain(tac.MODEL, "euler", pp, xs,
                                               us, mode=mode)
            assert [tuple(a.shape) for a in out] == [
                tuple(a.shape) for a in euler]
            assert not torch.equal(out[0], euler[0])   # fx is the RK4 step's
        assert set(kernel_derivs.DERIVS_KERNEL_MODELS) == set(
            kernel_rollout.FUSED_KERNEL_MODELS)
        for name in kernel_derivs.DERIVS_KERNEL_MODELS:
            mm = get_model(name)
            ppm = kernel_rollout.pack_params(mm.default_params(), 0.02)
            kernel_rollout.require_kernel_model(
                mm, "rk4", ppm, dev, have=kernel_derivs.DERIVS_KERNEL_MODELS)
        bi = get_model("bicycle")
        other = bi.__class__(**{**bi.__dict__, "name": "other"})
        ppb = kernel_rollout.pack_params(bi.default_params(), 0.02)
        monkeypatch.setattr(kernel_derivs, "on_cuda", lambda t: True)
        monkeypatch.setattr(kernel_derivs._build, "launch",
                            lambda *a: pytest.fail("launched"))
        with pytest.raises(NotImplementedError, match="bicycle"):
            kernel_derivs.derivs_packed(other, "rk4", ppb,
                                        torch.zeros(6, 4, 2),
                                        torch.zeros(5, 2, 2))
    else:
        from ilqr_tpu_torch import fused

        class Reached(Exception):
            pass

        def tripwire(*a, **k):
            raise Reached(a[1])   # the integrator every stage takes second

        for name in ("rollout_packed", "iteration_packed", "sweep_packed",
                     "linesearch_packed", "derivs_packed",
                     "backward_sweep_packed"):
            monkeypatch.setattr(fused, name, tripwire)
        model = tac.MODEL
        cfg = {
            "analytic_rk4": SolverConfig(integrator="rk4"),
            "split_rk4": SolverConfig(deriv_mode="fd", integrator="rk4",
                                      sweep_kernel="split"),
            "jvp_without_jac_soa": SolverConfig(),
        }[case]
        args = (tac.default_params(), cfg, 0.02,
                np.zeros((2, 4), np.float32), np.zeros((5, 1), np.float32))
        if case == "jvp_without_jac_soa":
            model = tac.MODEL.__class__(**{**tac.MODEL.__dict__,
                                           "jac_soa": None})
            assert fused.fused_applicable(model, cfg)
            with pytest.raises(Reached, match="euler"):
                solve_batch_fused(model, *args, device="cpu")
            # the sweep launches its dual-number kernel for such a model
            assert kernel_sweep.kernel_args("jvp", "euler", 1e-3,
                                            model) == ("_jvp", (0,))
        else:
            assert fused.fused_applicable(model, cfg)
            with pytest.raises(Reached, match="rk4"):
                solve_batch_fused(model, *args, device="cpu")
            # on the card the split sweep's kernels exist for this model
            fused._check_kernels(model, cfg, torch.device("cuda"))


def test_every_cuda_source_is_built_and_packaged():
    """Each csrc/*.cu and *.cuh is one of the build's sources (a header
    change rebuilds) and lies under the package data of pyproject.toml (a
    wheel carries it); each model with fused kernels has its own .cu, and
    its stencil (fd) and dual-number (jvp) instantiations a
    kernels_<model>_fd.cu and a kernels_<model>_jvp.cu of their own (the
    quadrotor's iteration kernels apart, in kernels_<model>_iteration_fd.cu
    and kernels_<model>_iteration_jvp.cu), so that they compile in
    parallel; derivs_<model>.cu instantiates the derivative kernel
    (derivs.cuh) for each model of DERIVS_KERNEL_MODELS, one source each,
    and backward.cu the backward kernel for each n of
    BACKWARD_KERNEL_NS."""
    import fnmatch
    import tomllib

    csrc = _build.CSRC
    on_disk = sorted(csrc.glob("*.cu*"))
    assert on_disk and sorted(_build.sources()) == on_disk
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    patterns = data["ilqr_tpu_torch"]
    for path in on_disk:
        rel = path.relative_to(csrc.parent).as_posix()
        assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), rel
    units = {p.name for p in csrc.glob("*.cu")}
    for name in kernel_rollout.FUSED_KERNEL_MODELS:
        unit = "kernels.cu" if name == "acrobot" else f"kernels_{name}.cu"
        assert unit in units, name
        text = (csrc / unit).read_text()
        apart = csrc / f"kernels_{name}_iteration.cu"
        if apart.exists():   # the iteration kernels compile in parallel
            assert f"ILQR_SPLIT_LAUNCHERS({name}," in text
            assert f"ILQR_ITERATION_LAUNCHER({name}," in apart.read_text()
        else:
            assert f"ILQR_FUSED_LAUNCHERS({name}," in text
        for mode in ("fd", "jvp"):
            text = (csrc / f"kernels_{name}_{mode}.cu").read_text()
            apart = csrc / f"kernels_{name}_iteration_{mode}.cu"
            macro = f"ILQR_{mode.upper()}"
            if apart.exists():
                assert f"{macro}_SWEEP_LAUNCHER({name}," in text
                assert (f"{macro}_ITERATION_LAUNCHER({name},"
                        in apart.read_text())
            else:
                assert f"{macro}_LAUNCHERS({name}," in text
    for name in kernel_derivs.DERIVS_KERNEL_MODELS:
        derivs = (csrc / f"derivs_{name}.cu").read_text()
        assert f"ILQR_DERIVS_LAUNCHER({name}, " in derivs
        assert '#include "derivs.cuh"' in derivs
    backward = (csrc / "backward.cu").read_text()
    for n in kernel_backward.BACKWARD_KERNEL_NS:
        assert f"ILQR_BACKWARD_LAUNCHER({n})" in backward
        assert _build.signature(f"ilqr_backward_n{n}")


@pytest.mark.parametrize("name", sorted(kernel_rollout.FUSED_KERNEL_MODELS))
def test_team_sweep_trait_follows_the_route_rule(name):
    """The merged sweep runs as a warp per lane (csrc/sweep_team.cuh) for
    exactly the models whose iter_kernel="auto" takes the split iteration
    (fused._use_iter_kernel): that route rule is m·n ≥ 32, which is the
    rule fused::TeamSweep applies to Model::M and Model::N at compile time;
    no model's header overrides it, and every split-route model lies where
    the team covers it (m ≥ 4, n + m ≤ 32 threads)."""
    import re

    from ilqr_tpu_torch import fused

    csrc = _build.CSRC
    rule = re.search(r"kTeamSweepRule = ([^;]*);",
                     (csrc / "sweep_team.cuh").read_text()).group(1)
    assert "Model::M * Model::N >= 32" in rule, rule
    unit = "kernels.cu" if name == "acrobot" else f"kernels_{name}.cu"
    headers = [h for h in re.findall(r'#include "(\w+\.cuh)"',
                                     (csrc / unit).read_text())
               if h != "kernels.cuh"]
    assert len(headers) == 1, headers
    assert "kTeamSweep" not in (csrc / headers[0]).read_text(), headers[0]
    model = get_model(name)
    split = not fused._use_iter_kernel(model, SolverConfig())
    assert split == (model.m * model.n >= 32)
    if split:
        assert model.m >= 4 and model.n + model.m <= 32, (model.n, model.m)


@pytest.mark.parametrize("name", sorted(kernel_rollout.FUSED_KERNEL_MODELS))
def test_sweep_pick_follows_the_route_rule(name):
    """The merged sweep's kernel, picked at compile time
    (fused::kSweepKind in csrc/sweep_team.cuh): the warp per lane where
    fused::TeamSweep holds (m·n ≥ 32, the models that iter_kernel="auto"
    sends to the split iteration), in every form; else, where the model
    declares kTeamIteration, the team of its whole iteration (csrc/
    iteration_team.cuh sweep_small_team_kernel, at team::kTeamWidth) for
    the dense derivatives (the stencils, the dual numbers) and the
    one-thread sweep_kernel for the closed forms; else the one-thread
    kernel. A custom model never takes the warp (custom.cuh: kTeamSweep
    false) and takes the team by the kTeamIteration of its generated
    header (custom::team_iteration; tests/test_torch_custom_team.py).
    chip_smoke.launched_kernel names the same kernel for each form, and its
    team width is the whole iteration's (TEAM_ITERATION)."""
    import re

    import chip_smoke
    from ilqr_tpu_torch import fused

    csrc = _build.CSRC
    text = (csrc / "sweep_team.cuh").read_text()
    pick = re.search(r"kSweepKind = ([^;]*);", text).group(1)
    assert pick.split() == ["TeamSweep<Model>::value", "?", "2", ":",
                            "TeamIteration<Model>::value", "&&",
                            "Deriv::kDense", "?", "1", ":", "0"]
    step = (csrc / "sweep_step.cuh").read_text()
    dense = dict(re.findall(r"struct (Analytic|FiniteDiff|Jvp) \{\s*static "
                            r"constexpr bool kDense = (\w+);", step))
    assert dense == {"Analytic": "false", "FiniteDiff": "true",
                     "Jvp": "true"}
    body = text[text.index("constexpr auto sweep_kernel_of()"):]
    body = body[:body.index("\n}\n")]
    assert [k.split("<")[0] for k in re.findall(
        r"return ([\w:]+<[^;]*);", body)] == [
        "sweep_team::sweep_team_kernel", "team::sweep_small_team_kernel",
        "sweep_kernel"]
    assert "team::kTeamWidth<Model>" in body
    launch = text[text.index("inline int launch_model_sweep("):]
    launch = launch[:launch.index("\n}\n")]
    assert "sweep_kernel_of<Model, true, Deriv>()" in launch
    assert "sweep_kernel_of<Model, false, Deriv>()" in launch
    kernels = (csrc / "kernels.cuh").read_text()
    for macro in ("ILQR_SPLIT_LAUNCHERS", "ILQR_FD_SWEEP_LAUNCHER",
                  "ILQR_JVP_SWEEP_LAUNCHER"):
        block = kernels[kernels.index(f"#define {macro}("):]
        block = block[:block.index("\n\n")]
        assert "fused::launch_model_sweep<MODEL," in block, macro
    model = get_model(name)
    split = not fused._use_iter_kernel(model, SolverConfig())
    team = "static constexpr bool kTeamIteration = true;" in _model_header(
        name)
    assert split != team   # every package model has a team iteration or warp
    for form in ("analytic", "fd", "jvp"):
        want = ("sweep_team_kernel" if split else "sweep_kernel"
                if form == "analytic" else "sweep_small_team_kernel")
        assert chip_smoke.launched_kernel("sweep", model, form) == want
    if team:
        assert chip_smoke.TEAM_ITERATION[name] == TEAM_ITERATION[name]
    custom = (csrc / "custom.cuh").read_text()
    assert "static constexpr bool kTeamSweep = false;" in custom
    assert "bool kTeamIteration" not in custom
    assert "constexpr bool team_iteration(int n, int m)" in custom


@pytest.mark.parametrize("name", sorted(kernel_derivs.DERIVS_KERNEL_MODELS))
def test_derivs_launcher_launches_the_entry_kernel(name):
    """Every model's ilqr_<model>_derivs (ILQR_DERIVS_LAUNCHER, a custom
    model's too) launches csrc/derivs.cuh's derivs_entry_kernel and nothing
    else: the kernel that kept a (t, lane)'s entries in local arrays is
    gone, each thread walks a running row's n + m directions and
    (n + m)(n + m + 1)/2 pairs (the terminal row's n + n(n + 1)/2 are
    fewer) and stores each as it is made, and the launcher has its
    occupancy entry point beside it. chip_smoke names the kernel and holds
    it bit for bit."""
    import re

    import chip_smoke

    text = (_build.CSRC / "derivs.cuh").read_text()
    assert "derivs_kernel<" not in text and "derivs_kernel(" not in text
    launch = text[text.index("int launch_derivs("):]
    launch = launch[:launch.index("\n}\n")]
    assert re.findall(r"(\w+)<Model, sweep::\w+><<<", launch) == [
        "derivs_entry_kernel", "derivs_entry_kernel"]
    macro = text[text.index("#define ILQR_DERIVS_LAUNCHER"):]
    assert "derivs::launch_derivs<MODEL>" in macro
    assert f"ilqr_##NAME##_derivs_blocks_per_sm(int fd" in macro
    model = get_model(name)
    nz = model.n + model.m
    running = nz + nz * (nz + 1) // 2
    terminal = model.n + model.n * (model.n + 1) // 2
    assert terminal < running
    assert chip_smoke.launched_kernel("derivs", model) == (
        "derivs_entry_kernel")
    assert chip_smoke.held_bitwise("derivs_entry_kernel")
    unit = (_build.CSRC / f"derivs_{name}.cu").read_text()
    assert f"ILQR_DERIVS_LAUNCHER({name}, " in unit


def _model_header(name):
    """The traits header of ``name``'s kernel sources (the one csrc header
    its kernels_<model>.cu includes beside kernels.cuh)."""
    import re

    csrc = _build.CSRC
    unit = "kernels.cu" if name == "acrobot" else f"kernels_{name}.cu"
    headers = [h for h in re.findall(r'#include "(\w+\.cuh)"',
                                     (csrc / unit).read_text())
               if h != "kernels.cuh"]
    assert len(headers) == 1, headers
    return (csrc / headers[0]).read_text()


# The models whose whole iteration is the team of csrc/iteration_team.cuh
# (those with Model::kTeamIteration = true), by its width: half a warp where
# the team's limits allow, else the warp (team::kTeamWidth)
TEAM_ITERATION = {"acrobot": 16, "cartpole": 16, "pendulum": 16,
                  "double_integrator": 32, "bicycle": 32, "power_mass": 32,
                  "point_mass_3d": 32}


@pytest.mark.parametrize("name", sorted(kernel_rollout.FUSED_KERNEL_MODELS))
def test_team_iteration_trait_holds_to_the_team_limits(name):
    """The whole iteration runs as a team per lane (csrc/iteration_team.cuh)
    for every model that iter_kernel="auto" sends to the merged iteration
    (m·n < 32): 16 threads for acrobot, cartpole and pendulum, 32 for
    double_integrator, bicycle, power_mass and point_mass_3d. Each declares
    Model::kTeamIteration = true in its header, and no other model does;
    team::kTeamWidth takes half a warp exactly where the stencil's 2(n + m)
    sides, the (n + m)(n + m + 1)/2 cost-Hessian pairs and the m(n + 1) gain
    entries fit it one a thread, and every team model lies inside the
    warp's limits (sides and gain entries one a thread, pairs in rounds).
    A custom model's generated header declares kTeamIteration by
    custom::team_iteration, the same limits at 32 threads with m·n < 32
    (tests/test_torch_custom_team.py holds it over a grid of n and m);
    custom.cuh declares no kTeamIteration of its own."""
    import re

    from ilqr_tpu_torch import fused

    text = _model_header(name)
    team = "static constexpr bool kTeamIteration = true;" in text
    assert team == (name in TEAM_ITERATION), name
    assert "kTeamIteration = false" not in text
    custom = (_build.CSRC / "custom.cuh").read_text()
    assert "bool kTeamIteration" not in custom
    assert re.search(r"constexpr bool team_iteration\(int n, int m\) \{\s*"
                     r"return m \* n < 32 && 2 \* \(n \+ m\) <= 32 && "
                     r"m \* \(n \+ 1\) <= 32;", custom)
    rule = re.search(r"constexpr int kTeamWidth =([^;]*);", (
        _build.CSRC / "iteration_team.cuh").read_text()).group(1).split()
    assert rule == [
        "2", "*", "(Model::N", "+", "Model::M)", "<=", "kTeam", "&&",
        "(Model::N", "+", "Model::M)", "*", "(Model::N", "+", "Model::M",
        "+", "1)", "/", "2", "<=", "kTeam", "&&", "Model::M", "*",
        "(Model::N", "+", "1)", "<=", "kTeam", "?", "kTeam", ":", "32"], rule
    model = get_model(name)
    assert team == fused._use_iter_kernel(model, SolverConfig())
    if team:
        nz = model.n + model.m
        half = (2 * nz <= 16 and nz * (nz + 1) // 2 <= 16
                and model.m * (model.n + 1) <= 16)
        width = 16 if half else 32
        assert width == TEAM_ITERATION[name]
        assert 2 * nz <= width and model.m * (model.n + 1) <= width


@pytest.mark.parametrize("name", sorted(kernel_rollout.FUSED_KERNEL_MODELS))
def test_warp_iteration_follows_the_route_rule(name):
    """The whole iteration runs as a warp per lane (csrc/iteration_warp.cuh)
    for exactly the models that iter_kernel="auto" sends to the split
    iteration (fused._use_iter_kernel: m·n ≥ 32), which users reach with
    iter_kernel="merged": iteration_warp.cuh picks it by fused::TeamSweep,
    whose rule is m·n ≥ 32 on Model::M and Model::N, after the team's own
    models; custom models opt out (custom.cuh DensePattern,
    kTeamSweep = false); no split-route model is a team model."""
    import re

    from ilqr_tpu_torch import fused

    csrc = _build.CSRC
    pick = re.search(r"kIterationKind = ([^;]*);",
                     (csrc / "iteration_warp.cuh").read_text()).group(1)
    assert pick.split() == ["TeamIteration<Model>::value", "?", "1", ":",
                            "TeamSweep<Model>::value", "?", "2", ":", "0"]
    rule = re.search(r"kTeamSweepRule = ([^;]*);",
                     (csrc / "sweep_team.cuh").read_text()).group(1)
    assert "Model::M * Model::N >= 32" in rule, rule
    assert ("static constexpr bool kTeamSweep = false;"
            in (csrc / "custom.cuh").read_text())
    model = get_model(name)
    warp = model.m * model.n >= 32
    assert warp == (not fused._use_iter_kernel(model, SolverConfig()))
    assert warp == (name not in TEAM_ITERATION)
    if warp:
        assert model.m >= 4 and model.n + model.m <= 32, (model.n, model.m)


@pytest.mark.parametrize("name", sorted(kernel_rollout.FUSED_KERNEL_MODELS))
def test_team_linesearch_covers_every_model(name):
    """The line search runs as a team of 16 threads per lane
    (csrc/linesearch_team.cuh) for every model of the package and every
    custom model: launch_model_linesearch and linesearch_blocks_per_sm take
    the team with no choice to make, no model header, custom.cuh or
    generated header opts out (there is no TeamLineSearch trait), every
    ILQR_ROLLOUT_LAUNCHERS line search goes through
    launch_model_linesearch, and the one-thread linesearch_kernel is gone
    from csrc/. A team holds every candidate: the kernels' most, kMaxA, is
    at most its 16 threads."""
    import re

    csrc = _build.CSRC
    team = (csrc / "linesearch_team.cuh").read_text()
    for fn in ("inline int launch_model_linesearch(",
               "inline int linesearch_blocks_per_sm("):
        body = team[team.index(fn):]
        body = body[:body.index("\n}\n")]
        assert "team::linesearch_team_kernel<Model>" in body, fn
        assert "if constexpr" not in body and "linesearch_kernel<" not in body
    for f in csrc.glob("*.cu*"):
        text = f.read_text()
        assert "TeamLineSearch" not in text, f.name
        assert not re.search(r"\blinesearch_kernel\b", text), f.name
    assert "kTeamLineSearch" not in _model_header(name)
    from ilqr_tpu_torch.examples import custom_model as tcm
    from ilqr_tpu_torch.ops import codegen

    assert "kTeamLineSearch" not in codegen.emit_header(
        codegen.record(tcm.UNICYCLE))
    kernels = (csrc / "kernels.cuh").read_text()
    launchers = kernels[kernels.index("#define ILQR_ROLLOUT_LAUNCHERS"):]
    launchers = launchers[:launchers.index("#define ILQR_SWEEP_BLOCKS")]
    assert "fused::launch_model_linesearch<MODEL>" in launchers
    assert "linesearch_kernel" not in launchers
    max_a = int(re.search(r"constexpr int kMaxA = (\d+);", kernels).group(1))
    lanes = int(re.search(r"constexpr int kTeam = (\d+);", team).group(1))
    assert max_a == len(SolverConfig().alphas) and max_a <= lanes


def test_pack_params_layout():
    """The flat vector the kernels read: AcrobotParams leaves in field
    order, then dt (csrc/acrobot.cuh load_params)."""
    p = tac.default_params()
    pp = kernel_rollout.pack_params(p, 0.02)
    assert pp.vec.dtype == torch.float32 and pp.vec.shape == (21,)
    np.testing.assert_array_equal(pp.vec[:4].numpy(), p.goal.numpy())
    assert pp.vec[12].item() == pytest.approx(9.81)      # gravity
    assert pp.vec[18].item() == -5.0 and pp.vec[19].item() == 5.0
    assert pp.vec[20].item() == pytest.approx(0.02)      # dt last
    back, dt = kernel_rollout.unpack_params(pp)
    for f in tac.AcrobotParams._fields:
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      getattr(p, f).numpy())


@pytest.mark.parametrize("bad", [
    dict(integrator="rk4"), dict(boxqp_mode="iterative"),
    dict(boxqp_mode="enum"), dict(use_control_limits=False),
    dict(backward_mode="assoc"), dict(backward_mode="assoc_frozen"),
    dict(full_ddp=True), "params_batched", "other_model",
])
def test_uncarried_configs_raise_before_running(bad, monkeypatch):
    """What the port does not carry (the assoc modes, full DDP) raises
    NotImplementedError before any stage runs; no plain op takes a missing
    kernel's place. RK4, the iterative and enumeration QPs, the
    unconstrained step, per-problem params, every registered model and a
    model without SoA functions (on the "xla" routes) are carried now:
    they reach the first stage."""
    from ilqr_tpu_torch import solver

    class Reached(Exception):
        pass

    def first_stage(*a, **k):
        raise Reached

    monkeypatch.setattr(solver, "init_state", first_stage)
    model, kw, cfg = tac.MODEL, {}, SolverConfig()
    params = tac.default_params()
    carried = True
    if bad == "params_batched":
        kw = dict(params_batched=True)
        params = type(params)(*(torch.stack([leaf, leaf])
                                for leaf in params))
    elif bad == "other_model":   # a custom model: no SoA functions
        model = tac.MODEL.__class__(**{**tac.MODEL.__dict__,
                                       "name": "custom", "dynamics_soa":
                                       None})
    else:
        cfg = SolverConfig(**bad)
        carried = not ({"backward_mode", "full_ddp"} & set(bad))
    assert model.has_soa == (bad != "other_model")
    with pytest.raises(Reached if carried else NotImplementedError):
        solve_batch(model, params, cfg, 0.02,
                    np.zeros((2, 4), np.float32),
                    np.zeros((5, 1), np.float32), device="cpu", **kw)


def test_unknown_kernel_route_raises():
    with pytest.raises(ValueError, match="deriv_kernel"):
        solve_batch(tac.MODEL, tac.default_params(),
                    SolverConfig(deriv_kernel="cuda"), 0.02,
                    np.zeros((2, 4), np.float32),
                    np.zeros((5, 1), np.float32), device="cpu")


def test_qp_helpers_are_not_recursive():
    """No function of csrc/qp.cuh calls itself by its own name: a recursive
    device function called with a loop index stays a real call, and its
    stack can no longer be sized at compile time (it faulted the m = 4
    kernels once). Template recursion over distinct instantiations
    (``cand3<C + 1>``) is resolved at compile time and allowed."""
    import re

    src = (_build.CSRC / "qp.cuh").read_text()
    defs = list(re.finditer(
        r"^(?:template <[^>]*>\n)?__(?:host__ __)?device__[^(]*?(\w+)\(",
        src, re.M))
    assert len(defs) >= 20
    for k, d in enumerate(defs):
        name = d.group(1)
        end = defs[k + 1].start() if k + 1 < len(defs) else len(src)
        body = src[src.index("{", d.end()):end]
        assert not re.search(rf"\b{name}\s*\(", body), name
    for name in ("chol_masked", "chol_solve", "pn", "pn_val"):
        assert any(d.group(1) == name for d in defs), name


def test_ptxas_table_files_rows_under_their_own_model():
    """chip_smoke's ptxas table over a synthetic log: a kernel's row goes to
    the model of the source whose report holds it (kernels_<model>.cu or
    kernels_<model>_iteration.cu, the rest acrobot's), so thruster_ring16's
    rows are not filed under thruster_ring, although both instantiate
    thruster_ring::Model; each row keeps its source file. The stencil
    instantiations (kernels_<model>_fd.cu, kernels_<model>_iteration_fd.cu;
    FiniteDiff in the mangled name) are filed as sweep_kernel_fd and
    iteration_kernel_fd under their model, the dual-number ones (_jvp.cu;
    Jvp) as <kernel>_jvp, the split sweep's team (sweep_small_team_kernel)
    among them. derivs_<model>.cu's rows go to its model (the
    derivative kernel's one thread per entry as derivs_entry_kernel, its
    stencil mode as derivs_entry_kernel_fd; a tree's before it as
    derivs_kernel), backward.cu's n = 2 rows to
    pendulum and its n = 4 rows to acrobot and cartpole, each instantiation
    of the backward kernel (a template on <N, VEC, WARPS>) under its own
    copy width and warps."""
    import chip_smoke

    def entry(mangled, regs, stack):
        return (f"ptxas info    : Compiling entry function '{mangled}' for "
                f"'sm_90a'\nptxas info    : Function properties for "
                f"{mangled}\n    {stack} bytes stack frame, 8 bytes spill "
                f"stores, 12 bytes spill loads\nptxas info    : Used {regs} "
                f"registers, used 0 barriers\n")

    ring = "_ZN5fused{}IN13thruster_ring5ModelILi{}EEE{}EvPKf"
    bwd = ("_ZN8backward20backward_team_kernelILi{}ELi{}ELi{}EEEvNS_6Inputs"
           "EPKfS3_S3_PfS4_S4_S4_ii")
    log = "".join([
        "ptxas log of backward.cu\n",
        entry(bwd.format(2, 4, 1), 40, 0),
        entry(bwd.format(4, 4, 2), 80, 0),
        entry(bwd.format(4, 1, 2), 96, 0),
        "ptxas log of derivs_acrobot.cu\n",
        entry("_ZN6derivs19derivs_entry_kernelIN7acrobot5ModelEN5sweep3JvpEE"
              "EvPKfiS6_S6_PfS7_S7_S7_S7_S7_S7_iiT0_", 64, 0),
        entry("_ZN6derivs19derivs_entry_kernelIN7acrobot5ModelEN5sweep10"
              "FiniteDiffEEEvPKfiS6_S6_PfS7_S7_S7_S7_S7_S7_iiT0_", 65, 0),
        "ptxas log of derivs_pendulum.cu\n",
        entry("_ZN6derivs19derivs_entry_kernelIN8pendulum5ModelEN5sweep3JvpEE"
              "EvPKfiS6_S6_PfS7_S7_S7_S7_S7_S7_iiT0_", 66, 16),
        "ptxas log of derivs_cartpole.cu\n",   # a tree before the entries
        entry("_ZN12_GLOBAL__N_113derivs_kernelIN8cartpole5ModelEN5sweep3"
              "JvpEEEvPKf", 67, 192),
        "ptxas log of kernels_cartpole_fd.cu\n",
        entry("_ZN4team23sweep_small_team_kernelIN8cartpole5ModelELb1EN5sweep"
              "10FiniteDiffELi16EEEvPKfiS6_S6_S6_S6_PfS7_S7_S7_S7_iiT1_", 106,
              0),
        "ptxas log of kernels_point_mass_3d.cu\n",
        entry("_ZN4team23sweep_small_team_kernelIN13point_mass_3d5ModelELb0EN5"
              "sweep8AnalyticELi32EEEvPKfiS6_S6_S6_S6_PfS7_S7_S7_S7_iiT1_",
              168, 24),
        "ptxas log of kernels.cu\n",
        entry("_ZN5fused12sweep_kernelIN7acrobot5ModelELb1EEEvPKf", 72, 32),
        "ptxas log of kernels_omni_thruster.cu\n",
        entry("_ZN5fused16iteration_kernelIN13omni_thruster5ModelELb0EEEv"
              "PKf", 203, 2048),
        "ptxas log of kernels_quadrotor.cu\n",
        entry("_ZN5fused17linesearch_kernelIN9quadrotor5ModelEEEvPKf", 204,
              0),
        "ptxas log of kernels_quadrotor_iteration.cu\n",
        entry("_ZN5fused16iteration_kernelIN9quadrotor5ModelELb1EEEvPKf", 205,
              528),
        "ptxas log of kernels_thruster_ring.cu\n",
        entry(ring.format("12sweep_kernel", 12, "Lb1E"), 200, 4096),
        entry(ring.format("12sweep_kernel", 12, "Lb0E"), 96, 3584),
        "ptxas log of kernels_thruster_ring16.cu\n",
        entry(ring.format("12sweep_kernel", 16, "Lb1E"), 201, 5000),
        "ptxas log of kernels_thruster_ring24.cu\n",
        entry(ring.format("14rollout_kernel", 24, ""), 202, 64),
        "ptxas log of kernels_quadrotor_iteration_fd.cu\n",
        entry("_ZN5fused16iteration_kernelIN9quadrotor5ModelELb1EN5sweep10"
              "FiniteDiffEEEvPKf", 206, 4720),
        "ptxas log of kernels_acrobot_fd.cu\n",
        entry("_ZN5fused12sweep_kernelIN7acrobot5ModelELb0EN5sweep10"
              "FiniteDiffEEEvPKf", 92, 288),
        "ptxas log of kernels_quadrotor_iteration_jvp.cu\n",
        entry("_ZN5fused16iteration_kernelIN9quadrotor5ModelELb1EN5sweep3"
              "JvpEEEvPKf", 207, 5000),
        "ptxas log of kernels_cartpole_jvp.cu\n",
        entry("_ZN5fused12sweep_kernelIN8cartpole5ModelELb1EN5sweep3"
              "JvpEEEvPKf", 93, 320)])
    t = chip_smoke.ptxas_table(log)
    assert t[("sweep_kernel", "thruster_ring", True)]["registers"] == 200
    assert t[("sweep_kernel", "thruster_ring", False)]["registers"] == 96
    assert t[("sweep_kernel", "thruster_ring16", True)] == dict(
        registers=201, stack_bytes=5000, spill_stores=8, spill_loads=12,
        source="ilqr_tpu_torch/csrc/kernels_thruster_ring16.cu")
    assert t[("rollout_kernel", "thruster_ring24", None)]["registers"] == 202
    assert t[("iteration_kernel", "omni_thruster", False)]["registers"] == 203
    assert t[("linesearch_kernel", "quadrotor", None)]["registers"] == 204
    assert t[("iteration_kernel", "quadrotor", True)] == dict(
        registers=205, stack_bytes=528, spill_stores=8, spill_loads=12,
        source="ilqr_tpu_torch/csrc/kernels_quadrotor_iteration.cu")
    assert t[("sweep_kernel", "acrobot", True)]["registers"] == 72
    assert t[("derivs_entry_kernel", "acrobot", None)]["registers"] == 64
    assert t[("derivs_entry_kernel_fd", "acrobot", None)]["registers"] == 65
    assert t[("derivs_entry_kernel", "pendulum", None)] == dict(
        registers=66, stack_bytes=16, spill_stores=8, spill_loads=12,
        source="ilqr_tpu_torch/csrc/derivs_pendulum.cu")
    assert t[("derivs_kernel", "cartpole", None)]["registers"] == 67
    assert t[("sweep_small_team_kernel_fd", "cartpole", True)] == dict(
        registers=106, stack_bytes=0, spill_stores=8, spill_loads=12,
        source="ilqr_tpu_torch/csrc/kernels_cartpole_fd.cu")
    assert t[("sweep_small_team_kernel", "point_mass_3d",
              False)]["registers"] == 168
    wide, narrow = (chip_smoke.backward_geometry(16, 2),
                    chip_smoke.backward_geometry(4, 2))
    assert t[("backward_team_kernel", "acrobot", wide)]["registers"] == 80
    assert t[("backward_team_kernel", "cartpole", wide)]["registers"] == 80
    assert t[("backward_team_kernel", "acrobot", narrow)]["registers"] == 96
    assert t[("backward_team_kernel", "pendulum",
              chip_smoke.backward_geometry(16, 1))]["registers"] == 40
    assert t[("iteration_kernel_jvp", "quadrotor", True)] == dict(
        registers=207, stack_bytes=5000, spill_stores=8, spill_loads=12,
        source="ilqr_tpu_torch/csrc/kernels_quadrotor_iteration_jvp.cu")
    assert t[("sweep_kernel_jvp", "cartpole", True)]["registers"] == 93
    assert t[("iteration_kernel_fd", "quadrotor", True)] == dict(
        registers=206, stack_bytes=4720, spill_stores=8, spill_loads=12,
        source="ilqr_tpu_torch/csrc/kernels_quadrotor_iteration_fd.cu")
    assert t[("sweep_kernel_fd", "acrobot", False)]["registers"] == 92
    assert len(t) == 23
