"""The plain stencil sweep against the JAX kernel without XLA's FMAs.

tests/test_torch_fd_rk4.py holds the port's stencil sweep (mode="fd",
eps = 0.05) against the JAX sweep_packed in this process, as a gauge: the
f32 stencils scale each rounding difference of a cost by 1/(4·eps²) = 100,
and XLA:CPU contracts a·b + c into FMAs where the port rounds twice. Here
the JAX side runs in a child process whose XLA:CPU may not use FMA
(--xla_cpu_max_isa=SSE4_2), on the trig-free models (the double integrator
and power_mass, Euler and RK4), and the two agree to 1e-4: the port forms
the same stencils in the same order as the JAX kernel.
"""

import numpy as np
import pytest

from test_torch_fd_rk4 import (
    DT,
    FD_EPS,
    NO_TRIG_CASES,
    _check_sweep_inputs,
    _port_sweep,
    _rel,
    _sweep_inputs,
)

# the JAX kernel's time block in the child: one step per grid step keeps
# its interpret-mode compile short (the edge-row masking of a partial block
# is exercised in tests/test_torch_fd_rk4.py)
TB_CHILD = 1

_NO_FMA_CHILD = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
from ilqr_tpu import get_model
from ilqr_tpu.ops import pallas_rollout, pallas_sweep

d = np.load(sys.argv[1])
packed = lambda a: jnp.asarray(a.reshape(a.shape[:-1] + (1, 8, 128)))
out = {}
for key in d["keys"]:
    name, integrator, dt = str(key).split("/")
    model = get_model(name)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                model.default_params())
    got = pallas_sweep.sweep_packed(
        model, integrator, pallas_rollout.pack_params(jp, float(dt)),
        *(packed(d[f"{key}/{a}"]) for a in ("xs", "xT", "us", "lam")),
        mode="fd", eps=float(sys.argv[3]), interpret=True, use_limits=True,
        time_block=int(sys.argv[4]))
    for i, g in enumerate(got):
        g = np.asarray(g)
        out[f"{key}/{i}"] = g.reshape(g.shape[:-3] + (-1,))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def no_fma_reference(tmp_path_factory):
    """The JAX sweep_packed's outputs on the trig-free cases, computed in a
    child process whose XLA:CPU may not use FMA (--xla_cpu_max_isa=SSE4_2),
    so that each a·b + c rounds twice, as in the port."""
    import os
    import subprocess
    import sys

    keys = [f"{n}/{i}/{DT[n]}" for n, i in NO_TRIG_CASES]
    d = tmp_path_factory.mktemp("no_fma")
    arrays = {}
    for key in keys:
        name, integrator, _dt = key.split("/")
        for a, v in zip(("xs", "us", "xT", "lam"),
                        _sweep_inputs(name, integrator)):
            arrays[f"{key}/{a}"] = v
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2")
    # one child per case, all at once: each spends its time compiling
    procs = []
    for i, key in enumerate(keys):
        np.savez(d / f"in{i}.npz", keys=np.asarray([key]),
                 **{k: v for k, v in arrays.items()
                    if k.startswith(key + "/")})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _NO_FMA_CHILD, str(d / f"in{i}.npz"),
             str(d / f"out{i}.npz"), str(FD_EPS), str(TB_CHILD)], cwd=repo,
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True))
    out = {}
    for i, proc in enumerate(procs):
        _o, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        got = np.load(d / f"out{i}.npz")
        out.update({k: got[k] for k in got.files})
    return out, arrays


@pytest.mark.parametrize("name,integrator", NO_TRIG_CASES)
def test_fd_sweep_matches_jax_no_fma(no_fma_reference, name, integrator):
    """The plain stencil sweep (mode="fd", eps = 0.05, the ``integrator``
    step, limits on; one 1024-lane block, T = 7 in time blocks of 1 on the
    JAX side, the inputs of test_torch_fd_rk4._sweep_inputs) against the
    JAX sweep_packed in interpret mode without FMAs (no_fma_reference): k,
    K, dv, gnorm to 1e-4 relative, the latch exact. Measured max |a − b| /
    (1 + |b|) over the four: the double integrator 1.2e-7 / 1.9e-5 (Euler /
    RK4), power_mass 3.1e-7 / 3.1e-7; with XLA's FMAs (the JAX side in
    this process, time blocks of 3) the Euler cases' were 6.7e-5 and
    7.7e-3."""
    ref, arrays = no_fma_reference
    key = f"{name}/{integrator}/{DT[name]}"
    xs, us, xT, lam = (arrays[f"{key}/{a}"]
                       for a in ("xs", "us", "xT", "lam"))
    got = _port_sweep(name, integrator, xs, us, xT, lam)
    for i, what in enumerate(("k", "K", "dv", "diverged", "gnorm")):
        assert _rel(got[i], ref[f"{key}/{i}"]) <= 1e-4, what
    np.testing.assert_array_equal(got[3].numpy(), ref[f"{key}/3"])
    _check_sweep_inputs(name, integrator, xs, us, xT, lam,
                        [g.numpy() for g in got])
