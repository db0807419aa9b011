"""Closed-loop rollout and line search (counterpart of
``ilqr_tpu/ops/pallas_rollout.py``).

Layout: every array keeps the lane (problem) index last — x0 (n, B),
u (T, m, B), x̄ (T, n, B), K (T, m, n, B), per-lane scalars (B,). This is the
JAX package's packed (…, NB, 8, 128) layout flattened.

Each op has a plain PyTorch version (vectorized over lanes, a Python loop
over T, line-search candidates as a batch dimension) and a CUDA kernel
(csrc/kernels.cuh, one source per model). The op runs the plain version for
CPU tensors and launches the kernel for CUDA tensors; it never falls back
from one to the other. ``<op>.launches`` counts the kernel launches. Both
ops take the Euler or the RK4 step (``integrator``), as the JAX kernels do.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ilqr_tpu_torch import models
from ilqr_tpu_torch.models.acrobot import AcrobotParams
from ilqr_tpu_torch.models.bicycle import BicycleParams
from ilqr_tpu_torch.models.cartpole import CartPoleParams
from ilqr_tpu_torch.models.double_integrator import DoubleIntegratorParams
from ilqr_tpu_torch.models.free_flyer import FreeFlyerParams
from ilqr_tpu_torch.models.omni_thruster import OmniThrusterParams
from ilqr_tpu_torch.models.pendulum import PendulumParams
from ilqr_tpu_torch.models.point_mass_3d import PointMass3DParams
from ilqr_tpu_torch.models.power_mass import PowerMassParams
from ilqr_tpu_torch.models.quadrotor import QuadrotorParams
from ilqr_tpu_torch.models.thruster_ring import ThrusterRingParams
from ilqr_tpu_torch.ops import _build

F32 = torch.float32


# ---------------------------------------------------------------------------
# Param packing: params NamedTuple → one flat f32 vector, dt last; or, with
# per-problem params, one such row per lane
# ---------------------------------------------------------------------------

class PackedParams(NamedTuple):
    vec: torch.Tensor  # (P,) shared, or (B, P) one row per lane; f32,
    #                    leaves in field order, then dt
    cls: type          # the params NamedTuple type
    shapes: tuple      # each field's shape (per lane when batched)


def pack_params(params, dt, device=None) -> PackedParams:
    """Flattens the params leaves in field order into one f32 vector with
    ``dt`` as the last entry (the kernels read it from device memory).
    Shared (unbatched) params."""
    leaves = [torch.as_tensor(getattr(params, f), dtype=F32)
              for f in params._fields]
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    flat = [leaf.reshape(-1).cpu() for leaf in leaves]
    flat.append(torch.tensor([float(dt)], dtype=F32))
    return PackedParams(torch.cat(flat).to(device), type(params), shapes)


def pack_params_batched(params, dt, device=None) -> PackedParams:
    """Per-problem params (counterpart of
    ``pallas_rollout.pack_params_batched``): every leaf (a numpy array or a
    tensor) carries a leading batch axis B. Returns a (B, P) f32 ``vec``,
    lane b's row holding problem b's leaves in field order and then ``dt``,
    which stays shared (repeated on every row); ``shapes`` are the per-lane
    leaf shapes. A kernel reads row b on lane b (its params stride P)."""
    leaves = [_as_f32(getattr(params, f)) for f in params._fields]
    B = leaves[0].shape[0] if leaves[0].ndim else 0
    if B == 0 or any(leaf.ndim == 0 or leaf.shape[0] != B
                     for leaf in leaves):
        raise ValueError(
            "params_batched: every params leaf needs the same leading batch "
            f"axis, got shapes {[tuple(leaf.shape) for leaf in leaves]}")
    shapes = tuple(tuple(leaf.shape[1:]) for leaf in leaves)
    rows = [leaf.reshape(B, -1) for leaf in leaves]
    rows.append(torch.full((B, 1), float(dt), dtype=F32))
    return PackedParams(torch.cat(rows, dim=1).contiguous().to(device),
                        type(params), shapes)


def _as_f32(leaf) -> torch.Tensor:
    """A params leaf (a tensor, or anything numpy converts) as a CPU f32
    tensor."""
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.from_numpy(np.asarray(leaf))
    return leaf.to(device="cpu", dtype=F32)


def is_batched(pp: PackedParams) -> bool:
    """Whether ``pp`` holds one row of params per lane."""
    return pp.vec.ndim == 2


def param_stride(pp: PackedParams) -> int:
    """The kernels' params lane stride: 0 for shared params (every lane
    reads the one vector), P for per-lane rows."""
    return pp.vec.shape[1] if is_batched(pp) else 0


def unpack_params(pp: PackedParams):
    """Inverse of :func:`pack_params` / :func:`pack_params_batched`:
    (params with tensor leaves, dt as a 0-d tensor). Shared leaves view
    ``pp.vec``; per-lane leaves come lane-last, (*leaf_shape, B), so a
    component (``p.goal[i]``, ``p.u_min[j]``) is a (B,) tensor that
    broadcasts against the plain versions' (…, B) lanes."""
    batched = is_batched(pp)
    leaves = []
    r = 0
    for shape in pp.shapes:
        size = math.prod(shape)
        if batched:
            leaves.append(pp.vec[:, r:r + size].t().reshape(
                *shape, pp.vec.shape[0]))
        else:
            leaves.append(pp.vec[r:r + size].reshape(shape))
        r += size
    return pp.cls(*leaves), (pp.vec[0, r] if batched else pp.vec[r])


# ---------------------------------------------------------------------------
# Dispatch helpers shared by the op modules
# ---------------------------------------------------------------------------

def on_cuda(t: torch.Tensor) -> bool:
    """Whether an op given ``t`` launches its kernel (CUDA) or runs its plain
    version (CPU); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


# The package's models the fused solver's four kernels are compiled for
# (one csrc/kernels*.cu each), with their params types. A registered
# custom model (models.register) has every kernel in a library of its own
# (ops/_build.py build_model).
FUSED_KERNEL_MODELS = {
    "acrobot": AcrobotParams,
    "double_integrator": DoubleIntegratorParams,
    "point_mass_3d": PointMass3DParams,
    "quadrotor": QuadrotorParams,
    "omni_thruster": OmniThrusterParams,
    "free_flyer": FreeFlyerParams,
    "thruster_ring": ThrusterRingParams,
    "thruster_ring16": ThrusterRingParams,
    "thruster_ring20": ThrusterRingParams,
    "thruster_ring24": ThrusterRingParams,
    "pendulum": PendulumParams,
    "cartpole": CartPoleParams,
    "bicycle": BicycleParams,
    "power_mass": PowerMassParams,
}


@functools.lru_cache(maxsize=None)
def _param_shapes(model) -> tuple:
    """The leaf shapes of ``model``'s default params."""
    return pack_params(model.default_params(), 0.0).shapes


# The integrators of the kernels (csrc/integrate.cuh Scheme), as the
# launchers take them.
SCHEMES = {"euler": 0, "rk4": 1}


def scheme(integrator: str) -> int:
    """The kernels' code of ``integrator``; ValueError for an unknown one,
    as the JAX package's ``_integrate`` raises."""
    if integrator not in SCHEMES:
        raise ValueError(f"unknown integrator {integrator!r}")
    return SCHEMES[integrator]


def kernel_owner(model):
    """The model whose own library holds ``model``'s launchers: ``model``
    itself when it is a registered custom model, None for the package's
    models (the main library)."""
    return models.custom_model(model)


def has_kernels(model, have=None) -> bool:
    """Whether the card has ``model``'s kernels: one of the package's
    models (among ``have``), or a registered custom model with SoA
    functions."""
    if models.is_builtin(model):
        return model.name in (FUSED_KERNEL_MODELS if have is None else have)
    return kernel_owner(model) is not None and model.has_soa


def require_kernel_model(model, integrator: str, pp: PackedParams, device,
                         have=None, lanes=None, limits=False) -> str:
    """Checks that CUDA kernels exist for ``model`` (with params of its
    type): one of the package's models among ``have`` (name → params type;
    default the fused kernels' models), or a model registered with
    ``models.register`` whose SoA functions the recorder takes (its own
    library, built at first use); that ``integrator`` is one they take
    (Euler or RK4); that a custom model has ``u_min``/``u_max`` when
    ``limits`` (a clamp or the box QP) reads them; and that the packed
    params are one (P,) vector or one row per lane, (``lanes``, P).
    Returns the prefix of the model's launchers, ``ilqr_<model>``."""
    have = FUSED_KERNEL_MODELS if have is None else have
    if kernel_owner(model) is not None:
        expected = type(model.default_params())
        if pp.cls is not expected:
            raise NotImplementedError(
                f"custom model {model.name!r} takes {expected.__name__}, "
                f"not {pp.cls.__name__}")
        if not model.has_soa:
            raise NotImplementedError(
                f"custom model {model.name!r} has no SoA functions "
                "(dynamics_soa, cost_soa, final_cost_soa), from which its "
                "kernels are generated")
        if limits and not {"u_min", "u_max"} <= set(pp.cls._fields):
            raise ValueError(
                f"custom model {model.name!r}: control limits read the "
                "params fields u_min and u_max, which it lacks")
    elif not models.is_builtin(model) or have.get(model.name) is not pp.cls:
        raise NotImplementedError(
            f"CUDA kernels exist for {', '.join(have)} and the models "
            "registered with ilqr_tpu_torch.models.register, not "
            f"{model.name!r} with {pp.cls.__name__}")
    # the loader reads a fixed layout (the rings share one params type)
    if pp.shapes != _param_shapes(model):
        raise ValueError(
            f"{model.name}: params leaf shapes {pp.shapes}, the CUDA loader "
            f"reads {_param_shapes(model)}")
    scheme(integrator)
    if is_batched(pp) and lanes is None:
        raise ValueError("per-lane params need the op's lane count")
    P = pp.vec.shape[-1]
    _build.require(pp.vec, (lanes, P) if is_batched(pp) else (P,),
                   "packed params", device)
    return f"ilqr_{model.name}"


# ---------------------------------------------------------------------------
# A custom model's SoA functions in the plain versions
# ---------------------------------------------------------------------------

_ADAPTED = {}


def plain_model(model, shapes):
    """``model`` as the plain versions call it, with params of leaf shapes
    ``shapes`` (``PackedParams.shapes``). A custom model's SoA functions
    are written against arrays whose params leaves arrive lane-broadcast
    (the JAX kernels' (*shape, S, L) leaves), so that ``p.goal - x``
    broadcasts; here they get x and u as arrays (a list of components
    stacked) and every params leaf viewed with a singleton axis per batch
    axis of x, (*shape, 1, …) shared or (*shape, 1, …, B) per lane. Views
    only: every value and operation is the one the function computed on
    components. The package's models are returned as they are."""
    if models.is_builtin(model) or not model.has_soa or getattr(
            model.dynamics_soa, "lane_broadcast", False):
        return model
    key = (id(model), shapes)
    hit = _ADAPTED.get(key)
    if hit is None or hit[0] is not model:
        hit = _ADAPTED[key] = (model, dataclasses.replace(
            model, dynamics_soa=_broadcasting(model.dynamics_soa, shapes),
            cost_soa=_broadcasting(model.cost_soa, shapes),
            final_cost_soa=_broadcasting(model.final_cost_soa, shapes)))
    return hit[1]


def _as_array(a):
    """A list of components (tensors or dual numbers) stacked, or ``a``."""
    if not isinstance(a, (list, tuple)):
        return a
    if isinstance(a[0], torch.Tensor):
        return torch.stack(torch.broadcast_tensors(*a))
    from ilqr_tpu_torch.ops.kernel_derivs import _stack

    return _stack(a)


def _primal_ndim(a) -> int:
    while not isinstance(a, torch.Tensor):
        a = a.v
    return a.ndim


def _broadcasting(fn, shapes):
    def call(p, x, *rest):
        x = _as_array(x)
        nb = _primal_ndim(x) - 1
        leaves = []
        for leaf, shape in zip(p, shapes):
            if leaf.ndim == len(shape):      # shared
                leaves.append(leaf.reshape(shape + (1,) * nb))
            else:                            # per lane, (*shape, B)
                leaves.append(leaf.reshape(
                    shape + (1,) * (nb - 1) + (leaf.shape[-1],)))
        return fn(type(p)(*leaves), x, *(_as_array(r) for r in rest))
    call.lane_broadcast = True
    return call


def lane_last(a):
    """Batch-major (B, …) → lane-last (…, B), contiguous: free where ``a``
    is the batch-major view of a lane-last kernel output."""
    return a.permute(*range(1, a.ndim), 0).contiguous()


def batch_first(a):
    """Lane-last (…, B) → a batch-major (B, …) view."""
    return a.permute(a.ndim - 1, *range(a.ndim - 1))


def clip(v, lo, hi):
    """jnp.clip: minimum(maximum(v, lo), hi), NaN-propagating."""
    return torch.minimum(torch.maximum(v, lo), hi)


def integrate(model, p, dt, integrator, x, u):
    """The discrete step F(x, u) (csrc/integrate.cuh; the JAX kernels'
    ``_integrate``) in its operation order: Euler x + f·dt, or RK4 with
    k2 = f(x + (0.5·dt)·k1), …, x + (dt/6)·(((k1 + 2k2) + 2k3) + k4).
    x (n, *batch), u (m, *batch); dt a 0-d f32 tensor."""
    k1 = model.dynamics_soa(p, x, u)
    if integrator == "euler":
        return x + k1 * dt
    k2 = model.dynamics_soa(p, x + 0.5 * dt * k1, u)
    k3 = model.dynamics_soa(p, x + 0.5 * dt * k2, u)
    k4 = model.dynamics_soa(p, x + dt * k3, u)
    # dt / 6 with a tensor divisor: by a Python scalar, PyTorch's CUDA
    # division multiplies by the scalar's f32 reciprocal instead of
    # dividing, as the kernel and the JAX package do
    sixth = dt / torch.full_like(dt, 6.0)
    return x + sixth * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def closed_loop_step(model, p, dt, integrator, clamp, x, u_ff, xsr, K):
    """One step: u = u_ff + K (x − x̄), optional box clamp, running cost,
    the Euler or RK4 step. x (n, *batch), u_ff (m, *batch), xsr (n, B),
    K (m, n, B); returns (u, cost, x_next)."""
    n, m = model.n, model.m
    us = []
    for j in range(m):
        acc = u_ff[j]
        for i in range(n):
            acc = acc + K[j, i] * (x[i] - xsr[i])
        if clamp:
            acc = clip(acc, p.u_min[j], p.u_max[j])
        us.append(acc)
    u = torch.stack(us)
    c = model.cost_soa(p, x, u)
    return u, c, integrate(model, p, dt, integrator, x, u)


# ---------------------------------------------------------------------------
# rollout_packed: the full output, and the modes of the JAX kernel's
# candidate sweeps (costs_only, candidates, alphas, alpha_lanes)
# ---------------------------------------------------------------------------

# The modes of the second kernel, ilqr_<model>_rollout_modes, by the launch
# counter they add to (rollout_packed.mode_launches): a cost-only rollout,
# A candidates with u_ff materialized per candidate, A candidates with the
# step α_a formed in the kernel, one α per lane.
ROLLOUT_MODES = ("costs_only", "candidates", "alphas", "alpha_lanes")


def rollout_mode(costs_only=False, candidates=1, k=None, alphas=None,
                 alpha_lanes=None):
    """The mode of a :func:`rollout_packed` call: None for the full output
    (the first kernel), else one of ROLLOUT_MODES. Raises ValueError for
    the combinations the JAX kernel asserts against: full outputs need
    ``candidates == 1``, ``alphas`` excludes ``alpha_lanes``, and either α
    needs ``k``."""
    if candidates < 1:
        raise ValueError(f"candidates must be >= 1, got {candidates}")
    if not costs_only and candidates != 1:
        raise ValueError("full outputs require candidates == 1")
    if alphas is not None and alpha_lanes is not None:
        raise ValueError("alphas and alpha_lanes exclude each other")
    if (alphas is not None or alpha_lanes is not None) and k is None:
        raise ValueError("an in-kernel alpha (alphas or alpha_lanes) needs k")
    if alphas is not None:
        return "alphas"
    if alpha_lanes is not None:
        return "alpha_lanes"
    if candidates > 1:
        return "candidates"
    return "costs_only" if costs_only else None


def rollout_plain(model, integrator, clamp, pp, x0, uff, xsr, K,
                  costs_only=False, candidates=1, k=None, alphas=None,
                  alpha_lanes=None):
    """Plain version of :func:`rollout_packed`, every mode: the A·B
    candidate lanes (candidate-major, lane a·B + b) advance together, each
    reading lane b's x0, x̄, K, k and params."""
    mode = rollout_mode(costs_only, candidates, k, alphas, alpha_lanes)
    scheme(integrator)
    model = plain_model(model, pp.shapes)
    A = candidates
    if is_batched(pp) and A > 1:
        pp = pp._replace(vec=pp.vec.repeat(A, 1))
    p, dt = unpack_params(pp)
    T, m, n, B = K.shape
    dev = x0.device
    # (…, B) → (…, A·B), candidate-major; a copy-free view when A = 1
    wide = (lambda a: a) if A == 1 else (
        lambda a: a.repeat(*(1,) * (a.ndim - 1), A))
    al = (alphas.repeat_interleave(B) if mode == "alphas"
          else wide(alpha_lanes) if mode == "alpha_lanes" else None)
    uff_wide = mode == "candidates"
    if not costs_only:
        xs = torch.empty((T, n, B), dtype=F32, device=dev)
        us = torch.empty((T, m, B), dtype=F32, device=dev)
    x = wide(x0)
    cost = torch.zeros((A * B,), dtype=F32, device=dev)
    for t in range(T):
        u_ff = uff[t] if uff_wide else wide(uff[t])
        if al is not None:
            u_ff = u_ff + al * wide(k[t])
        if not costs_only:
            xs[t] = x
        u, c, x = closed_loop_step(model, p, dt, integrator, clamp, x, u_ff,
                                   wide(xsr[t]), wide(K[t]))
        if not costs_only:
            us[t] = u
        cost = cost + c
    cost = cost + model.final_cost_soa(p, x)
    return cost if costs_only else (xs, us, x, cost)


def rollout_packed(model, integrator: str, clamp: bool, pp: PackedParams,
                   x0, uff, xsr, K, costs_only: bool = False,
                   candidates: int = 1, k=None, alphas=None,
                   alpha_lanes=None):
    """Closed-loop rollout u_t = u_ff,t + K_t (x_t − x̄_t) (clamped to the
    box when ``clamp``), Euler or RK4 steps, Σ running cost + final cost
    (ref src/ilqr_core.cpp:305-337).

    Shapes: x0 (n, B), uff (T, m, B), xsr (T, n, B), K (T, m, n, B).
    Returns (xs (T, n, B) — rows 0..T-1, us (T, m, B), x_final (n, B),
    cost (B,)).

    The modes of the JAX kernel's candidate sweeps (its names, the lanes
    last): ``costs_only`` returns the cost alone, (A·B,) candidate-major;
    ``candidates`` = A > 1 rolls out A candidates per lane (costs only),
    reading x0, x̄, K, k and the params at lane b for candidate lane
    a·B + b — with ``alphas`` (A,) the candidate's u_ff = uff + α_a·k is
    formed in the kernel from the shared uff (T, m, B) and ``k``
    (T, m, B), without it uff is materialized per candidate,
    (T, m, A·B); ``alpha_lanes`` (B,) takes one α per lane, with full
    outputs. These run a second kernel, ilqr_<model>_rollout_modes, and
    count in ``rollout_packed.mode_launches[mode]`` (ROLLOUT_MODES);
    the full output counts in ``rollout_packed.launches``. Invalid
    combinations raise ValueError before anything runs.
    """
    mode = rollout_mode(costs_only, candidates, k, alphas, alpha_lanes)
    if not on_cuda(x0):
        return rollout_plain(model, integrator, clamp, pp, x0, uff, xsr, K,
                             costs_only, candidates, k, alphas, alpha_lanes)
    dev = x0.device
    T, m, n, B = K.shape
    prefix = require_kernel_model(model, integrator, pp, dev, lanes=B,
                                  limits=clamp)
    A = candidates
    for t, shape, name in (
            (x0, (n, B), "x0"),
            (uff, (T, m, A * B if mode == "candidates" else B), "uff"),
            (xsr, (T, n, B), "xsr"), (K, (T, m, n, B), "K")):
        _build.require(t, shape, name, dev)
    if mode is None:
        xs = torch.empty((T, n, B), dtype=F32, device=dev)
        us = torch.empty((T, m, B), dtype=F32, device=dev)
        xfin = torch.empty((n, B), dtype=F32, device=dev)
        cost = torch.empty((B,), dtype=F32, device=dev)
        _build.launch(f"{prefix}_rollout", dev, pp.vec, param_stride(pp), x0,
                      uff, xsr, K, xs, us, xfin, cost, T, B,
                      int(bool(clamp)), scheme(integrator),
                      model=kernel_owner(model))
        rollout_packed.launches += 1
        return xs, us, xfin, cost
    alpha = alphas if mode == "alphas" else alpha_lanes
    if alpha is not None:
        _build.require(k, (T, m, B), "k", dev)
        _build.require(alpha, (A,) if mode == "alphas" else (B,),
                       "alphas" if mode == "alphas" else "alpha_lanes", dev)
    empty = lambda *s: (None if costs_only
                        else torch.empty(s, dtype=F32, device=dev))
    xs, us, xfin = empty(T, n, B), empty(T, m, B), empty(n, B)
    cost = torch.empty((A * B,), dtype=F32, device=dev)
    _build.launch(f"{prefix}_rollout_modes", dev, pp.vec, param_stride(pp),
                  x0, uff, xsr, K, k if alpha is not None else None, alpha,
                  xs, us, xfin, cost, T, B, A, int(mode == "candidates"),
                  {"alphas": 1, "alpha_lanes": 2}.get(mode, 0),
                  int(bool(costs_only)), int(bool(clamp)), scheme(integrator),
                  model=kernel_owner(model))
    rollout_packed.mode_launches[mode] += 1
    return cost if costs_only else (xs, us, xfin, cost)


rollout_packed.launches = 0
rollout_packed.mode_launches = dict.fromkeys(ROLLOUT_MODES, 0)


def rollout_batched(model, integrator: str, clamp: bool, pp: PackedParams,
                    x0, u_ff, xs_ref, K):
    """Batch-major wrapper of :func:`rollout_packed` (counterpart of
    ``pallas_rollout.rollout_batched``): x0 (B, n), u_ff (B, T, m),
    xs_ref (B, T+1, n) (row T unused), K (B, T, m, n) → (xs (B, T+1, n),
    us (B, T, m), cost (B,))."""
    xs, us, xfin, cost = rollout_packed(
        model, integrator, clamp, pp, lane_last(x0), lane_last(u_ff),
        lane_last(xs_ref[:, :-1]), lane_last(K))
    return batch_first(torch.cat([xs, xfin[None]])), batch_first(us), cost


# ---------------------------------------------------------------------------
# linesearch_packed (line search + iteration epilogue)
# ---------------------------------------------------------------------------

def _sign(d):
    """jnp.sign: keeps ±0 and NaN (torch.sign maps NaN to 0)."""
    return torch.where(d > 0.0, 1.0, torch.where(d < 0.0, -1.0, d))


def select_alpha(cand, alphas, cprev, dv0, dv1, z_min):
    """First accepted α over the candidate totals cand (A, B): z-ratio test
    z = dcost/expected > z_min, with z = sign(dcost) where expected ≤ 0
    (ref ilqr_core.cpp:199-213). Returns (alpha, cost, dcost, expected,
    accepted (f32 0/1)), each (B,)."""
    a0 = alphas[0]
    chosen = torch.zeros_like(cprev, dtype=torch.bool)
    asel = torch.full_like(cprev, 1.0) * a0
    lsc = cand[0]
    ldc = cprev - cand[0]
    lexp = -a0 * (dv0 + a0 * dv1)
    accepted = torch.zeros_like(cprev)
    for a in range(alphas.shape[0]):
        aa = alphas[a]
        dcost = cprev - cand[a]
        expected = -aa * (dv0 + aa * dv1)
        z = torch.where(expected > 0.0, dcost / expected, _sign(dcost))
        acc_a = z > z_min
        take = acc_a & ~chosen
        asel = torch.where(take, aa, asel)
        lsc = torch.where(take, cand[a], lsc)
        ldc = torch.where(take, dcost, ldc)
        lexp = torch.where(take, expected, lexp)
        chosen = chosen | acc_a
        accepted = torch.maximum(accepted, acc_a.to(F32))
    return asel, lsc, ldc, lexp, accepted


def linesearch_plain(model, integrator, clamp, pp, x0, us, xsr, xterm, K, k,
                     Kold, kold, alphas, dv, cost_prev, gate, keep, z_min):
    """Plain version of :func:`linesearch_packed`."""
    scheme(integrator)
    model = plain_model(model, pp.shapes)
    p, dt = unpack_params(pp)
    T, m, n, B = K.shape
    dev = x0.device
    al = alphas[None, :, None]                          # (1, A, 1)

    # phase 1: every α-candidate at once, costs only
    xa = x0[:, None, :].expand(n, alphas.shape[0], B)    # (n, A, B)
    ca = torch.zeros((alphas.shape[0], B), dtype=F32, device=dev)
    for t in range(T):
        u_ff = us[t][:, None, :] + al * k[t][:, None, :]
        _u, c, xa = closed_loop_step(model, p, dt, integrator, clamp, xa,
                                     u_ff, xsr[t], K[t])
        ca = ca + c
    cand = ca + model.final_cost_soa(p, xa)

    asel, lsc, ldc, lexp, accepted = select_alpha(
        cand, alphas, cost_prev, dv[0], dv[1], z_min)
    take = (accepted * gate) > 0.5
    keepm = keep > 0.5

    # phase 2: the selected α with predicated writes
    xs_out = torch.empty((T, n, B), dtype=F32, device=dev)
    us_out = torch.empty((T, m, B), dtype=F32, device=dev)
    x = x0
    for t in range(T):
        xs_out[t] = torch.where(take, x, xsr[t])
        u, _c, x = closed_loop_step(model, p, dt, integrator, clamp, x,
                                    us[t] + asel * k[t], xsr[t], K[t])
        us_out[t] = torch.where(take, u, us[t])
    k_out = torch.where(keepm, k, kold)
    K_out = torch.where(keepm, K, Kold)
    xfin = torch.where(take, x, xterm)
    return xs_out, us_out, xfin, k_out, K_out, lsc, asel, accepted, ldc, lexp


def linesearch_packed(model, integrator: str, clamp: bool, pp: PackedParams,
                      x0, us, xsr, xterm, K, k, Kold, kold, alphas, dv,
                      cost_prev, gate, keep, z_min: float):
    """Line search + iteration epilogue (ref ilqr_core.cpp:184-226,
    242-255): A cost-only candidate rollouts at u + α_a·k, the first
    accepted α, then the post-accept state with predicated writes —

      xs/us ← the selected-α rollout on lanes taking the step
              (accepted & gate), the current trajectory otherwise;
      k/K   ← the new gains on keep lanes, the previous gains otherwise.

    Shapes: x0 (n, B), us (T, m, B), xsr (T, n, B), xterm (n, B),
    K/Kold (T, m, n, B), k/kold (T, m, B), alphas (A,), dv (2, B);
    cost_prev, gate, keep (B,) with masks as f32 0/1. Returns (xs, us,
    x_final, k_keep, K_keep, ls_cost, alpha_sel, accepted (f32 0/1, raw
    z-test), dcost, expected).
    """
    if not on_cuda(x0):
        return linesearch_plain(model, integrator, clamp, pp, x0, us, xsr,
                                xterm, K, k, Kold, kold, alphas, dv,
                                cost_prev, gate, keep, z_min)
    dev = x0.device
    T, m, n, B = K.shape
    prefix = require_kernel_model(model, integrator, pp, dev, lanes=B,
                                  limits=clamp)
    A = alphas.shape[0]
    max_a = _build.lib_for(kernel_owner(model)).ilqr_max_alphas()
    if not 1 <= A <= max_a:
        raise ValueError(f"linesearch kernel takes 1..{max_a} alphas, got {A}")
    for t, shape, name in (
            (x0, (n, B), "x0"), (us, (T, m, B), "us"), (xsr, (T, n, B), "xsr"),
            (xterm, (n, B), "xterm"), (K, (T, m, n, B), "K"),
            (k, (T, m, B), "k"), (Kold, (T, m, n, B), "Kold"),
            (kold, (T, m, B), "kold"), (alphas, (A,), "alphas"),
            (dv, (2, B), "dv"), (cost_prev, (B,), "cost_prev"),
            (gate, (B,), "gate"), (keep, (B,), "keep")):
        _build.require(t, shape, name, dev)
    outs = (torch.empty((T, n, B), dtype=F32, device=dev),
            torch.empty((T, m, B), dtype=F32, device=dev),
            torch.empty((n, B), dtype=F32, device=dev),
            torch.empty((T, m, B), dtype=F32, device=dev),
            torch.empty((T, m, n, B), dtype=F32, device=dev),
            *(torch.empty((B,), dtype=F32, device=dev) for _ in range(5)))
    _build.launch(f"{prefix}_linesearch", dev, pp.vec, param_stride(pp), x0,
                  us, xsr, xterm, K, k, Kold, kold, alphas, A, dv, cost_prev,
                  gate, keep, *outs, float(z_min), T, B, int(bool(clamp)),
                  scheme(integrator), model=kernel_owner(model))
    linesearch_packed.launches += 1
    return outs


linesearch_packed.launches = 0
