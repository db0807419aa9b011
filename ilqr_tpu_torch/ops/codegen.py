"""A custom model's device functions, generated from its torch SoA
functions (counterpart of the Pallas kernels' tracing of the model's SoA
functions: ilqr_tpu/ops/pallas_rollout.py ``_dyn``/``_integrate``,
pallas_sweep.py ``_model_closures``, pallas_derivs.py ``_kernel``).

The JAX package's kernels trace the user's ``dynamics_soa``, ``cost_soa``
and ``final_cost_soa``; here they are recorded once as scalar expressions
and emitted as a traits header in the shape of ``csrc/<model>.cuh``
(``struct Model`` with ``N``, ``M``, ``Params``, ``load``, ``u_lo``/``u_hi``
and ``dynamics``/``cost``/``final_cost`` as templates on the scalar ``S``),
which the hand-written kernel templates of ``csrc/`` take as they take the
package's models (ops/_build.py ``build_model``). Only the model's
functions are generated; the kernels are the hand-written ones.

The recorder (:func:`record`) runs each SoA function once on symbolic
arrays (:class:`Sym`): a state or control component is a leaf (``x[i]``,
``u[j]``), each params component is a leaf (``p.<field>[k]``, by the leaf
shapes of ``default_params()``), a Python number is a constant. It takes
indexing along leading axes, elementwise ``+ - * /`` and unary minus with
broadcasting over leading axes, ``torch.sin``, ``torch.cos``,
``torch.tan``, ``torch.abs`` (the functions csrc/dual.cuh differentiates)
and ``torch.stack``; any other operation raises ``NotImplementedError``
naming it and the model.

The emitter (:func:`emit_header`) writes one ``const`` local per node, in
the order the Python computed them, with explicit parentheses; nothing is
reassociated or folded. A node of params and constants only is ``float``,
the rest ``S``, so dual.cuh's mixed ``Dual ∘ float`` operators apply. Each
operation is written as PyTorch computes it on the card (csrc/custom.cuh):
``a / c`` by a Python constant multiplies by the constant's f32 reciprocal
(PyTorch's CUDA division by a CPU scalar), ``c / a`` is
``reciprocal(a) * c`` (``Tensor.__rtruediv__``), constants are exact f32
literals; so the kernels and the plain versions compute the same IEEE
operations. :func:`evaluate` replays a recording with PyTorch ops, which
the tests hold bit for bit against the SoA functions.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

# the operations the recorder takes, by the torch function that reaches it
_UNARY = {torch.sin: "sin", torch.cos: "cos", torch.tan: "tan",
          torch.abs: "abs"}
_DEVICE_UNARY = {"sin": "dual::sin_of", "cos": "dual::cos_of",
                 "tan": "dual::tan_of", "abs": "dual::abs_of"}
_TORCH_UNARY = {v: k for k, v in _UNARY.items()}


def f32(v) -> float:
    """A Python number rounded to f32, as PyTorch rounds a scalar operand
    of an f32 op."""
    return float(np.float32(v))


def f32_literal(v: float) -> str:
    """``v`` (an f32 value) as an exact C literal of type float."""
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    if math.isnan(v):
        raise ValueError("a NaN constant in a model function")
    text = f"{v:.9g}"
    if "e" not in text and "." not in text:
        text += ".0"
    if f32(float(text)) != v:   # %.9g round-trips every f32
        raise AssertionError(text)
    return f"{text}f" if v >= 0 else f"({text}f)"


class Node:
    """One scalar of a recording: ``op`` with ``args`` (Nodes or Python
    floats already rounded to f32); ``dep`` is True when it depends on the
    state or the controls (an ``S``), False for params and constants only
    (a ``float``)."""

    __slots__ = ("op", "args", "dep", "index")

    def __init__(self, op, args, dep, index):
        self.op, self.args, self.dep, self.index = op, args, dep, index


class _Tape:
    """The nodes of one model's recording, in the order Python made them."""

    def __init__(self, model_name):
        self.model_name = model_name
        self.nodes = []

    def node(self, op, args, dep=None):
        if dep is None:
            dep = any(isinstance(a, Node) and a.dep for a in args)
        nd = Node(op, tuple(args), dep, len(self.nodes))
        self.nodes.append(nd)
        return nd

    def unsupported(self, what):
        return NotImplementedError(
            f"model {self.model_name!r}: {what} is not an operation the "
            "kernels' recorder takes (indexing, + - * /, unary minus, "
            "torch.sin/cos/tan/abs, torch.stack); its kernel routes raise, "
            "its 'xla' routes and the CPU plain versions run it")


class Sym:
    """A symbolic array of scalar :class:`Node`\\ s (row-major), the
    stand-in for a tensor while a SoA function is recorded."""

    __slots__ = ("tape", "shape", "items")

    def __init__(self, tape, shape, items):
        self.tape, self.shape, self.items = tape, tuple(shape), list(items)

    # --- structure
    def __len__(self):
        if not self.shape:
            raise self.tape.unsupported("len() of a scalar")
        return self.shape[0]

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __getitem__(self, i):
        if isinstance(i, tuple) and len(i) == 1:
            i = i[0]
        if not isinstance(i, (int, np.integer)) or isinstance(i, bool):
            raise self.tape.unsupported(f"indexing with {i!r}")
        if not self.shape:
            raise self.tape.unsupported("indexing a scalar")
        n = self.shape[0]
        i = int(i)
        if not -n <= i < n:
            raise IndexError(f"index {i} out of range for length {n}")
        i %= n
        step = math.prod(self.shape[1:])
        return Sym(self.tape, self.shape[1:],
                   self.items[i * step:(i + 1) * step])

    # --- elementwise arithmetic, broadcast over leading axes
    def _binary(self, other, op, reflected=False):
        tape = self.tape
        if isinstance(other, Sym):
            shape = np.broadcast_shapes(self.shape, other.shape)
            a = _broadcast(self, shape)
            b = _broadcast(other, shape)
            pairs = zip(b, a) if reflected else zip(a, b)
            return Sym(tape, shape,
                       [tape.node(op, (x, y)) for x, y in pairs])
        if isinstance(other, bool) or not isinstance(other, (int, float)):
            raise tape.unsupported(
                f"{op} with a {type(other).__name__} operand")
        c = f32(other)
        if reflected:   # c op self: the torch op the reflected dunder runs
            rop = {"add": "add", "mul": "mul", "sub": "rsub",
                   "div": "rdiv"}[op]
            return Sym(tape, self.shape,
                       [tape.node(rop, (x, c)) for x in self.items])
        return Sym(tape, self.shape,
                   [tape.node(op, (x, c)) for x in self.items])

    def __add__(self, o):
        return self._binary(o, "add")

    def __radd__(self, o):
        return self._binary(o, "add", True)

    def __sub__(self, o):
        return self._binary(o, "sub")

    def __rsub__(self, o):
        return self._binary(o, "sub", True)

    def __mul__(self, o):
        return self._binary(o, "mul")

    def __rmul__(self, o):
        return self._binary(o, "mul", True)

    def __truediv__(self, o):
        return self._binary(o, "div")

    def __rtruediv__(self, o):
        return self._binary(o, "div", True)

    def __neg__(self):
        return Sym(self.tape, self.shape,
                   [self.tape.node("neg", (x,)) for x in self.items])

    def __pos__(self):
        return self

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise _tape_of(self).unsupported(f"the tensor attribute {name!r}")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tape = _find_tape(args)
        if func in _UNARY and len(args) == 1 and not kwargs:
            op = _UNARY[func]
            x = args[0]
            return Sym(tape, x.shape, [tape.node(op, (e,)) for e in x.items])
        if func is torch.stack and len(args) == 1 and not kwargs:
            items = list(args[0])
            if not items or not all(isinstance(s, Sym) for s in items):
                raise tape.unsupported("torch.stack of non-recorded values")
            shape = items[0].shape
            if any(s.shape != shape for s in items):
                raise tape.unsupported("torch.stack of unequal shapes")
            return Sym(tape, (len(items),) + shape,
                       [e for s in items for e in s.items])
        name = getattr(func, "__qualname__", None) or repr(func)
        raise tape.unsupported(f"torch.{name}" if not name.startswith(
            "torch") else name)


def _refuser(name):
    def refuse(self, *_a, **_k):
        raise self.tape.unsupported(f"the Python operator {name}")
    return refuse


for _name in ("__pow__", "__rpow__", "__matmul__", "__rmatmul__", "__mod__",
              "__rmod__", "__floordiv__", "__rfloordiv__", "__abs__",
              "__lt__", "__le__", "__gt__", "__ge__", "__bool__",
              "__float__", "__int__", "__index__"):
    setattr(Sym, _name, _refuser(_name))


def _tape_of(sym):
    return object.__getattribute__(sym, "tape")


def _find_tape(args):
    for a in args:
        if isinstance(a, Sym):
            return a.tape
        if isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, Sym):
                    return b.tape
    raise AssertionError("no recorded operand")


def _broadcast(s: Sym, shape):
    """The elements of ``s`` broadcast to ``shape``, row-major."""
    if s.shape == tuple(shape):
        return s.items
    idx = np.broadcast_to(
        np.arange(len(s.items)).reshape(s.shape), shape).reshape(-1)
    return [s.items[i] for i in idx]


class Recording(NamedTuple):
    """A model's SoA functions as scalar expressions."""
    name: str
    n: int
    m: int
    fields: tuple          # params field names, in field order
    shapes: tuple          # each field's leaf shape
    nodes: tuple           # every Node, in recording order
    dynamics: tuple        # n output Nodes
    cost: Node
    final_cost: Node


def param_shapes(model) -> tuple:
    """(field names, leaf shapes) of ``model.default_params()``."""
    params = model.default_params()
    fields = tuple(params._fields)
    shapes = tuple(tuple(torch.as_tensor(getattr(params, f)).shape)
                   for f in fields)
    return fields, shapes


def record(model) -> Recording:
    """Records ``model``'s SoA functions (see the module docstring); raises
    ``NotImplementedError`` naming an operation the recorder does not
    take."""
    if not model.has_soa:
        raise ValueError(f"model {model.name!r} has no SoA functions")
    tape = _Tape(model.name)
    fields, shapes = param_shapes(model)
    leaves = []
    for f, shape in zip(fields, shapes):
        size = math.prod(shape)
        leaves.append(Sym(tape, shape, [
            tape.node("p", (f, k), dep=False) for k in range(size)]))
    params = type(model.default_params())(*leaves)
    x = Sym(tape, (model.n,),
            [tape.node("x", (i,), dep=True) for i in range(model.n)])
    u = Sym(tape, (model.m,),
            [tape.node("u", (j,), dep=True) for j in range(model.m)])
    dx = model.dynamics_soa(params, x, u)
    if not isinstance(dx, Sym) or dx.shape != (model.n,):
        raise tape.unsupported(f"dynamics_soa returning {_describe(dx)} "
                               f"(expected shape ({model.n},))")
    c = model.cost_soa(params, x, u)
    cf = model.final_cost_soa(params, x)
    for what, v in (("cost_soa", c), ("final_cost_soa", cf)):
        if not isinstance(v, Sym) or v.shape != ():
            raise tape.unsupported(f"{what} returning {_describe(v)} "
                                   "(expected a scalar)")
    return Recording(model.name, model.n, model.m, fields, shapes,
                     tuple(tape.nodes), tuple(dx.items), c.items[0],
                     cf.items[0])


def _describe(v):
    return (f"a Sym of shape {v.shape}" if isinstance(v, Sym)
            else type(v).__name__)


# ---------------------------------------------------------------------------
# Evaluation in PyTorch (the recording replayed)
# ---------------------------------------------------------------------------

def evaluate(rec: Recording, params, x, u):
    """Replays ``rec`` with PyTorch ops on ``params`` (the model's params,
    leaves tensors), x (n, *batch) and u (m, *batch): (dx (n, *batch),
    cost, final cost), each operation the one the SoA function ran."""
    vals = {}
    leaves = {f: torch.as_tensor(getattr(params, f)).reshape(-1)
              for f in rec.fields}

    def val(a):
        return vals[a.index] if isinstance(a, Node) else a

    for nd in rec.nodes:
        op, args = nd.op, nd.args
        if op == "x":
            v = x[args[0]]
        elif op == "u":
            v = u[args[0]]
        elif op == "p":
            v = leaves[args[0]][args[1]]
        elif op in _TORCH_UNARY:
            v = _TORCH_UNARY[op](val(args[0]))
        elif op == "neg":
            v = -val(args[0])
        else:
            a, b = val(args[0]), val(args[1])
            v = {"add": lambda: a + b, "sub": lambda: a - b,
                 "mul": lambda: a * b, "div": lambda: a / b,
                 "rsub": lambda: b - a, "rdiv": lambda: b / a}[op]()
        vals[nd.index] = v
    dx = torch.stack(torch.broadcast_tensors(*[val(o) for o in rec.dynamics]))
    return dx, val(rec.cost), val(rec.final_cost)


# ---------------------------------------------------------------------------
# Emission of the traits header
# ---------------------------------------------------------------------------

_CXX_RESERVED = frozenset("""alignas alignof and and_eq asm auto bitand bitor
bool break case catch char char16_t char32_t char8_t class compl concept const
consteval constexpr constinit const_cast continue co_await co_return co_yield
decltype default delete do double dynamic_cast else enum explicit export
extern false float for friend goto if inline int long mutable namespace new
noexcept not not_eq nullptr operator or or_eq private protected public
register reinterpret_cast requires return short signed sizeof static
static_assert static_cast struct switch template this thread_local throw true
try typedef typeid typename union unsigned using virtual void volatile
wchar_t while xor xor_eq dt load u_lo u_hi N M Params""".split())


def _reachable(outputs):
    """Indices of the nodes ``outputs`` depend on."""
    seen, stack = set(), list(outputs)
    while stack:
        nd = stack.pop()
        if nd.index in seen:
            continue
        seen.add(nd.index)
        stack.extend(a for a in nd.args if isinstance(a, Node))
    return seen


def _expr(nd: Node, ref) -> str:
    """The C expression of ``nd`` over its operands' names ``ref``."""
    op, args = nd.op, nd.args
    if op == "x":
        return f"x[{args[0]}]"
    if op == "u":
        return f"u[{args[0]}]"
    if op == "p":
        return f"p.{args[0]}[{args[1]}]"
    if op in _DEVICE_UNARY:
        return f"{_DEVICE_UNARY[op]}({ref(args[0])})"
    if op == "neg":
        return f"(-{ref(args[0])})"
    a, b = args
    if op == "div" and not isinstance(b, Node):
        # PyTorch's CUDA division by a CPU scalar: a · f32(1 / f32(c))
        inv = float(np.float32(1.0) / np.float32(b))
        return f"({ref(a)} * {f32_literal(inv)})"
    if op == "rdiv":   # c / a as Tensor.__rtruediv__: reciprocal(a) · c
        return f"custom::rdiv({f32_literal(b)}, {ref(a)})"
    if op == "rsub":
        return f"({f32_literal(b)} - {ref(a)})"
    sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[op]
    rb = ref(b) if isinstance(b, Node) else f32_literal(b)
    return f"({ref(a)} {sym} {rb})"


def _body(rec: Recording, outputs, indent="    "):
    """The const locals that ``outputs`` need, in recording order, and a
    function mapping a node to the name that holds it."""
    need = _reachable(outputs)
    lines = []

    def ref(a):
        if not isinstance(a, Node):
            return f32_literal(a)
        if a.op in ("x", "u", "p"):
            return _expr(a, ref)
        return f"n{a.index}"

    for nd in rec.nodes:
        if nd.index not in need or nd.op in ("x", "u", "p"):
            continue
        ty = "S" if nd.dep else "float"
        lines.append(f"{indent}const {ty} n{nd.index} = {_expr(nd, ref)};")
    return lines, ref


def _out(nd: Node, ref) -> str:
    """An output node as an ``S`` (a params-only value lifted to S)."""
    return ref(nd) if nd.dep else f"custom::lift<S>({ref(nd)})"


def emit_header(rec: Recording) -> str:
    """The traits header of a recorded model (see the module docstring)."""
    for f in rec.fields:
        if f in _CXX_RESERVED or not f.isidentifier() or not f.isascii():
            raise ValueError(f"model {rec.name!r}: params field {f!r} cannot "
                             "name a member of the generated Params")
    sizes = [max(1, math.prod(s)) for s in rec.shapes]
    members = "".join(f"    float {f}[{k}];\n"
                      for f, k in zip(rec.fields, sizes))
    loads, r = [], 0
    for f, k in zip(rec.fields, sizes):
        for i in range(k):
            loads.append(f"    q.{f}[{i}] = p[{r}];\n")
            r += 1
    loads.append(f"    q.dt = p[{r}];\n")

    def limit(field, fallback):
        if field not in rec.fields:   # the wrappers refuse limits first
            return fallback
        k = sizes[rec.fields.index(field)]
        return f"p.{field}[{'j' if k == rec.m else '0'}]"

    dyn, dref = _body(rec, rec.dynamics)
    dyn += [f"    dx[{i}] = {_out(o, dref)};"
            for i, o in enumerate(rec.dynamics)]
    cst, cref = _body(rec, [rec.cost])
    cst.append(f"    return {_out(rec.cost, cref)};")
    fin, fref = _body(rec, [rec.final_cost])
    fin.append(f"    return {_out(rec.final_cost, fref)};")
    join = "\n".join
    return f"""// Generated by ilqr_tpu_torch/ops/codegen.py from the SoA functions of
// the custom model {rec.name!r}: its device functions in the shape of
// csrc/<model>.cuh, for the kernel templates of csrc/. Do not edit.
#pragma once

#include "custom.cuh"

namespace custom_model {{

struct Model : custom::DensePattern {{
  static constexpr int N = {rec.n};
  static constexpr int M = {rec.m};
  // the whole iteration, and the split sweep of the stencils and dual
  // numbers, on the team of iteration_team.cuh where N and M fit it, else
  // on one thread a lane (custom.cuh team_iteration)
  static constexpr bool kTeamIteration = custom::team_iteration(N, M);

  // Packed params (ops/kernel_rollout.pack_params): the params leaves in
  // field order, then dt.
  struct Params {{
{members}    float dt;
  }};

  __device__ __forceinline__ static Params load(const float* __restrict__ p) {{
    Params q;
{"".join(loads)}    return q;
  }}
  __device__ __forceinline__ static float u_lo(const Params& p, int j) {{
    return {limit("u_min", "-INFINITY")};
  }}
  __device__ __forceinline__ static float u_hi(const Params& p, int j) {{
    return {limit("u_max", "INFINITY")};
  }}

  template <class S>
  __device__ __forceinline__ static void dynamics(const Params& p,
                                                  const S x[N], const S u[M],
                                                  S dx[N]) {{
{join(dyn)}
  }}
  template <class S>
  __device__ __forceinline__ static S cost(const Params& p, const S x[N],
                                           const S u[M]) {{
{join(cst)}
  }}
  template <class S>
  __device__ __forceinline__ static S final_cost(const Params& p,
                                                 const S x[N]) {{
{join(fin)}
  }}
}};

}}  // namespace custom_model
"""


def team_width(n: int, m: int) -> int:
    """Threads a lane of the whole iteration and of the stencil and
    dual-number split sweep of a custom model with ``n`` states and ``m``
    controls, by the compile-time rule of its generated header: where
    csrc/custom.cuh ``team_iteration`` admits (n, m) (m·n < 32, 2(n + m) ≤
    32, m(n + 1) ≤ 32), the team of csrc/iteration_team.cuh at its
    ``team::kTeamWidth`` — 16 where half a warp holds the stencil's
    2(n + m) sides, the (n + m)(n + m + 1)/2 cost-Hessian pairs and the
    m(n + 1) gain entries one a thread, else 32; outside it 1, the
    one-thread kernels."""
    if not (m * n < 32 and 2 * (n + m) <= 32 and m * (n + 1) <= 32):
        return 1
    nz = n + m
    half = 2 * nz <= 16 and nz * (nz + 1) // 2 <= 16 and m * (n + 1) <= 16
    return 16 if half else 32


@functools.lru_cache(maxsize=None)
def _header_of(model) -> str:
    return emit_header(record(model))


def model_header(model) -> str:
    """The generated traits header of ``model`` (recorded once)."""
    return _header_of(model)
