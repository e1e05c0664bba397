"""The cost meter: FLOPs and bytes of one eager run of a torch program —
the port's counterpart of ``repro.analysis.hlo``.

The reference prices a compiled program by parsing its optimized HLO
text. The port has no HLO: its programs are eager PyTorch (captured as
CUDA graphs on the card, which no one can look into). So it prices a
program by running it once, eagerly, under :class:`Meter`, a
``TorchDispatchMode`` that sees every aten op it dispatches, and counts:

* **FLOPs** with ``torch.utils.flop_counter``'s formula table (2·M·N·K a
  product, the reference parser's convention), for every op the table
  knows;
* **sorts** as the reference parser charges an HLO ``sort``: n·log2(n)
  for n elements (at least n), where n is all the elements of the sorted
  tensor (the MoE dispatch's argsort; ``topk`` is no sort there either);
* **bytes** as the input and output bytes of every aten op that is not a
  view or metadata op (``_SKIP_BYTES``, the counterpart of
  ``hlo._SKIP_BYTES``), each tensor once per op (an in-place op's output
  is its input). Indexing ops move only what they index, as the parser
  bills them: a gather (``_GATHERS``, the embedding lookup among them)
  twice its output, a scatter into a big tensor (``_SCATTERS``: a cache
  write) twice its update — never the whole table or cache;
* **every kernel call through ``kernels/ops.py``**, priced by
  ``kernels/costs.py`` from its operands' shapes, with the ops inside the
  call left out. On the CPU the call runs the kernel's plain version,
  whose matmuls are therefore not counted twice; on the card the ctypes
  launch dispatches no op of its own. Either way the call is charged its
  closed form, so the CPU and the card count the same program the same.

A kernel that is called while metering and has no registry entry lands in
``unpriced_kernels`` (the counterpart of ``unpriced_custom_calls``), and
the cost pass fails on it.

The kernel wrappers reach the meter through ``kernels._build.METER`` (set
while a meter is entered): with no meter the hook costs a wrapper one
global read. Nothing is counted while a CUDA graph is being captured.

The counts are shapes times formulas: under ``FakeTensorMode`` the same
program is priced without allocating anything (the full-width counts on
the CPU), and they equal the card's bit for bit.
"""

from __future__ import annotations

import collections
import inspect
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build
from repro_torch.kernels import costs as kernel_costs

aten = torch.ops.aten

# ops that move no bytes: aliasing and metadata (views are caught by
# ``OpOverload.is_view``, and ops outside ``aten`` — ``prim.device``, a
# ``.device`` query under a mode — are metadata too), and allocations that
# write nothing
_SKIP_BYTES = {aten.detach, aten.alias, aten.lift_fresh, aten._unsafe_view,
               aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten.set_,
               aten.resize_, aten.sym_size, aten.sym_stride,
               aten.sym_numel, aten.sym_storage_offset, aten.is_same_size}

# hlo.py bills dynamic-slice/gather/slice 2x their output and
# dynamic-update-slice/scatter 2x their update: the big operand is aliased
_GATHERS = {aten.index, aten.index_select, aten.embedding, aten.gather,
            aten.take}
# scatter op -> position of its update operand
_SCATTERS = {aten.index_put: 2, aten.index_put_: 2,
             aten._index_put_impl_: 2, aten.index_copy: 3,
             aten.index_copy_: 3, aten.scatter: 3, aten.scatter_: 3,
             aten.index_add: 3, aten.index_add_: 3, aten.scatter_add: 3,
             aten.scatter_add_: 3}

# torch dtype -> the reference's HLO dtype string
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16", torch.float64: "f64", torch.int32: "s32",
           torch.int64: "s64", torch.int16: "s16", torch.int8: "s8",
           torch.uint8: "u8", torch.bool: "pred"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def shape_of(t: torch.Tensor) -> kernel_costs.Shape:
    """A tensor as the registry's :class:`~repro_torch.kernels.costs.Shape`."""
    return kernel_costs.Shape(_DTYPES.get(t.dtype, str(t.dtype)),
                              tuple(t.shape), _nbytes(t))


def tensors_of(tree) -> list:
    """The tensors of a tree of args (lists, tuples, dicts)."""
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _out_shape(out) -> kernel_costs.Shape:
    """The result as one Shape: a tuple of outputs (the backward's dq, dk,
    dv) is its first member's dtype and dims with the bytes of them all."""
    ts = tensors_of(out)
    first = shape_of(ts[0])
    return kernel_costs.Shape(first.dtype, first.dims,
                              sum(_nbytes(t) for t in ts))


def _operands(name, fn, args, kwargs) -> list:
    """The tensor operands of a wrapper call, in the reference kernel's
    operand order and shapes: the wrapper's own argument order, with a
    paged read's ``page_map`` (the reference's scalar-prefetch operand)
    first, and ``stmc_conv``'s window (B, K, Cin) and weight (K, Cin,
    Cout) unrolled to (B, K*Cin) and (K*Cin, Cout)."""
    bound = inspect.signature(fn).bind(*args, **kwargs)
    named = [(n, v) for n, v in bound.arguments.items()
             if isinstance(v, torch.Tensor)]
    named.sort(key=lambda nv: nv[0] != "page_map")
    shapes = [shape_of(v) for _, v in named]
    if name == "stmc_conv":
        win, w = shapes[0], shapes[1]
        shapes[0] = kernel_costs.Shape(
            win.dtype, (win.dims[0], win.dims[1] * win.dims[2]), win.bytes)
        shapes[1] = kernel_costs.Shape(
            w.dtype, (w.dims[0] * w.dims[1], w.dims[2]), w.bytes)
    return shapes


def _price_copy_pages(fn, args, kwargs):
    """``copy_pages_leaves(pools, srcs, dsts)``: one reference
    ``copy_pages`` a leaf, each with its (2, n) int32 pair table."""
    bound = inspect.signature(fn).bind(*args, **kwargs)
    a = bound.arguments
    total = {"flops": 0.0, "bytes": 0.0}
    for pool, src in zip(a["pools"], a["srcs"]):
        n = len(src)
        table = kernel_costs.Shape("s32", (2, n), 2 * n * 4)
        one = kernel_costs.price("copy_pages", shape_of(pool),
                                 (table, shape_of(pool)))
        if one is None:
            return None
        total["flops"] += one["flops"]
        total["bytes"] += one["bytes"]
    return total


def price_call(name: str, fn, args, kwargs, out) -> dict | None:
    """``{"flops", "bytes"}`` of one kernel wrapper call, or None when the
    registry has no entry for ``name``."""
    if name not in kernel_costs.KERNEL_COSTS:
        return None
    if name == "copy_pages":
        return _price_copy_pages(fn, args, kwargs)
    return kernel_costs.price(name, _out_shape(out),
                              _operands(name, fn, args, kwargs))


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


class Meter(TorchDispatchMode):
    """Count the FLOPs and bytes of what runs inside ``with Meter() as m:``.

    After the block: ``m.flops``, ``m.bytes``, ``m.by_op`` (FLOPs per aten
    op or kernel name), ``m.kernels`` (priced calls per kernel name) and
    ``m.unpriced_kernels`` (sorted names of kernels called without a
    registry entry)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op = collections.defaultdict(float)
        self.kernels = collections.Counter()
        self._unpriced = set()
        self._depth = 0           # > 0 inside a kernel call
        self._outer = None

    @property
    def unpriced_kernels(self) -> list:
        return sorted(self._unpriced)

    def __enter__(self):
        self._outer = _build.METER
        _build.METER = self
        return super().__enter__()

    def __exit__(self, *exc):
        _build.METER = self._outer
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._depth or _capturing():
            return out
        pkt = func.overloadpacket
        formula = flop_registry.get(pkt)
        if formula is not None:
            f = float(formula(*args, **kwargs, out_val=out))
        elif pkt is aten.sort:
            n = out[0].numel()
            f = n * max(math.log2(max(n, 2)), 1.0)
        else:
            f = None
        if f is not None:
            self.flops += f
            self.by_op[str(pkt)] += f
        self.bytes += float(self._op_bytes(func, pkt, args, kwargs, out))
        return out

    @staticmethod
    def _op_bytes(func, pkt, args, kwargs, out) -> int:
        if pkt in _SKIP_BYTES or func.is_view or func.namespace != "aten":
            return 0
        if pkt in _GATHERS:
            return 2 * sum(_nbytes(t) for t in tensors_of(out))
        if pkt in _SCATTERS:
            i = _SCATTERS[pkt]
            upd = args[i] if len(args) > i else None
            if isinstance(upd, torch.Tensor):
                return 2 * _nbytes(upd)
        seen = {}
        for t in tensors_of((args, kwargs)) + tensors_of(out):
            seen[id(t)] = t
        return sum(_nbytes(t) for t in seen.values())

    def kernel_call(self, name: str, fn, args, kwargs):
        """Run the kernel wrapper ``fn`` with the ops inside it uncounted,
        and charge the call its registry price."""
        if self._depth or _capturing():
            return fn(*args, **kwargs)
        self._depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._depth -= 1
        priced = price_call(name, fn, args, kwargs, out)
        if priced is None:
            self._unpriced.add(name)
        else:
            self.flops += priced["flops"]
            self.bytes += priced["bytes"]
            self.by_op[name] += priced["flops"]
        self.kernels[name] += 1
        return out


def measure(fn, *args, **kwargs) -> tuple:
    """``(result, meter)`` of one metered call of ``fn``."""
    with Meter() as m:
        out = fn(*args, **kwargs)
    return out, m


def flops_of(fn, *args):
    """FLOPs of one eager call of ``fn(*args)`` (the counterpart of
    ``hlo.flops_of``)."""
    return measure(fn, *args)[1].flops
