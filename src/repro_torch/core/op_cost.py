"""Count the work of one step by running it once, eagerly: the port's
counterpart of the reference's ``core/hlo_cost.py``.

The reference walks compiled HLO text.  PyTorch has no such program to
read, so this runs the step once under a dispatch mode that sees every
aten op (autograd's backward ops and a remat recompute included) and
counts what the walker counts:

  * FLOPs: the formulas of ``torch.utils.flop_counter.FlopCounterMode``
    (its ``flop_registry``), which count mm / bmm / addmm / baddbmm /
    convolution / SDPA (forward and backward) as the walker counts ``dot``
    and ``convolution``; elementwise work counts nothing in either;
  * op-level bytes (``Cost.bytes``): the inputs and outputs of every aten
    op, the same "operands + result" proxy as the walker's and XLA's cost
    model.  Views, ``detach``, factory ops and metadata ops move nothing;
    an indexed write (``index_put_``, ``scatter``, ``index_copy_``,
    ``slice_scatter``) reads and writes only the updated region, as the
    walker counts ``dynamic-update-slice`` / ``scatter``, and ``copy_`` /
    ``fill_`` into a slice only that slice.  An unfused eager program
    moves each intermediate through memory, so this overstates what the
    card must move;
  * ``Cost.bound_bytes``: the least traffic the step can have: each
    argument tensor of the step (weights, cache, optimizer state, batch)
    read once, each region of them the step writes in place written
    once, and each tensor it returns written once;
  * the hand-written kernels: a kernel is a ``ctypes`` call that no
    dispatch mode sees, so on ``meta`` tensors each wrapper reports the
    FLOPs and bytes of ``kernels/cost.py``'s formula for its launch here
    (``Cost.kernels``), and they add into ``flops`` and ``bytes``.

The walker multiplies a ``while`` body by its trip count and counts the
loops whose count it cannot read (``unknown_trip_loops``).  An eager
program has no such problem: a Python loop runs every iteration, and each
runs its ops, so every iteration is counted as it runs and
``unknown_trip_loops`` stays 0.

Run the step on ``meta`` tensors and it allocates nothing, so a
full-size model's step is counted on any host.  Most of the time goes to
PyTorch's ``meta`` kernels (their shape rules run in Python, ~0.3 ms an
op), and a step repeats the same op on the same shapes many times (every
layer, every block of plain attention): so on ``meta`` an op that writes
no argument and returns new tensors runs once per signature (the op, its
arguments' shapes, strides and dtypes, its other arguments), and later
calls get empty tensors of the output shapes it gave.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kernel_cost

aten = torch.ops.aten

# aliases of their input under another name (no schema alias annotation),
# and factory ops that take a tensor only for its dtype and device
_FREE = {aten._unsafe_view, aten.lift_fresh, aten.alias, aten.detach,
         aten.new_empty, aten.new_empty_strided, aten.new_zeros,
         aten.new_ones, aten.new_full, aten.empty_like, aten.zeros_like,
         aten.ones_like, aten.full_like, aten.rand_like, aten.randn_like}
# the argument that holds the updated region of an indexed write
_REGION_WRITES = {
    aten.index_put_: "values", aten.index_put: "values",
    aten._index_put_impl_: "values",
    aten.scatter_: "src", aten.scatter: "src",
    aten.scatter_add_: "src", aten.scatter_add: "src",
    aten.scatter_reduce_: "src", aten.scatter_reduce: "src",
    aten.index_copy_: "source", aten.index_copy: "source",
    aten.index_add_: "source", aten.index_add: "source",
    aten.slice_scatter: "src", aten.select_scatter: "src",
    aten.diagonal_scatter: "src",
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@dataclasses.dataclass
class Cost:
    """What one run of a step did; FLOPs and bytes of one device."""

    flops: float = 0.0
    bytes: float = 0.0              # op-level: inputs + outputs of each op
    bound_bytes: float = 0.0        # arguments once, writes once
    unknown_trip_loops: int = 0     # always 0 (see the module docstring)
    ops: int = 0                    # aten ops dispatched (views included)
    kernels: dict = dataclasses.field(default_factory=dict)


class _Uncacheable(Exception):
    pass


def _signature(x):
    """A hashable key of an op's argument (``_Uncacheable`` for a tensor
    off ``meta`` or an argument with no such key)."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _Uncacheable
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_signature(i) for i in x)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return (type(x), x)
    raise _Uncacheable


def _fresh(func) -> bool:
    """The op writes none of its arguments and returns new tensors."""
    schema = func._schema
    return not (func._overloadpacket in _FREE or func.is_view
                or any(a.alias_info is not None for a in schema.arguments)
                or any(r.alias_info is not None for r in schema.returns))


class _Counting(TorchDispatchMode):
    """Runs each aten op (``meta`` outputs from the signature cache where
    it can) and counts it in its ``OpCounter``."""

    def __init__(self, counter: "OpCounter"):
        super().__init__()
        self.counter = counter
        self.cache: dict = {}

    def _run(self, func, args, kwargs):
        if not _fresh(func):
            return func(*args, **kwargs)
        try:
            key = (func, _signature(args), _signature(tuple(kwargs.items())))
        except _Uncacheable:
            return func(*args, **kwargs)
        spec = self.cache.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if all(isinstance(t, torch.Tensor) and t.is_meta for t in outs):
                self.cache[key] = (
                    isinstance(out, (tuple, list)),
                    [(t.shape, t.stride(), t.dtype) for t in outs])
            return out
        many, metas = spec
        outs = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
                for shape, stride, dtype in metas]
        return tuple(outs) if many else outs[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.counter.cost.flops += flop_registry[packet](
                *args, **kwargs, out_val=out)
        self.counter._count(func, args, kwargs, out)
        return out


class OpCounter:
    """A context manager over one eager run of a step.

    ``inputs``: every tensor argument of the step (any pytree: the model's
    parameters, the batch, the cache, the optimizer state); ``bound_bytes``
    counts each of their storages once.  Hand the step's return value to
    ``outputs(...)`` before the context ends; ``cost`` is complete after
    it ends.

        with OpCounter(inputs=(params, batch)) as oc:
            oc.outputs(step(batch))
        oc.cost.flops, oc.cost.bytes, oc.cost.bound_bytes
    """

    def __init__(self, inputs=()):
        self.cost = Cost()
        self._inputs: dict[int, int] = {}          # storage -> bytes
        for t in tensors(inputs):
            self._inputs.setdefault(storage_key(t),
                                    t.untyped_storage().nbytes())
        self._written: dict[int, int] = defaultdict(int)
        self._out_bytes = 0
        self._mode = _Counting(self)

    def __enter__(self) -> "OpCounter":
        self._mode.__enter__()
        kernel_cost.SINKS.append(self)
        return self

    def __exit__(self, *exc):
        kernel_cost.SINKS.remove(self)
        self._mode.__exit__(*exc)
        c = self.cost
        written = sum(min(n, self._inputs[k])
                      for k, n in self._written.items())
        c.bound_bytes = sum(self._inputs.values()) + written + self._out_bytes
        return False

    def outputs(self, out):
        """Count the step's return value as written once (tensors whose
        storage is an argument's count as that argument's writes)."""
        for t in tensors(out):
            if storage_key(t) not in self._inputs:
                self._out_bytes += _nbytes(t)
        return out

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        """One launch of a hand-written kernel (``kernels.cost.record``)."""
        k = self.cost.kernels.setdefault(
            name, {"launches": 0, "flops": 0, "bytes": 0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.cost.flops += flops
        self.cost.bytes += nbytes

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        c.ops += 1
        schema = func._schema
        outs = tensors(out)
        if not outs or func._overloadpacket in _FREE or (
                func.is_view or (schema.returns and all(
                    r.alias_info is not None and not r.alias_info.is_write
                    for r in schema.returns))):
            return                                  # views and metadata
        ins = tensors((args, kwargs))
        if not ins:
            return                                  # factory ops
        packet = func._overloadpacket
        bound = None
        region = _arg(schema, args, kwargs, _REGION_WRITES.get(packet))
        if isinstance(region, torch.Tensor):
            bound = _nbytes(region)
            c.bytes += 2 * bound + sum(
                _nbytes(t) for t in tensors(_arg(schema, args, kwargs,
                                                  "indices", "index")))
        elif packet in (aten.copy_, aten.fill_, aten.zero_):
            dst = args[0]
            c.bytes += _nbytes(dst) + sum(_nbytes(t) for t in ins[1:])
            bound = _nbytes(dst)
        else:
            c.bytes += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in outs)
        # writes into an argument of the step, in place
        for i, a in enumerate(schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            t = args[i] if i < len(args) else kwargs.get(a.name)
            if isinstance(t, torch.Tensor):
                key = storage_key(t)
                if key in self._inputs:
                    self._written[key] += _nbytes(t) if bound is None else bound


def _arg(schema, args, kwargs, *names):
    for i, a in enumerate(schema.arguments):
        if a.name in names:
            return args[i] if i < len(args) else kwargs.get(a.name)
    return None


def count(fn, *args, inputs=()) -> tuple[object, Cost]:
    """Run ``fn(*args)`` once under an ``OpCounter`` whose arguments are
    ``args`` and ``inputs`` (e.g. the model's parameters); returns its
    output and the ``Cost``."""
    with OpCounter(inputs=(args, inputs)) as oc:
        out = oc.outputs(fn(*args))
    return out, oc.cost
