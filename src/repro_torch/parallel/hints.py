"""Tensor-parallel marks of the paged serve path (the manual-TP half of
``repro/parallel/hints.py``), the training step's autograd collectives,
and the counted collectives they issue.

The sharded serve path runs every projection on the rank's local
head / d_ff slice (``parallel.plan.PagedServePlan.local_model``); the model
code marks where a Megatron column pair closes with ``tp_row_dot`` (the
K-contracted matmul) and ``tp_psum`` (the residual add's reduction).
Outside a ``manual_tp_axis`` region both are plain single-device code, as
in the reference.  Two modes, as there:

  * ``"gather"`` — all-gather the column-sharded intermediate along its
    last dim (shard order == the unsharded column order) and multiply it
    by the full, replicated row weight: every activation is the
    single-device value (bitwise on the CPU; on the card the column shard
    changes N, so a GEMM may split K otherwise);
  * ``"psum"``   — row-sharded closing weight, the contraction in f32 (a
    packed weight dequantized to f32 first), ONE f32 all-reduce per block,
    the cast to the activation dtype after it (rounding partials before
    the reduction was a bug of the reference, fixed there: keep the rule).

``TPComm`` holds one group's collectives and counts them: calls and the
bytes a device moves in ring terms (all-gather (n-1)/n of the gathered
tensor, all-reduce 2(n-1)/n of the reduced one, a ring hop the tensor),
which ``PagedServePlan.psum_bytes_per_step`` predicts.  A ``gloo`` group
(several ranks sharing one card, where NCCL refuses) takes CUDA tensors in
its all-gather, all-reduce and broadcast, and copies them through the
host itself: those calls are counted as ``gloo_cuda``.  Its send and recv
do not, so a ring hop of a CUDA tensor stages through pinned host memory
here, each copy counted (``host_copies``, ``host_bytes``).  An NCCL group
and CPU tensors take neither path.

The training step (``parallel/train.py``) runs ``Model.loss`` under a
``train_layout``: the model code marks a block's entry (``seq_enter``)
and exit (``seq_leave``), and asks which group splits a part
(``split_comm``: the gated norm's sum, the MoE experts) and which DP ranks
form the batch (``batch_comm``: the MoE capacity); off a training mesh
each mark is the identity and each question answers None.  The marks are
autograd functions whose backward is the matching collective: with
sequence parallelism a block's entry all-gathers the sequence
(``gather_dim``; its backward reduce-scatters), its exit reduce-scatters
the row-parallel partial sums (``scatter_sum_dim``; its backward
all-gathers), and a sum every rank needs (the SSM's gated norm) is an
all-reduce both ways (``all_reduce_sum``).  ``TPComm.phase`` labels the
counts of a training step: ``fwd``, ``bwd`` (a forward collective issued
in the backward pass is a remat recompute: ``remat``), and ``step`` (the
optimizer's and the compression's).  A ``gloo`` reduce-scatter of a CUDA
tensor stages through pinned host memory (counted), as the ring hops do;
a ``gloo`` all-gather goes round the ring by send / recv.

Static serving on a mesh (``parallel/serve.py``) runs ``Model.prefill``
/ ``decode_step`` under a ``serve_layout``: the same entry and exit marks
(an exit all-reduces a split part's f32 partial sums, ``tp_row_dot``
giving the partial), and the serving marks below, each the identity off a
serving mesh: ``cache_seq`` (a layer's context-parallel cache shard),
``combine_partials`` (per-shard attention partials merged in f32),
``heads_gather`` / ``own_heads`` (every head for the attention over a
sequence shard, then the rank's heads again), ``vocab_gather`` (whole
logits before the sampler), ``col_gather`` (the SSM's column-split B/C
projection) and ``ep_context`` (the expert-parallel group, the
counterpart of the reference's ``ep_context`` and ``__ep__`` rule).
``CountComm`` counts a group's collectives with no process group (one
rank of the dry-run's 256- and 512-card meshes).

The GSPMD hints (``shard_hint``, ``sharding_rules``, ``suspend_hints``)
have no counterpart: the port places every shard and issues every
collective itself.
"""
from __future__ import annotations

import contextlib
import contextvars
from collections import Counter

import torch
import torch.distributed as dist

from repro_torch.quant import formats
from repro_torch.quant.linear import is_packed, qdot


class _Pending:
    """A ring hop in flight: ``wait()`` returns the received tensor on the
    sender's device."""

    def __init__(self, comm: "TPComm", reqs, buf, like):
        self._comm, self._reqs, self._buf, self._like = comm, reqs, buf, like

    def wait(self) -> torch.Tensor:
        for r in self._reqs:
            r.wait()
        if self._buf.device == self._like.device:
            return self._buf
        return self._comm._to_device(self._buf, self._like.device)


class TPComm:
    """The collectives of one tensor-parallel process group, counted."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.counts: Counter = Counter()
        self.phase: str | None = None       # a training step's label

    def _count(self, kind: str, nbytes: int) -> None:
        """One call of ``kind`` moving ``nbytes`` a device, labelled by
        the step's phase (a forward collective in the backward pass is a
        remat recompute)."""
        phase = self.phase
        if phase == "bwd" and kind in ("all_gather", "all_gather_dim",
                                       "reduce_scatter_fwd", "all_reduce_fwd",
                                       "param_gather"):
            phase = "remat"
        key = kind if phase is None else f"{phase}:{kind}"
        self.counts[key] += 1
        self.counts[key + "_bytes"] += int(nbytes)
        self.counts["bytes"] += int(nbytes)

    def _global(self, group_rank: int) -> int:
        if self.group is None:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)

    def _gloo_cuda(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type == "cuda"

    def _to_host(self, x: torch.Tensor) -> torch.Tensor:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        torch.cuda.current_stream(x.device).synchronize()
        self.counts["host_copies"] += 1
        self.counts["host_bytes"] += x.nbytes
        return host

    def _to_device(self, host: torch.Tensor, device) -> torch.Tensor:
        out = host.to(device)           # from pageable or pinned: blocking
        self.counts["host_copies"] += 1
        self.counts["host_bytes"] += host.nbytes
        return out

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along the last dim, in rank
        order."""
        n = self.size
        self.counts["all_gather"] += 1
        self.counts["bytes"] += x.nbytes * (n - 1)
        if n == 1:
            return x
        if self._gloo_cuda(x):
            self.counts["gloo_cuda"] += 1
        return torch.cat(self._gather_list(x.contiguous()), dim=-1)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x`` (a new tensor)."""
        n = self.size
        self.counts["all_reduce"] += 1
        self.counts["bytes"] += 2 * (n - 1) * x.nbytes // n
        if n == 1:
            return x
        if self._gloo_cuda(x):
            self.counts["gloo_cuda"] += 1
        out = x.clone(memory_format=torch.contiguous_format)
        self._reduce_(out, "sum")
        return out

    def all_gather_dim(self, x: torch.Tensor, dim: int,
                       kind: str = "all_gather_dim") -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim``, in rank order.
        A gloo group moves the blocks round the ring by send / recv (a
        CUDA tensor staged through pinned host memory, each copy
        counted): gloo's own all-gather runs at a third of its
        point-to-point rate on one host."""
        n = self.size
        self._count(kind, x.nbytes * (n - 1))
        if n == 1:
            return x
        if self.backend == "gloo":
            return torch.cat(self._ring_gather(x), dim=dim)
        return torch.cat(self._gather_list(x.contiguous()), dim=dim)

    # -- the transport (``CountComm`` moves nothing) --
    def _gather_list(self, src: torch.Tensor) -> list:
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return parts

    def _reduce_(self, out: torch.Tensor, op: str) -> None:
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)

    def _reduce_scatter_(self, out: torch.Tensor, src: torch.Tensor) -> None:
        _reduce_scatter(out, src, group=self.group)

    def _ring_gather(self, x: torch.Tensor) -> list:
        """Every rank's ``x`` (rank order) by n - 1 ring hops: each passes
        on the block it received last."""
        n, r = self.size, self.rank
        cur = self._to_host(x) if self._gloo_cuda(x) else x.contiguous()
        parts = [None] * n
        parts[r] = x
        nxt, prev = self._global((r + 1) % n), self._global((r - 1) % n)
        for hop in range(n - 1):
            buf = torch.empty_like(cur)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, cur, nxt, self.group),
                    dist.P2POp(dist.irecv, buf, prev, self.group)]):
                req.wait()
            src = (r - 1 - hop) % n
            parts[src] = (buf if buf.device == x.device
                          else self._to_device(buf, x.device))
            cur = buf
        return parts

    def all_gather_stack(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked along a new leading dim (rank
        order)."""
        return self.all_gather_dim(x[None], 0, kind="all_gather")

    def reduce_scatter_dim(self, x: torch.Tensor, dim: int,
                           kind: str = "reduce_scatter") -> torch.Tensor:
        """The sum of every rank's ``x``, this rank's ``1/n`` block of it
        along ``dim`` (rank order).  A gloo group stages a CUDA tensor
        through pinned host memory, each copy counted."""
        n = self.size
        self._count(kind, x.nbytes * (n - 1) // n)
        if n == 1:
            return x
        moved = x.movedim(dim, 0).contiguous()
        if self._gloo_cuda(x):
            src = self._to_host(moved)
        else:
            src = moved
        out = torch.empty((src.shape[0] // n,) + src.shape[1:],
                          dtype=src.dtype, device=src.device)
        self._reduce_scatter_(out, src)
        if out.device != x.device:
            out = self._to_device(out, x.device)
        return out.movedim(0, dim)

    def all_reduce_op(self, x: torch.Tensor, op: str = "sum",
                      kind: str = "all_reduce") -> torch.Tensor:
        """``all_reduce`` with ``op`` "sum" or "max" (a new tensor)."""
        n = self.size
        self._count(kind, 2 * (n - 1) * x.nbytes // n)
        if n == 1:
            return x
        if self._gloo_cuda(x):
            self.counts["gloo_cuda"] += 1
        out = x.clone(memory_format=torch.contiguous_format)
        self._reduce_(out, op)
        return out

    def broadcast_float(self, value: float) -> float:
        """Group rank 0's ``value`` on every rank (host scalars: a CPU
        tensor for gloo, a CUDA one for NCCL)."""
        self.counts["broadcast"] += 1
        if self.size == 1:
            return value
        dev = "cuda" if self.backend == "nccl" else "cpu"
        t = torch.tensor([value], dtype=torch.float64, device=dev)
        dist.broadcast(t, src=self._global(0), group=self.group)
        return float(t.item())

    def ring_shift(self, x: torch.Tensor) -> _Pending:
        """Post one ring hop: send ``x`` to the next rank of the group and
        receive the previous rank's tensor of the same shape.  Returns at
        once; ``wait()`` on the result gives the received tensor."""
        n = self.size
        self.counts["ring_hop"] += 1
        self.counts["bytes"] += x.nbytes
        src = self._to_host(x) if self._gloo_cuda(x) else x.contiguous()
        buf = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, self._global((self.rank + 1) % n),
                          self.group),
               dist.P2POp(dist.irecv, buf, self._global((self.rank - 1) % n),
                          self.group)]
        return _Pending(self, dist.batch_isend_irecv(ops), buf, x)


class CountComm(TPComm):
    """A group of ``size`` ranks with no process group behind it: one rank
    of a mesh counted in one process (the dry-run's pod meshes).  Every
    collective is counted as ``TPComm`` counts it and moves nothing: it
    returns a tensor of the right shape on the input's device (``meta``
    in a count), each other rank's part taken equal to this rank's."""

    def __init__(self, size: int, rank: int = 0):
        self.group = None
        self.size, self.rank, self.backend = int(size), int(rank), "count"
        self.counts = Counter()
        self.phase = None
        # by the reference's collective kinds: calls, operand bytes (the
        # result's, its spec metric) and wire bytes (ring terms)
        self.ops: dict = {}

    def _op(self, kind: str, operand: int, wire: int) -> None:
        rec = self.ops.setdefault(kind, {"count": 0, "operand_bytes": 0,
                                         "wire_bytes": 0})
        rec["count"] += 1
        rec["operand_bytes"] += int(operand)
        rec["wire_bytes"] += int(wire)

    def all_gather_last(self, x):
        self._op("all-gather", x.nbytes * self.size,
                 x.nbytes * (self.size - 1))
        return super().all_gather_last(x)

    def all_gather_dim(self, x, dim, kind="all_gather_dim"):
        self._op("all-gather", x.nbytes * self.size,
                 x.nbytes * (self.size - 1))
        return super().all_gather_dim(x, dim, kind)

    def all_reduce(self, x):
        self._op("all-reduce", x.nbytes,
                 2 * (self.size - 1) * x.nbytes // self.size)
        return super().all_reduce(x)

    def all_reduce_op(self, x, op="sum", kind="all_reduce"):
        self._op("all-reduce", x.nbytes,
                 2 * (self.size - 1) * x.nbytes // self.size)
        return super().all_reduce_op(x, op, kind)

    def reduce_scatter_dim(self, x, dim, kind="reduce_scatter"):
        self._op("reduce-scatter", x.nbytes // self.size,
                 x.nbytes * (self.size - 1) // self.size)
        return super().reduce_scatter_dim(x, dim, kind)

    def _gather_list(self, src: torch.Tensor) -> list:
        return [src.clone() for _ in range(self.size)]

    def _reduce_(self, out: torch.Tensor, op: str) -> None:
        if op == "sum":
            out.mul_(self.size)

    def _reduce_scatter_(self, out: torch.Tensor, src: torch.Tensor) -> None:
        k = out.shape[0]
        out.copy_(src[self.rank * k:(self.rank + 1) * k] * self.size)

    def broadcast_float(self, value: float) -> float:
        self.counts["broadcast"] += 1
        return value

    def ring_shift(self, x: torch.Tensor):
        raise NotImplementedError("a counted group moves no ring hops")


# ``reduce_scatter_single`` where torch has it (``reduce_scatter_tensor``,
# the same call, is deprecated there)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)

_TP: contextvars.ContextVar[TPComm | None] = contextvars.ContextVar(
    "manual_tp_comm", default=None)
_TP_MODE: contextvars.ContextVar[str] = contextvars.ContextVar(
    "manual_tp_mode", default="gather")


@contextlib.contextmanager
def manual_tp_axis(group, mode: str = "gather"):
    """Run the enclosed model code as one rank of the tensor-parallel
    ``group`` (a ``TPComm``, or a process group to wrap), closing each
    column/row pair per ``mode``."""
    if mode not in ("gather", "psum"):
        raise ValueError(f"mode={mode!r} (want 'gather' or 'psum')")
    comm = group if isinstance(group, TPComm) else TPComm(group)
    token = _TP.set(comm)
    mtoken = _TP_MODE.set(mode)
    try:
        yield comm
    finally:
        _TP_MODE.reset(mtoken)
        _TP.reset(token)


@contextlib.contextmanager
def no_manual_tp():
    """Turn the marks off for subtrees whose weights are replicated inside
    a TP region (MoE experts, shared experts): their matmuls are already
    complete."""
    token = _TP.set(None)
    try:
        yield
    finally:
        _TP.reset(token)


def tp_psum(x: torch.Tensor) -> torch.Tensor:
    """Close a Megatron column->row pair: the one reduction per block in
    ``"psum"`` mode (of ``tp_row_dot``'s f32 partial); identity in
    ``"gather"`` mode and outside a TP region."""
    comm = _TP.get()
    if comm is None or _TP_MODE.get() == "gather":
        return x
    return comm.all_reduce(x)


def tp_row_dot(x: torch.Tensor, w) -> torch.Tensor:
    """The K-contracted matmul closing a Megatron pair: ``qdot(x, w)``
    outside a TP region (under a layout, its ``row_dot``: a serving
    rank's f32 partial of a row-split weight); in ``"gather"`` mode
    ``qdot`` of the all-gathered ``x`` with the full replicated ``w``; in ``"psum"`` mode the f32
    partial ``x @ w_rows`` (a packed ``w`` dequantized to f32 first; an
    MXFP4 one takes ``x`` rounded to bf16, as ``qdot``'s MXFP4 product
    does), for ``tp_psum`` to reduce before the caller casts."""
    comm = _TP.get()
    if comm is None:
        lay = _LAYOUT.get()
        return qdot(x, w) if lay is None else lay.row_dot(x, w)
    if _TP_MODE.get() == "gather":
        return qdot(comm.all_gather_last(x), w)
    if isinstance(w, formats.PackedMXFP4):
        # the MXFP4 product takes bf16 activations (``qdot``'s kernel op):
        # the same product, split over K
        x = x.to(torch.bfloat16)
    if is_packed(w):
        w = formats.dequantize_any(w, torch.float32)
    return x.float() @ w.float()


# -- the training step's autograd collectives --------------------------------


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` (a sequence-parallel block's entry); the
    backward reduce-scatters the gradient back to this rank's block."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather_dim(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter_dim(g, ctx.dim), None, None


class _ScatterSumDim(torch.autograd.Function):
    """Reduce-scatter (sum) along ``dim`` (a row-parallel block's exit
    under sequence parallelism); the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.reduce_scatter_dim(x, dim, kind="reduce_scatter_fwd")

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather_dim(g, ctx.dim,
                                       kind="all_gather_bwd"), None, None


class _AllReduceSum(torch.autograd.Function):
    """A sum every rank needs (each rank's part enters every rank's
    result): all-reduce both ways."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_reduce_op(x, kind="all_reduce_fwd")

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce_op(g, kind="all_reduce_bwd"), None


def gather_dim(x: torch.Tensor, comm: TPComm | None, dim: int) -> torch.Tensor:
    """``x`` all-gathered along ``dim`` over ``comm`` under autograd (x
    itself without a group or on one rank)."""
    if comm is None or comm.size == 1:
        return x
    return _GatherDim.apply(x, comm, dim)


def scatter_sum_dim(x: torch.Tensor, comm: TPComm | None,
                    dim: int) -> torch.Tensor:
    """The ranks' ``x`` summed, this rank's block along ``dim``, under
    autograd."""
    if comm is None or comm.size == 1:
        return x
    return _ScatterSumDim.apply(x, comm, dim)


def all_reduce_sum(x: torch.Tensor, comm: TPComm | None) -> torch.Tensor:
    """The ranks' ``x`` summed, on every rank, under autograd."""
    if comm is None or comm.size == 1:
        return x
    return _AllReduceSum.apply(x, comm)


# -- the training layout's marks in the model code -----------------------------

_LAYOUT: contextvars.ContextVar = contextvars.ContextVar("train_layout",
                                                         default=None)


@contextlib.contextmanager
def train_layout(layout):
    """Run the enclosed model code as one rank of ``layout`` (a
    ``parallel.train.TrainLayout``, or a ``parallel.serve.ServeLayout``):
    the model reads its weights, local widths and marks from it."""
    token = _LAYOUT.set(layout)
    try:
        yield layout
    finally:
        _LAYOUT.reset(token)


serve_layout = train_layout


def active_layout():
    """The layout the model code runs under (training or serving), or
    None."""
    return _LAYOUT.get()


def _serving():
    """The serving layout the model code runs under, or None."""
    lay = _LAYOUT.get()
    return lay if getattr(lay, "serving", False) else None


def seq_enter(h: torch.Tensor) -> torch.Tensor:
    """A block's entry: the rank's positions all-gathered over the model
    axis (sequence parallelism); ``h`` off a training mesh and on a
    serving one (its residual stream is whole)."""
    lay = _LAYOUT.get()
    return h if lay is None else lay.enter(h)


def seq_leave(out: torch.Tensor, part: str) -> torch.Tensor:
    """A block's exit from ``part`` ("attn", "mlp", "moe", "ssm"): on a
    training mesh back to the rank's positions, on a serving mesh the
    ranks' partial sums all-reduced where ``part`` is split (the caller
    casts to the residual's dtype); ``out`` off a mesh."""
    lay = _LAYOUT.get()
    return out if lay is None else lay.leave(out, part)


def split_comm(part: str) -> TPComm | None:
    """The group over which ``part``'s heads, channels or experts are
    split on a training mesh, or None (whole on this rank)."""
    lay = _LAYOUT.get()
    return None if lay is None else lay.split_comm(part)


def batch_comm() -> TPComm | None:
    """The DP ranks whose rows form the batch the model sees on a training
    mesh (their order is the batch's), or None."""
    lay = _LAYOUT.get()
    return None if lay is None else lay.batch_comm


# -- the serving layout's marks (identities off a serving mesh) ---------------


def cache_seq(width: int):
    """The context-parallel shard of a layer's dense cache of ``width``
    entries on a serving mesh (``parallel.serve.SeqShard``: the
    ``cache_seq`` group, the first entry this rank holds and how many),
    or None."""
    lay = _serving()
    return None if lay is None else lay.seq_shard(width)


def combine_partials(out: torch.Tensor, lse: torch.Tensor,
                     comm: TPComm) -> torch.Tensor:
    """The whole attention output from each rank's partial over its
    shard of the keys: ``out`` (..., D) normalised over the shard, ``lse``
    (...) its f32 log-sum-exp (-inf where the shard held no valid key).
    In f32: an all-reduce of the max, then one of the rescaled outputs and
    sums together."""
    lse = lse.float()
    if comm.size == 1:
        return out.float()
    m = comm.all_reduce_op(lse, "max", kind="attn_max")
    m = torch.where(torch.isfinite(m), m, torch.zeros((), device=m.device))
    wgt = torch.exp(lse - m)[..., None]
    tot = comm.all_reduce_op(torch.cat([out.float() * wgt, wgt], dim=-1),
                             kind="attn_sum")
    return tot[..., :-1] / tot[..., -1:]


def heads_gather(x: torch.Tensor, dim: int, kv: bool = False) -> torch.Tensor:
    """Every head of ``x`` (a rank's query heads, or with ``kv`` its KV
    heads, along ``dim``) on a serving mesh whose ``tp`` group splits the
    heads; ``x`` otherwise."""
    lay = _serving()
    return x if lay is None else lay.heads_gather(x, dim, kv)


def own_heads(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's query heads of ``x`` (every head along ``dim``) on a
    serving mesh that splits them; ``x`` otherwise."""
    lay = _serving()
    return x if lay is None else lay.own_heads(x, dim)


def vocab_gather(logits: torch.Tensor) -> torch.Tensor:
    """Whole-vocabulary logits from a serving rank's vocabulary columns
    (the reference's ``logits`` rule), before the sampler."""
    lay = _serving()
    return logits if lay is None else lay.vocab_gather(logits)


def col_gather(y: torch.Tensor, part: str) -> torch.Tensor:
    """The whole last dim of a product whose weight a serving rank holds
    as a column block (``part``: "ssm_bc", the SSM's B/C projection);
    ``y`` otherwise."""
    lay = _serving()
    return y if lay is None else lay.col_gather(y, part)


def ep_context() -> TPComm | None:
    """The expert-parallel group of the MoE layers (the reference's
    ``ep_context`` / ``__ep__`` rule: a serving plan with ``ep`` whose
    ``tp`` is the ``model`` axis, of more than one rank, that splits the
    experts), or None."""
    lay = _serving()
    return None if lay is None else lay.ep_comm
