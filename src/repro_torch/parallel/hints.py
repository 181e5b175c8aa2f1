"""Tensor-parallel marks of the paged serve path (the manual-TP half of
``repro/parallel/hints.py``) and the collectives they issue.

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

The GSPMD hints (``shard_hint``, ``sharding_rules``, ``suspend_hints``,
``ep_context``) wait for the training half (ROADMAP Queue 1, 'Parallel
training and the dry-run's meshes').
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
        src = x.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=-1)

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
        dist.all_reduce(out, group=self.group)
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
    outside a TP region; in ``"gather"`` mode ``qdot`` of the all-gathered
    ``x`` with the full replicated ``w``; in ``"psum"`` mode the f32
    partial ``x @ w_rows`` (a packed ``w`` dequantized to f32 first; an
    MXFP4 one takes ``x`` rounded to bf16, as ``qdot``'s MXFP4 product
    does), for ``tp_psum`` to reduce before the caller casts."""
    comm = _TP.get()
    if comm is None:
        return qdot(x, w)
    if _TP_MODE.get() == "gather":
        return qdot(comm.all_gather_last(x), w)
    if isinstance(w, formats.PackedMXFP4):
        # the MXFP4 product takes bf16 activations (``qdot``'s kernel op):
        # the same product, split over K
        x = x.to(torch.bfloat16)
    if is_packed(w):
        w = formats.dequantize_any(w, torch.float32)
    return x.float() @ w.float()
