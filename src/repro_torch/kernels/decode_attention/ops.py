"""Public op wrappers for decode attention, dense and paged (counterpart of
``repro/kernels/decode_attention/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.kernel import decode_attention
from repro_torch.kernels.decode_attention.paged_kernel import (
    paged_decode_attention, paged_decode_multi_attention,
)
from repro_torch.kernels.decode_attention.ref import (
    gather_pages, paged_decode_attention_ref, paged_decode_multi_attention_ref,
)
from repro_torch.models.common import blocked_attention, decode_attention_ref
from repro_torch.quant.kv import kv_dequantize


def gqa_decode_attention(q, k_cache, v_cache, cur_len, *,
                         impl: str = "auto") -> torch.Tensor:
    """(B, H, D) x (B, S, KVH, D) dense cache -> (B, H, D): row b attends
    its valid prefix, positions 0 .. cur_len[b] - 1 (each cur_len >= 1).

    ``impl``: "fused" runs the CUDA kernel (``kernel.py``; CUDA tensors
    only), "reference" the plain ``decode_attention_ref``, "auto" the plain
    version for CPU tensors and the kernel for CUDA tensors.  The kernel
    takes every S (the reference op's oracle fallback for a ragged S has
    no counterpart): a build or launch failure raises.  The static decode
    step does not go through this op: ``models.layers`` picks the kernel
    or the plain path itself and calls the kernel's wrapper directly."""
    if impl not in ("auto", "fused", "reference"):
        raise ValueError(f"impl must be auto|fused|reference, got {impl!r}")
    if impl == "auto":
        impl = "reference" if q.device.type == "cpu" else "fused"
    if impl == "reference":
        return decode_attention_ref(q, k_cache, v_cache, cur_len)
    if not (q.is_cuda or q.is_meta):
        raise ValueError("impl='fused' runs the CUDA kernel and needs CUDA "
                         f"tensors; q is on {q.device}")
    return decode_attention(q, k_cache, v_cache, cur_len.to(torch.int32))


def paged_gqa_multi_attention(q, k_pages, v_pages, page_table, start, *,
                              k_scales=None, v_scales=None, causal=True,
                              window=None, impl: str = "auto"):
    """Multi-token paged attention: q (B, C, H, D) at per-row absolute
    offsets ``start`` (B,); query j of row b sits at ``start[b] + j`` and
    attends causally up to itself.  Used by chunked prefill and by the
    speculative verify step (C = gamma + 1).  Impls:

      * ``"blocked"``   — gather the pages (dequantized to q's dtype for
        fp8/int8 pools) and run ``blocked_attention``'s ragged ``q_offset``
        online softmax; what chunked prefill uses (its call site asks for
        it by name, as the reference's does).
      * ``"reference"`` — ``paged_decode_multi_attention_ref``: op for op
        the single-token decode oracle per query, so on CPU each verify
        position's logits are the ones the single-token decode step gives.
      * ``"fused"``     — the exact-accumulator CUDA kernel
        (``paged_decode_multi_attention``, ``csrc/paged_exact.cu``): each
        slot's live pages stream once for all C queries, every sum's order
        is fixed by the query's position.  CUDA tensors only; on a CPU
        tensor it raises.
      * ``"auto"``      — the plain ``"reference"`` for CPU tensors, the
        kernel for CUDA tensors (no fallback: a build or launch failure
        raises)."""
    if impl == "auto":
        impl = "reference" if q.device.type == "cpu" else "fused"
    if impl in ("reference", "fused") and not causal:
        raise ValueError(f"impl={impl!r} is the causal multi-token decode; "
                         f"causal=False takes impl='blocked'")
    if impl == "reference":
        return paged_decode_multi_attention_ref(
            q, k_pages, v_pages, page_table, start, k_scales=k_scales,
            v_scales=v_scales, window=window)
    if impl == "fused":
        if not (q.is_cuda or q.is_meta):
            raise ValueError("impl='fused' runs the CUDA kernel and needs "
                             f"CUDA tensors; q is on {q.device}")
        return paged_decode_multi_attention(
            q, k_pages, v_pages, page_table.to(torch.int32),
            start.to(torch.int32), k_scales=k_scales, v_scales=v_scales,
            window=window)
    if impl != "blocked":
        raise ValueError(f"impl={impl!r} (want 'auto', 'blocked', 'fused' "
                         f"or 'reference')")
    k_d = gather_pages(k_pages, page_table)
    v_d = gather_pages(v_pages, page_table)
    if k_scales is not None:
        k_d = kv_dequantize(k_d, gather_pages(k_scales, page_table), q.dtype)
        v_d = kv_dequantize(v_d, gather_pages(v_scales, page_table), q.dtype)
    return blocked_attention(q, k_d, v_d, causal=causal, window=window,
                             q_offset=start)


def paged_gqa_decode_attention(q, k_pages, v_pages, page_table, pos, *,
                               k_scales=None, v_scales=None,
                               window=None, impl: str = "auto"):
    """Paged single-token decode attention behind one of two impls:

      * ``"fused"``     — the hand-written CUDA kernel (``paged_kernel``):
        the page table drives the walk, each live K/V page streams from
        device memory straight into the on-chip flash-decode state;
      * ``"reference"`` — the gather-then-dense plain PyTorch version.

    ``"auto"`` takes the plain version for tensors on the CPU and the
    kernel for CUDA tensors — only the kernel: a build or launch failure
    raises.  ``"fused"`` on a CPU tensor raises (CUDA has no interpret
    mode).  fp8/int8 code pools come with their ``(P, page, KVH)`` f32
    ``k_scales``/``v_scales``."""
    if impl == "auto":
        impl = "reference" if q.device.type == "cpu" else "fused"
    if impl == "reference":
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                          pos, k_scales=k_scales,
                                          v_scales=v_scales, window=window)
    if impl != "fused":
        raise ValueError(f"impl={impl!r} (want 'auto', 'fused' or 'reference')")
    if not (q.is_cuda or q.is_meta):
        raise ValueError("impl='fused' runs the CUDA kernel and needs CUDA "
                         f"tensors; q is on {q.device}")
    return paged_decode_attention(q, k_pages, v_pages,
                                  page_table.to(torch.int32),
                                  pos.to(torch.int32), k_scales=k_scales,
                                  v_scales=v_scales, window=window)
