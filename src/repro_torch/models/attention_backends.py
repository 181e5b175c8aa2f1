"""Paged GQA serve paths: page pools, scatters, decode and chunked prefill.

The GQA part of ``repro/models/attention_backends.py``.  One difference in
kind: the reference returns new pool arrays (``.at[].set``); here every
scatter writes the pool **in place** (``index_put_``).  At llama3-8b size a
32-layer pool copied on every step would cost more than the step itself.

The decode attention goes through ``ops.paged_gqa_decode_attention``
(``impl="auto"``): the plain version for CPU tensors, the CUDA kernel for
CUDA tensors.  Chunked prefill gathers the pages and runs
``blocked_attention``, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import (
    paged_gqa_decode_attention, paged_gqa_multi_attention,
)
from repro_torch.models import layers
from repro_torch.models.common import ModelConfig

QUANT_POOLS = ("fp8", "int8")


def scatter_token(pool_leaf: torch.Tensor, vals: torch.Tensor, page_table,
                  pos) -> None:
    """Scatter one token per slot, in place: vals (B, ...) at per-slot
    position pos."""
    b = vals.shape[0]
    page = pool_leaf.shape[1]
    pos = pos.long()
    blk, off = pos // page, pos % page
    phys = page_table[torch.arange(b, device=pos.device), blk].long()
    pool_leaf.index_put_((phys, off), vals.to(pool_leaf.dtype))


def scatter_chunk(pool_leaf: torch.Tensor, vals: torch.Tensor, page_table,
                  positions, ok) -> None:
    """Scatter a chunk of tokens per slot through the page table, in place.

    vals: (B, C, ...); positions: (B, C) absolute; ok: (B, C) — entries with
    ``ok=False`` (padding rows / the tail of a short last chunk) are
    redirected to the scratch page so live pages are never corrupted."""
    b, c = positions.shape
    page = pool_leaf.shape[1]
    okf = ok.reshape(-1)
    pos_f = torch.where(okf, positions.reshape(-1).long(), 0)
    bidx = torch.arange(b, device=positions.device).repeat_interleave(c)
    phys = torch.where(okf, page_table[bidx, pos_f // page].long(), 0)
    off = torch.where(okf, pos_f % page, 0)
    flat = vals.reshape((b * c,) + tuple(vals.shape[2:])).to(pool_leaf.dtype)
    pool_leaf.index_put_((phys, off), flat)


def init_attn_page_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                        dtype=torch.bfloat16, *, device) -> dict:
    """Physical K/V page pool for one layer: ``(P, page, KVH, HD)``.

    bf16 on the card; f32 for CPU parity runs.  The reference's quantized
    ``"fp8"``/``"int8"`` pools (codes plus per-token scale leaves) are not
    ported yet."""
    if isinstance(dtype, str) and dtype in QUANT_POOLS:
        raise NotImplementedError(
            f"cache_dtype={dtype!r}: quantized KV pools arrive with the "
            "port's quantization slice (ROADMAP Queue 1, 'Quantization')")
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode_paged(p: layers.Attention, x: torch.Tensor, cfg: ModelConfig,
                      pool: dict, page_table, pos, *, window=None) -> torch.Tensor:
    """One-token step against a paged cache.

    x: (B, D) slot tokens; pos: (B,) int per-slot positions (ragged);
    page_table: (B, n_blocks) int32.  The new k/v is scattered into the
    slot's current page before the attention (write-then-attend), then the
    attention streams the live pages through the decode kernel."""
    b, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    q, k, v = layers._qkv(p, x[:, None, :], cfg, pos[:, None])
    scatter_token(pool["k"], k[:, 0], page_table, pos)
    scatter_token(pool["v"], v[:, 0], page_table, pos)
    out = paged_gqa_decode_attention(q[:, 0], pool["k"], pool["v"],
                                     page_table, pos, window=window)
    return out.reshape(b, h * hd) @ p.wo


def attn_prefill_chunk_paged(p: layers.Attention, x: torch.Tensor,
                             cfg: ModelConfig, pool: dict, page_table, start,
                             valid, *, window=None) -> torch.Tensor:
    """One prefill chunk against the paged cache.

    x: (B, C, D) chunk hidden states; start: (B,) absolute position of
    x[:, 0]; valid: (B,) number of real tokens in the chunk (the rest are
    padding).  The chunk's k/v is scattered into the slot's pages, then the
    chunk queries attend over the gathered view — earlier chunks and shared
    prefix pages are already resident."""
    b, c, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    ar = torch.arange(c, device=x.device)
    positions = start[:, None].long() + ar[None, :]
    q, k, v = layers._qkv(p, x, cfg, positions)
    ok = ar[None, :] < valid[:, None]
    scatter_chunk(pool["k"], k, page_table, positions, ok)
    scatter_chunk(pool["v"], v, page_table, positions, ok)
    out = paged_gqa_multi_attention(q, pool["k"], pool["v"], page_table,
                                    start, causal=cfg.causal, window=window)
    return out.reshape(b, c, h * hd) @ p.wo
