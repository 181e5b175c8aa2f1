"""Paged GQA serve paths: page pools, scatters, decode and chunked prefill.

The GQA part of ``repro/models/attention_backends.py``.  One difference in
kind: the reference returns new pool arrays (``.at[].set``); here every
scatter writes the pool **in place** (``index_put_``), with the page
indices computed once per layer for all of the pool's leaves.  At llama3-8b size a
32-layer pool copied on every step would cost more than the step itself.

The decode attention goes through ``ops.paged_gqa_decode_attention``
(``impl="auto"``): the plain version for CPU tensors, the CUDA kernel for
CUDA tensors.  Chunked prefill gathers the pages and runs
``blocked_attention`` (``impl="blocked"``), as the reference does.  The
multi-token decode of the speculative verify step
(``attn_decode_multi_paged``) goes through
``ops.paged_gqa_multi_attention`` with ``impl="auto"``: the plain
multi-query oracle for CPU tensors, the exact-accumulator CUDA kernel for
CUDA tensors.  fp8/int8 pools quantize on
write (codes plus per-token scales, ``quant/kv.py``) and hand their scale
leaves to the attention; the o projection goes through ``qdot``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import (
    paged_gqa_decode_attention, paged_gqa_multi_attention,
)
from repro_torch.models import layers
from repro_torch.models.common import ModelConfig
from repro_torch.quant import kv as kvq
from repro_torch.quant.linear import qdot


def token_slots(page_table, pos, page: int):
    """(physical page, offset) of each slot's position ``pos`` (B,)."""
    pos = pos.long()
    rows = torch.arange(pos.shape[0], device=pos.device)
    return page_table[rows, pos // page].long(), pos % page


def chunk_slots(page_table, positions, ok, page: int):
    """(physical page, offset) of each chunk token, flattened to (B*C,).

    positions: (B, C) absolute; ok: (B, C) — entries with ``ok=False``
    (padding rows / the tail of a short last chunk) are redirected to the
    scratch page so live pages are never corrupted."""
    b, c = positions.shape
    okf = ok.reshape(-1)
    pos_f = torch.where(okf, positions.reshape(-1).long(), 0)
    bidx = torch.arange(b, device=positions.device).repeat_interleave(c)
    phys = torch.where(okf, page_table[bidx, pos_f // page].long(), 0)
    return phys, torch.where(okf, pos_f % page, 0)


def _put(pool_leaf: torch.Tensor, slots, vals: torch.Tensor) -> None:
    """pool_leaf[slots] = vals, in place (fp8 codes as their bytes)."""
    kvq.raw_view(pool_leaf).index_put_(
        slots, kvq.raw_view(vals.to(pool_leaf.dtype)))


def init_attn_page_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                        dtype=torch.bfloat16, *, device) -> dict:
    """Physical K/V page pool for one layer: ``(P, page, KVH, HD)``.

    bf16 on the card; f32 for CPU parity runs.  The string dtypes
    ``"fp8"`` / ``"int8"`` build quantized pools: narrow code leaves plus
    per-token f32 ``k_scale``/``v_scale`` leaves of shape ``(P, page,
    KVH)``."""
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.hd)
    if kvq.is_quantized_cache_dtype(dtype):
        store = kvq.cache_storage_dtype(dtype)
        ones = dict(dtype=kvq.SCALE_DTYPE, device=device)
        return {"k": torch.zeros(shape, dtype=store, device=device),
                "v": torch.zeros(shape, dtype=store, device=device),
                "k_scale": torch.ones(shape[:3], **ones),
                "v_scale": torch.ones(shape[:3], **ones)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _scatter_kv(pool: dict, k, v, slots) -> None:
    """Write k/v (N, KVH, HD) at ``slots`` into every leaf of the pool,
    quantizing on write for fp8/int8 pools (scale = amax of the token's
    head vector, fixed at write time)."""
    fmt = kvq.pool_cache_format(pool)
    if fmt is not None:
        k, k_scale = kvq.kv_quantize(k, fmt)
        v, v_scale = kvq.kv_quantize(v, fmt)
        _put(pool["k_scale"], slots, k_scale)
        _put(pool["v_scale"], slots, v_scale)
    _put(pool["k"], slots, k)
    _put(pool["v"], slots, v)


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
    page = pool["k"].shape[1]
    _scatter_kv(pool, k[:, 0], v[:, 0], token_slots(page_table, pos, page))
    out = paged_gqa_decode_attention(
        q[:, 0], pool["k"], pool["v"], page_table, pos,
        k_scales=pool.get("k_scale"), v_scales=pool.get("v_scale"),
        window=window)
    return qdot(out.reshape(b, h * hd), p.wo)


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
    slots = chunk_slots(page_table, positions, ok, pool["k"].shape[1])
    _scatter_kv(pool, k.flatten(0, 1), v.flatten(0, 1), slots)
    out = paged_gqa_multi_attention(
        q, pool["k"], pool["v"], page_table, start,
        k_scales=pool.get("k_scale"), v_scales=pool.get("v_scale"),
        causal=cfg.causal, window=window, impl="blocked")
    return qdot(out.reshape(b, c, h * hd), p.wo)


def attn_decode_multi_paged(p: layers.Attention, x: torch.Tensor,
                            cfg: ModelConfig, pool: dict, page_table, start,
                            valid, *, window=None) -> torch.Tensor:
    """C-token decode step (speculative verify): x (B, C, D) holds tokens
    already chosen, at per-slot offsets ``start`` with ``valid`` (B,) real
    rows (the rest scatter to the scratch page).  Chunk-shaped
    scatter-then-attend, through the multi-query decode dispatch
    (``impl="auto"``): the plain oracle on CPU, the exact kernel on CUDA,
    which reads each slot's pages once for all C queries."""
    b, c, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    ar = torch.arange(c, device=x.device)
    positions = start[:, None].long() + ar[None, :]
    q, k, v = layers._qkv(p, x, cfg, positions)
    ok = ar[None, :] < valid[:, None]
    slots = chunk_slots(page_table, positions, ok, pool["k"].shape[1])
    _scatter_kv(pool, k.flatten(0, 1), v.flatten(0, 1), slots)
    out = paged_gqa_multi_attention(
        q, pool["k"], pool["v"], page_table, start,
        k_scales=pool.get("k_scale"), v_scales=pool.get("v_scale"),
        window=window)
    return qdot(out.reshape(b, c, h * hd), p.wo)
