"""Plain PyTorch versions of paged decode attention — what the CUDA kernels
in ``csrc/paged_decode.cu`` (single token, online softmax) and
``csrc/paged_exact.cu`` (C queries per slot, one softmax per row) are held
against.  Counterpart of ``repro/kernels/decode_attention/ref.py``."""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import NEG_INF, decode_attention_ref
from repro_torch.quant.kv import raw_view


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(P, page, ...) pool + (B, n_blocks) table -> (B, n_blocks*page, ...)
    position-ordered dense view (block i of row b = physical page
    ``page_table[b, i]``)."""
    g = raw_view(pages)[page_table.long()]     # (B, n_blocks, page, ...)
    b, nb, ps = g.shape[:3]
    return g.reshape((b, nb * ps) + tuple(g.shape[3:])).view(pages.dtype)


def paged_valid_mask(page_table: torch.Tensor, page_size: int,
                     pos: torch.Tensor, *, window=None) -> torch.Tensor:
    """(B, n_blocks*page) bool mask of logical positions visible to the
    token being decoded at per-row position ``pos`` (inclusive: the new
    token's own k/v has already been scattered at ``pos``)."""
    s = page_table.shape[1] * page_size
    idx = torch.arange(s, device=pos.device)[None, :]
    valid = idx <= pos[:, None]
    if window is not None:
        valid = valid & (idx > pos[:, None] - window)
    return valid


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, pos, *,
                               k_scales=None, v_scales=None,
                               window=None, scale=None):
    """Paged single-token decode attention, gather-then-dense.

    q:          (B, H, D) — one new token per slot
    k_pages:    (P, page, KVH, D) physical page pool
    v_pages:    (P, page, KVH, Dv)
    page_table: (B, n_blocks) int — logical block -> physical page
    pos:        (B,) int — per-slot position of the new token
    k_scales/v_scales: (P, page, KVH) f32 per-token dequant scales for
                fp8/int8 code pools (None = dense pools)

    The dequant (f32 cast, then one multiply per element) is the one the
    CUDA kernel applies to each page it loads.
    """
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    if k_scales is not None:
        k = k.float() * gather_pages(k_scales, page_table)[..., None]
        v = v.float() * gather_pages(v_scales, page_table)[..., None]
    valid = paged_valid_mask(page_table, k_pages.shape[1], pos, window=window)
    return decode_attention_ref(q, k, v, None, valid=valid, scale=scale)


def paged_decode_multi_attention_ref(q, k_pages, v_pages, page_table, start,
                                     *, k_scales=None, v_scales=None,
                                     window=None, scale=None):
    """Multi-token paged decode attention: C queries per slot at per-row
    offsets (the speculative verify step, C = gamma + 1).

    q: (B, C, H, D); start: (B,) absolute position of q[:, 0]; query j of
    row b sits at position start[b] + j and sees keys <= its own position
    (and > position - window when a window is set).

    Op for op the reference's oracle, and per query the single-token
    ``paged_decode_attention_ref``: gather, dequantize (f32 cast, then one
    multiply by the per-token scale), f32 scores, mask with NEG_INF, one
    softmax over the row, P·V."""
    b, c, h, d = q.shape
    kvh = k_pages.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rep = h // kvh
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    if k_scales is not None:
        k = k.float() * gather_pages(k_scales, page_table)[..., None]
        v = v.float() * gather_pages(v_scales, page_table)[..., None]
    s_len = k.shape[1]
    pos = start.long()[:, None] + torch.arange(c, device=q.device)[None, :]
    idx = torch.arange(s_len, device=q.device)
    valid = idx[None, None, :] <= pos[:, :, None]            # (B, C, S)
    if window is not None:
        valid = valid & (idx[None, None, :] > pos[:, :, None] - window)
    qf = q.float().reshape(b, c, kvh, rep, d)
    s = torch.einsum("bcgrd,bsgd->bcgrs", qf, k.float()) * scale
    s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bcgrs,bsgd->bcgrd", p, v.float())
    return out.reshape(b, c, h, v.shape[-1]).to(q.dtype)
