"""GQA attention and dense MLP blocks (the ``attn_dense`` pieces of
``repro/models/layers.py``).

The static serve path's attention lives here, as in the reference (the
``gqa`` backend's ``forward``/``prefill``/``decode`` entries):
``attn_forward`` (full sequence, no cache), ``attn_prefill`` (full prompt
into a dense ``(B, S, KVH, HD)`` cache) and ``attn_decode`` (one token
against it).  On CPU tensors they call what the reference calls
(``blocked_attention``; ``decode_attention_ref`` under the ``slot_pos``
mask); on CUDA tensors the hand-written kernels' wrappers
(``flash_attention``; the dense ``decode_attention`` over the valid prefix
``cur_pos + 1``).  ``kernel_path`` makes that choice, once, for both.
The cache is written in place.

Parameters live in ``nn.Module``s whose attribute names are the reference
pytree's keys (``wq``, ``bk``, ``q_norm``, ``w_gate`` ...), with the same
shapes and dtypes, so the weight bridge is a rename-free copy.  In a
quantized view (``quant.linear.quantize_params``) the projection
attributes hold packed tensors instead, and every projection goes through
``qdot`` (q/k/v together through ``qdot_group``).  The paged serve paths that use ``_qkv`` live in
``attention_backends.py``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.decode_attention.kernel import decode_attention
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.models.common import (
    NORM_DTYPE, PARAM_DTYPE, ModelConfig, apply_rope, blocked_attention,
    cache_update_at, decode_attention_ref, dense_init, rmsnorm, swiglu,
)
from repro_torch.quant.linear import qdot, qdot_group

ITEM_STATEFUL = "ROADMAP Queue 1, 'Stateful layouts'"


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """GQA projections, optional qkv bias and per-head qk-norm weights."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = _param((d, h * hd), PARAM_DTYPE, device)
        self.wk = _param((d, kvh * hd), PARAM_DTYPE, device)
        self.wv = _param((d, kvh * hd), PARAM_DTYPE, device)
        self.wo = _param((h * hd, d), PARAM_DTYPE, device)
        if cfg.qkv_bias:
            self.bq = _param((h * hd,), PARAM_DTYPE, device)
            self.bk = _param((kvh * hd,), PARAM_DTYPE, device)
            self.bv = _param((kvh * hd,), PARAM_DTYPE, device)
        if cfg.qk_norm:
            self.q_norm = _param((hd,), NORM_DTYPE, device)
            self.k_norm = _param((hd,), NORM_DTYPE, device)


@torch.no_grad()
def init_attn(p: Attention, gen: torch.Generator, cfg: ModelConfig) -> None:
    """Fill ``p`` in place: scaled-normal projections, zero biases, unit
    qk-norm weights (the reference's ``init_attn`` values)."""
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p.wq.copy_(dense_init(gen, d, h * hd))
    p.wk.copy_(dense_init(gen, d, kvh * hd))
    p.wv.copy_(dense_init(gen, d, kvh * hd))
    p.wo.copy_(dense_init(gen, h * hd, d))
    if cfg.qkv_bias:
        for b in (p.bq, p.bk, p.bv):
            b.zero_()
    if cfg.qk_norm:
        p.q_norm.fill_(1.0)
        p.k_norm.fill_(1.0)


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = qdot_group(x, (p.wq, p.wk, p.wv))
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def kernel_path(device: torch.device, window) -> bool:
    """True when the static attention runs the CUDA kernels (tensors on a
    CUDA device).  A windowed layer's ring cache has no kernel yet: on
    CUDA it raises rather than fall back to the plain version."""
    if device.type != "cuda":
        return False
    if window is not None:
        raise NotImplementedError(
            f"sliding-window (ring cache) static attention on CUDA — "
            f"{ITEM_STATEFUL}")
    return True


def _full_attention(q, k, v, cfg: ModelConfig, window):
    if kernel_path(q.device, window):
        return flash_attention(q, k, v, causal=cfg.causal)
    return blocked_attention(q, k, v, causal=cfg.causal, window=window)


def attn_forward(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                 window=None, positions=None) -> torch.Tensor:
    """Full-sequence attention (prompt scoring); x: (B, S, D)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    out = _full_attention(q, k, v, cfg, window)
    return qdot(out.reshape(b, s, cfg.n_heads * cfg.hd), p.wo)


def attn_prefill(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 cache: dict, *, window=None) -> torch.Tensor:
    """Prefill: run attention over the prompt and write its k/v into the
    cache at [0, s) in place (a windowed cache shorter than the prompt
    keeps the tail in ring order)."""
    b, s, _ = x.shape
    dev = x.device
    q, k, v = _qkv(p, x, cfg, torch.arange(s, device=dev)[None, :])
    out = _full_attention(q, k, v, cfg, window)
    out = qdot(out.reshape(b, s, cfg.n_heads * cfg.hd), p.wo)
    w = cache["k"].shape[1]
    if w >= s:
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
        pos = torch.arange(w, device=dev)
        cache["slot_pos"].copy_(torch.where(pos < s, pos, -1))
    else:  # sliding-window cache smaller than the prompt: keep the tail
        # ring layout: slot j holds absolute position t = j (mod w)
        tail = torch.arange(s - w, s, device=dev)
        slot = tail % w
        for key, new in (("k", k), ("v", v)):
            cache[key].zero_()
            cache[key][:, slot] = new[:, s - w:].to(cache[key].dtype)
        cache["slot_pos"].zero_()
        cache["slot_pos"][slot] = tail.to(torch.int32)
    return out


def attn_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                cur_pos: int, *, window=None, positions: torch.Tensor,
                cur_len: torch.Tensor | None) -> torch.Tensor:
    """One-token step; x: (B, D); cur_pos: the position index of the
    token, the same for every row, with ``positions`` (B, 1) holding it
    and ``cur_len`` (B,) int32 = ``cur_pos + 1`` (CUDA only; None on the
    CPU) built once per model step for all its layers.  The new k/v is
    written at slot ``cur_pos % w`` first, then the token attends."""
    b, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    w = cache["k"].shape[1]
    on_card = kernel_path(x.device, window)
    if on_card and cur_pos >= w:        # the kernel reads a prefix
        raise ValueError(f"position {cur_pos} is past the {w}-token cache")
    q, k, v = _qkv(p, x[:, None, :], cfg, positions)
    slot = cur_pos % w
    cache_update_at(cache["k"], k, slot)
    cache_update_at(cache["v"], v, slot)
    # fill_ takes the scalar as a kernel argument; an indexed assignment
    # would copy it from host memory and wait for the device
    cache["slot_pos"][slot:slot + 1].fill_(cur_pos)
    if on_card:
        out = decode_attention(q[:, 0], cache["k"], cache["v"], cur_len)
    else:
        slot_pos = cache["slot_pos"]
        valid = (slot_pos >= 0) & (slot_pos <= cur_pos)
        if window is not None:
            valid = valid & (slot_pos > cur_pos - window)
        out = decode_attention_ref(q[:, 0], cache["k"], cache["v"], None,
                                   valid=valid[None, :].expand(b, -1))
    return qdot(out.reshape(b, h * hd), p.wo)


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    window: int | None = None, dtype=torch.bfloat16, *,
                    device) -> dict:
    """Dense K/V cache of one layer: ``(B, w, KVH, HD)`` leaves, w =
    max_len (or the window, if shorter), and ``slot_pos`` (w,) int32, the
    absolute position each slot holds (-1 = empty)."""
    w = min(max_len, window) if window else max_len
    shape = (batch, w, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((w,), -1, dtype=torch.int32,
                                   device=device)}


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device, d_ff: int | None = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.w_gate = _param((d, f), PARAM_DTYPE, device)
        self.w_up = _param((d, f), PARAM_DTYPE, device)
        self.w_down = _param((f, d), PARAM_DTYPE, device)


@torch.no_grad()
def init_mlp(p: MLP, gen: torch.Generator) -> None:
    d, f = p.w_gate.shape
    p.w_gate.copy_(dense_init(gen, d, f))
    p.w_up.copy_(dense_init(gen, d, f))
    p.w_down.copy_(dense_init(gen, f, d))


def mlp_forward(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p.w_gate, p.w_up, p.w_down)
