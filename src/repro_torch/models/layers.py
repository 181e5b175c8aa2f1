"""GQA attention and dense MLP blocks (the ``attn_dense`` pieces of
``repro/models/layers.py``).

Parameters live in ``nn.Module``s whose attribute names are the reference
pytree's keys (``wq``, ``bk``, ``q_norm``, ``w_gate`` ...), with the same
shapes and dtypes, so the weight bridge is a rename-free copy.  In a
quantized view (``quant.linear.quantize_params``) the projection
attributes hold packed tensors instead, and every projection goes through
``qdot``.  The paged serve paths that use ``_qkv`` live in
``attention_backends.py``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import (
    NORM_DTYPE, PARAM_DTYPE, ModelConfig, apply_rope, dense_init, rmsnorm,
    swiglu,
)
from repro_torch.quant.linear import qdot


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
    q = qdot(x, p.wq)
    k = qdot(x, p.wk)
    v = qdot(x, p.wv)
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
