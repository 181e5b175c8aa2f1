"""Plain PyTorch version of the flash-attention forward — what the CUDA
kernel in ``csrc/flash_attention.cu`` is held against.  Counterpart of
``repro/kernels/flash_attention/ref.py``."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """q, k: (BH, S, D), v: (BH, Skv, Dv) -> (BH, Sq, Dv) in q.dtype, with
    the scale 1/sqrt(D); f32 softmax.  The
    causal mask is top-left aligned: query i sees keys 0..i; a ``window``
    keeps only keys j > i - window (``blocked_attention(window=)``)."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    sq, sk = q.shape[1], k.shape[1]
    qi = torch.arange(sq, device=q.device)[:, None]
    kj = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & (kj > qi - window)
    if causal or window is not None:
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
