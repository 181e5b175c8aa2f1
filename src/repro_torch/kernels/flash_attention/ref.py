"""Plain PyTorch version of the flash-attention forward — what the CUDA
kernel in ``csrc/flash_attention.cu`` is held against.  Counterpart of
``repro/kernels/flash_attention/ref.py``."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q, k, v: (BH, S, D) -> (BH, Sq, Dv) in q.dtype; f32 softmax.  The
    causal mask is top-left aligned: query i sees keys 0..i."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
