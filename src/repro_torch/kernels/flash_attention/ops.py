"""Public op: GQA-aware fused attention (counterpart of
``repro/kernels/flash_attention/ops.py``), with the reference op's
signature and an ``impl`` knob.  The model's static prefill and
full-sequence scoring do not go through it: ``models.layers`` picks the
kernel or the plain path itself and calls the kernel's wrapper directly.

``gqa_flash_attention`` takes the model's (B, S, H, D) layout.  On CUDA
tensors it runs the hand-written kernel, which reads the GQA layout in
place and masks ragged sequence lengths itself, so unlike the reference's
op there is no oracle fallback for shapes the tiles do not cover: a build
or launch failure raises.  On CPU tensors it runs the plain version on the
reference op's flattened (B*H, S, D) layout.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def gqa_flash_attention(q, k, v, *, causal: bool = True, window=None,
                        impl: str = "auto") -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Skv, KVH, D); v: (B, Skv, KVH, Dv) ->
    (B, Sq, H, Dv) (Dv = D, or 128 at D 192: MLA).

    ``impl``: "fused" runs the CUDA kernel (CUDA tensors only),
    "reference" the plain version (GQA heads expanded, flattened to
    (B*H, S, D) as the reference op does), "auto" the plain version for
    CPU tensors and the kernel for CUDA tensors.  ``window``: keys
    j > i - window only (``blocked_attention(window=)``)."""
    if impl not in ("auto", "fused", "reference"):
        raise ValueError(f"impl must be auto|fused|reference, got {impl!r}")
    if impl == "auto":
        impl = "reference" if q.device.type == "cpu" else "fused"
    if impl == "fused":
        if not q.is_cuda:
            raise ValueError("impl='fused' runs the CUDA kernel and needs "
                             f"CUDA tensors; q is on {q.device}")
        return flash_attention(q, k, v, causal=causal, window=window)
    b, sq, h, d = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    rep = h // kvh
    kf = torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k
    vf = torch.repeat_interleave(v, rep, dim=2) if rep > 1 else v
    qt = q.transpose(1, 2).reshape(b * h, sq, d)
    kt = kf.transpose(1, 2).reshape(b * h, skv, d)
    vt = vf.transpose(1, 2).reshape(b * h, skv, dv)
    out = flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    return out.reshape(b, h, sq, dv).transpose(1, 2)
