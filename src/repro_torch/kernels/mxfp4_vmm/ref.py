"""Plain PyTorch version of the MXFP4 stream-decoded VMM — what the CUDA
kernel in ``csrc/mxfp4_vmm.cu`` is held against.  Counterpart of
``repro/kernels/mxfp4_vmm/ref.py``."""
from __future__ import annotations

import torch

from repro_torch.quant.formats import PackedMXFP4, dequantize_mxfp4


def mxfp4_vmm_ref(x: torch.Tensor, codes: torch.Tensor,
                  scales: torch.Tensor) -> torch.Tensor:
    """x (M, K) bf16 @ dequant(codes, scales) (K, N) -> (M, N) f32.

    Dequantizes the whole matrix to bf16 (exact: every MXFP4 value is a
    bf16 value), then one f32-accumulating product: the bf16 operands are
    exact in f32, so an f32 matmul of the two is the reference's
    ``jnp.dot(..., preferred_element_type=float32)``."""
    k, n = x.shape[1], codes.shape[1]
    w = dequantize_mxfp4(PackedMXFP4(codes, scales, (k, n)), torch.bfloat16)
    return x.to(torch.float32) @ w.to(torch.float32)
