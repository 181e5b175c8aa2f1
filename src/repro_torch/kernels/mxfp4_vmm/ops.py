"""Public op wrapper for the MXFP4 VMM (counterpart of
``repro/kernels/mxfp4_vmm/ops.py``).

``mxfp4_matmul`` takes a ``PackedMXFP4`` weight and (..., K) activations,
casts the activations to bf16 (as the reference op does, whatever their
dtype), and dispatches on the device of the tensors: the plain version on
the CPU, the CUDA kernel on the card.  The kernel takes every shape
``quantize_params`` packs (any M, K a multiple of 32, any N), so there is
no fallback on the card and no ``FALLBACK_STATS``: a build or launch
failure raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mxfp4_vmm.kernel import mxfp4_vmm
from repro_torch.kernels.mxfp4_vmm.ref import mxfp4_vmm_ref
from repro_torch.quant.formats import MX_BLOCK, PackedMXFP4


def mxfp4_tileable(k: int, n: int) -> bool:
    """True when a (K, N) mxfp4 weight takes the kernel: every packable
    shape (K a multiple of 32) does — the kernel masks ragged M and N."""
    return k % MX_BLOCK == 0 and n >= 1


def mxfp4_matmul(x: torch.Tensor, w: PackedMXFP4, *,
                 out_dtype=torch.bfloat16, impl: str = "auto") -> torch.Tensor:
    """x: (..., K) @ dequant(w): (K, N) -> (..., N) in ``out_dtype``.

    ``impl``: "fused" runs the CUDA kernel (CUDA tensors only), "reference"
    the plain version, "auto" the plain version for CPU tensors and the
    kernel for CUDA tensors."""
    if impl not in ("auto", "fused", "reference"):
        raise ValueError(f"impl must be auto|fused|reference, got {impl!r}")
    k, n = w.shape[-2:]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).to(torch.bfloat16)
    if impl == "auto":
        impl = "reference" if x.device.type == "cpu" else "fused"
    if impl == "reference":
        out = mxfp4_vmm_ref(x2, w.codes, w.scales)
    else:
        if not x.is_cuda:
            raise ValueError("impl='fused' runs the CUDA kernel and needs "
                             f"CUDA tensors; x is on {x.device}")
        # the kernel rounds its f32 sums to bf16 itself: no cast launch
        direct = out_dtype in (torch.float32, torch.bfloat16)
        out = mxfp4_vmm(x2, w.codes, w.scales,
                        out_dtype if direct else torch.float32)
    return out.reshape(*lead, n).to(out_dtype)
