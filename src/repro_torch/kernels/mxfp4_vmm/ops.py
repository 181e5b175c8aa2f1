"""Public op wrapper for the MXFP4 VMM (counterpart of
``repro/kernels/mxfp4_vmm/ops.py``).

``mxfp4_matmul`` takes a ``PackedMXFP4`` weight and (..., K) activations,
casts the activations to bf16 (as the reference op does, whatever their
dtype), and dispatches on the device of the tensors: the plain version on
the CPU, the CUDA kernel on the card.  ``mxfp4_matmul_group`` does the same
for up to three weights that read the same activations (q/k/v, gate/up):
one kernel launch on the card, the plain version per weight on the CPU.  The kernel takes every shape
``quantize_params`` packs (any M, K a multiple of 32, any N), so there is
no fallback on the card and no ``FALLBACK_STATS``: a build or launch
failure raises.
"""
from __future__ import annotations

import torch

from typing import Sequence

from repro_torch.kernels.mxfp4_vmm.kernel import MAX_GROUP, mxfp4_vmm_group
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
    return mxfp4_matmul_group(x, [w], out_dtype=out_dtype, impl=impl)[0]


def mxfp4_matmul_group(x: torch.Tensor, ws: Sequence[PackedMXFP4], *,
                       out_dtype=torch.bfloat16,
                       impl: str = "auto") -> list[torch.Tensor]:
    """x: (..., K) @ dequant(w) for each of 1..3 weights ``ws`` that share
    K -> one (..., N_i) tensor each in ``out_dtype``: ``mxfp4_matmul`` of
    each weight, in one kernel launch on the card."""
    if impl not in ("auto", "fused", "reference"):
        raise ValueError(f"impl must be auto|fused|reference, got {impl!r}")
    if not 1 <= len(ws) <= MAX_GROUP:
        raise ValueError(f"{len(ws)} weights in one group (1..{MAX_GROUP})")
    k = ws[0].shape[-2]
    if any(w.shape[-2] != k for w in ws):
        raise ValueError(f"weights of K {[w.shape[-2] for w in ws]} in one "
                         "group (they must share K)")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).to(torch.bfloat16)
    if impl == "auto":
        impl = "reference" if x.device.type == "cpu" else "fused"
    if impl == "reference":
        outs = [mxfp4_vmm_ref(x2, w.codes, w.scales) for w in ws]
    else:
        if not x.is_cuda:
            raise ValueError("impl='fused' runs the CUDA kernel and needs "
                             f"CUDA tensors; x is on {x.device}")
        # the kernel rounds its f32 sums to bf16 itself: no cast launch
        direct = out_dtype in (torch.float32, torch.bfloat16)
        outs = mxfp4_vmm_group(x2, [(w.codes, w.scales) for w in ws],
                               out_dtype if direct else torch.float32)
    return [o.reshape(*lead, w.shape[-1]).to(out_dtype)
            for o, w in zip(outs, ws)]
