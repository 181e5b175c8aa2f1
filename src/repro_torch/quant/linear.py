"""Quantized serve execution: model quantization + matmul dispatch.

The PyTorch counterpart of ``repro/quant/linear.py``.  ``quantize_params``
returns a *view* of a ``Model`` in which every eligible projection weight
(attention and MLP of dense blocks) is replaced by its packed
block-quantized form from ``quant/formats.py``; the model code routes
those matmuls through ``qdot`` — the CUDA MXFP4 VMM kernel for ``mxfp4``
(its plain version on the CPU), dequantize-then-matmul for every other
format — and projections that read the same activations through
``qdot_group`` (one kernel launch for q/k/v or gate/up when all are
``mxfp4``).  The view shares every unquantized tensor with the caller's model
and leaves the caller's model as it was (the reference's engine never
alters the params it is given either).

``serve_weight_bytes`` is the budget side: the exact packed bytes
``quantize_params`` allocates for quantizable leaves plus native bytes for
everything else.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from repro_torch.kernels.mxfp4_vmm.ops import mxfp4_matmul, mxfp4_matmul_group
from repro_torch.quant import formats

# projection leaves the serve path streams through the software stream
# decoder; everything else (norms, biases, embeddings, router/expert and
# SSM weights) keeps its native dtype
QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"})
# replicated / non-dense subtrees never quantize (MoE experts contract
# via einsum; SSM state kernels are not K-major streams)
SKIP_SUBTREES = frozenset({"moe", "ssm"})


def quantizable_leaf(name: str, leaf, fmt: str) -> bool:
    """True when ``quantize_params`` packs the parameter ``name`` (its
    dotted module path, ``layers.0.attn.wq``) under ``fmt``."""
    names = name.split(".")
    if names[-1] not in QUANT_KEYS:
        return False
    if any(n in SKIP_SUBTREES for n in names):
        return False
    if getattr(leaf, "ndim", 0) < 2:
        return False
    return leaf.shape[-2] % formats.format_spec(fmt).block == 0


def _module_view(mod: nn.Module) -> nn.Module:
    """A copy of ``mod``'s module tree whose parameter and submodule tables
    are its own, but whose tensors are ``mod``'s."""
    view = copy.copy(mod)
    view._parameters = dict(mod._parameters)
    view._buffers = dict(mod._buffers)
    view._modules = {k: (None if m is None else _module_view(m))
                     for k, m in mod._modules.items()}
    return view


def quantize_params(model: nn.Module, fmt: str) -> nn.Module:
    """A view of ``model`` with every eligible projection weight packed to
    ``fmt`` (one leaf at a time, so no f32 copy of the whole model ever
    exists); all other parameters are ``model``'s own tensors."""
    fmt = formats.canonical_format(fmt)
    view = _module_view(model)
    for prefix, mod in view.named_modules():
        for pname, p in list(mod._parameters.items()):
            name = f"{prefix}.{pname}" if prefix else pname
            if p is not None and quantizable_leaf(name, p, fmt):
                del mod._parameters[pname]
                setattr(mod, pname, formats.quantize(p.detach(), fmt))
    return view


def packed_leaves(model: nn.Module):
    """(dotted name, packed tensor) for every packed weight of ``model``."""
    for prefix, mod in model.named_modules():
        for k, v in vars(mod).items():
            if is_packed(v):
                yield (f"{prefix}.{k}" if prefix else k), v


def serve_leaf_bytes(model: nn.Module, fmt: str | None):
    """(dotted name, ndim, bytes) of every weight of ``model`` served under
    ``fmt`` (None = native): exact packed bytes for quantizable leaves,
    native bytes for the rest, a quantized view's packed leaves at their
    bytes."""
    for name, p in model.named_parameters():
        if fmt is not None and quantizable_leaf(name, p, fmt):
            yield name, p.ndim, formats.packed_nbytes(tuple(p.shape), fmt)
        else:
            yield name, p.ndim, p.numel() * p.element_size()
    for name, w in packed_leaves(model):
        yield name, len(w.shape), w.nbytes


def serve_weight_bytes(model: nn.Module, fmt: str | None) -> int:
    """Total bytes ``model``'s weights occupy when served under ``fmt``:
    the number ``quantize_params`` allocates (``serve_leaf_bytes``)."""
    return sum(b for _, _, b in serve_leaf_bytes(model, fmt))


def is_packed(w) -> bool:
    return isinstance(w, formats.PACKED_TYPES)


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where ``w`` may be a packed quantized tensor.

    MXFP4 goes through the ``kernels/mxfp4_vmm`` op (the CUDA kernel on
    the card, its plain version on the CPU) and comes back in ``x``'s
    dtype; other packed formats dequantize to ``x``'s dtype and multiply;
    plain tensors are a native matmul."""
    if isinstance(w, formats.PackedMXFP4):
        return mxfp4_matmul(x, w, out_dtype=x.dtype)
    if isinstance(w, formats.PACKED_TYPES):
        return x @ formats.dequantize_any(w, x.dtype)
    return x @ w


def qdot_group(x: torch.Tensor, ws) -> list[torch.Tensor]:
    """``[qdot(x, w) for w in ws]``; when every weight is MXFP4 (and they
    share K) one ``mxfp4_matmul_group`` call: a single kernel launch on
    the card for the projections that read ``x``."""
    if (all(isinstance(w, formats.PackedMXFP4) for w in ws)
            and len({w.shape[-2] for w in ws}) == 1):
        return mxfp4_matmul_group(x, ws, out_dtype=x.dtype)
    return [qdot(x, w) for w in ws]
