"""Gradient compression for cross-pod data parallelism: the port of
``repro/parallel/compression.py`` over ``torch.distributed``.

The intra-pod gradient reduction stays in full precision and only the
cross-pod mean is compressed: int8 per-tensor quantization with error
feedback (the residual is carried to the next step, so the scheme is
unbiased over time).  The wire carries each pod's int8 codes and one f32
scale a tensor, all-gathered over the pod group; each rank then takes the
scales' dot with the codes over P, summed in pod order as XLA's CPU dot
sums it (``code_mean``), over P.

The scale is ``amax / 127`` with 127 a tensor: PyTorch's CUDA division by
a Python scalar multiplies by its rounded reciprocal, which is not always
the quotient.  A leaf whose rank holds only a block of it
(``amax_comm``: the in-pod group over which the leaf is split) takes the
whole leaf's ``amax``, a max all-reduced over that group, so its scale is
the reference's.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.parallel.hints import TPComm


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    """(127, 1) as f32 scalar tensors on ``device``, made once."""
    return (torch.tensor(127.0, dtype=torch.float32, device=device),
            torch.tensor(1.0, dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=None)
def _divisor(p: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(float(p), dtype=torch.float32, device=device)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    q127, one = _constants(amax.device)
    return torch.where(amax > 0, amax / q127, one)


def _codes(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def int8_quantize(g: torch.Tensor):
    """Symmetric per-tensor int8 quantization: (codes int8, scale f32
    0-d)."""
    scale = _scale(torch.amax(torch.abs(g)).float())
    return _codes(g, scale), scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def code_mean(scales: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The mean over P of ``scales[p] * codes[p]``: (P,) f32 scales, (P,
    ...) int8 codes; summed in pod order as the reference's dot is (the
    first product rounded, each later one fused into the sum, one
    rounding an add: ``addcmul``), then divided by P (a tensor)."""
    p = codes.shape[0]
    acc = scales[0] * codes[0].to(torch.float32)
    for i in range(1, p):
        acc = torch.addcmul(acc, scales[i], codes[i].to(torch.float32))
    return acc / _divisor(p, acc.device)


# elements a step of the compressed mean handles at once: its f32
# temporaries stay this size whatever the leaf (an embedding of 0.8 B
# entries would need three 3 GB ones at once)
CHUNK_ELEMS = 1 << 26


def compressed_mean(g: torch.Tensor, err: torch.Tensor, pods: TPComm, *,
                    amax_comm: TPComm | None = None, inplace: bool = False):
    """Error-feedback compressed mean over the pod group ``pods``.
    Returns (mean_g in g's dtype, new_err f32).  ``g`` and ``err`` are
    this rank's values (the pod's in-pod-reduced gradient, or this rank's
    block of it with ``amax_comm``).  ``inplace``: the new residual is
    written into ``err`` (and returned).  The elementwise work and the
    codes' all-gather go ``CHUNK_ELEMS`` elements at a time: the same
    numbers, bounded temporaries."""
    if inplace:
        target = err.add_(g)          # f32 + the exact f32 of g
    else:
        target = g.to(torch.float32) + err
    amax = torch.amax(torch.abs(target)).float()
    if amax_comm is not None and amax_comm.size > 1:
        amax = amax_comm.all_reduce_op(amax, "max", kind="amax")
    scale = _scale(amax)
    ss = pods.all_gather_stack(scale)
    flat = target.view(-1)
    mean = torch.empty(flat.shape, dtype=g.dtype, device=g.device)
    for i in range(0, flat.numel(), CHUNK_ELEMS):
        t = flat[i:i + CHUNK_ELEMS]
        q = _codes(t, scale)
        t.sub_(int8_dequantize(q, scale))         # the residual, in place
        # all-gather the int8 codes: 1 byte an element on the wire, then
        # the dequantized sum on every rank
        mean[i:i + CHUNK_ELEMS] = code_mean(ss, pods.all_gather_stack(q))
    return mean.view(g.shape), target


def tree_compressed_mean(grads: dict, err_tree: dict, pods: TPComm):
    """``compressed_mean`` leaf by leaf over ``{name: tensor}`` dicts."""
    out_g, out_e = {}, {}
    for name, g in grads.items():
        out_g[name], out_e[name] = compressed_mean(g, err_tree[name], pods)
    return out_g, out_e


def init_error_state(grads: dict) -> dict:
    """Zero f32 residuals beside each gradient (tensor or shape)."""
    return {n: torch.zeros(tuple(getattr(g, "shape", g)),
                           dtype=torch.float32,
                           device=getattr(g, "device", "cpu"))
            for n, g in grads.items()}
