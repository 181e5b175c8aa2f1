"""Flash-attention forward: the CUDA kernel's wrapper.

The Hopper counterpart of the Pallas kernel
``repro/kernels/flash_attention/kernel.py::flash_attention`` and of the
head expansion in its op (``ops.py``).  The kernels themselves are in
``csrc/flash_attention.cu``; the wrapper picks one by dtype, head dim
and GQA ratio before the launch (``variant``):

  * ``"wgmma"`` — bf16, D 64 or 128, at most ``MAX_REP`` query heads per
    kv head: a persistent kernel, one CTA an SM, walks work items of 128 Q
    rows longest first, each packing the query heads of one kv head (GQA)
    at 128 / rep positions; a producer thread loads Q and K/V tiles (96
    keys at D 128, 128 at D 64) with TMA into a 4-stage ring, two consumer
    warpgroups take turns running ``wgmma`` (S = Q K^T from shared memory,
    O += P V with P from registers) and an f32 online softmax.  The source
    encodes the tensor maps at each call;
  * ``"mma"`` — bf16, D 32, or more than ``MAX_REP`` query heads per kv
    head: the first version's ``mma.sync`` kernel;
  * ``"fma"`` — f32, D 32/64/128: full-f32 CUDA-core FMAs (the parity
    checks run the model in f32).

Every variant reads the GQA layout in place (query head ``h`` reads kv
head ``h // rep``) and stops at the diagonal when causal.  The source's
header says what bounds it and why it is built so.

The library is compiled from the repo's sources by ``nvcc`` at first use
(``kernels/_build.py``) and called through ``ctypes`` on PyTorch's current
stream.  This wrapper checks every tensor before the launch and raises on a
refused launch; it never falls back to the plain version (``ref.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._build import build

NAME = "flash_attention"
SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 128)
VARIANTS = {"fma": 0, "mma": 1, "wgmma": 2}   # codes of the C entry point
MAX_REP = 128                      # wg::kBM: the wgmma kernel's Q rows per item


def variant(dtype: torch.dtype, d: int, rep: int = 1) -> str:
    """The kernel a call launches for ``rep`` query heads per kv head:
    "wgmma" for bf16 at D 64/128 and rep <= ``MAX_REP``, "mma" for any
    other bf16 call, "fma" for f32; raises for any other dtype or head
    dim."""
    _check(d in HEAD_DIMS, f"head dim {d} (supported: {HEAD_DIMS})")
    if dtype == torch.float32:
        return "fma"
    _check(dtype == torch.bfloat16, f"dtype {dtype} (want f32/bf16)")
    return "mma" if d == 32 or rep > MAX_REP else "wgmma"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build("flash_attention", [SOURCE])
    fn = lib.flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{NAME}: {msg}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention forward; returns (B, Sq, H, D) in q.dtype.

    q (B, Sq, H, D), k / v (B, Skv, KVH, D), one dtype (bf16 or f32), H a
    multiple of KVH, D in ``HEAD_DIMS``; any Sq, Skv >= 1.  ``causal``
    masks top-left aligned (query i sees keys 0..i), as the reference's
    kernel and ``blocked_attention`` with ``q_offset=0`` do.  The kernel
    is chosen by ``variant(dtype, D, H // KVH)`` before the launch; a
    build or launch failure raises."""
    _check(q.is_cuda, f"q must be a CUDA tensor, got {q.device}")
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
        _check(t.dtype == q.dtype, f"{name} dtype {t.dtype}, q {q.dtype}")
    _check(q.ndim == 4 and k.ndim == 4 and k.shape == v.shape,
           f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
           f"v {tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, skv, kvh, dk = k.shape
    _check(k.shape[0] == b, f"batch {k.shape[0]} of k/v, {b} of q")
    _check(dk == d, f"head dim {d} of q, {dk} of k/v")
    _check(h % kvh == 0, f"{h} heads over {kvh} kv heads")
    kind = variant(q.dtype, d, h // kvh)
    _check(sq >= 1 and skv >= 1, f"empty sequence Sq={sq}, Skv={skv}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
    out = torch.empty_like(q)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), b, sq, skv, h, kvh, d,
                                  int(causal), 1.0 / math.sqrt(d),
                                  VARIANTS[kind], stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{NAME} launch failed: {msg} (cudaError {err})")
    LAUNCHES[NAME] += 1
    return out
