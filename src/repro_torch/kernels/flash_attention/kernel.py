"""Flash-attention forward: the CUDA kernel's wrapper.

The Hopper counterpart of the Pallas kernel
``repro/kernels/flash_attention/kernel.py::flash_attention`` and of the
head expansion in its op (``ops.py``).  The kernels themselves are in
``csrc/flash_attention.cu``; the wrapper picks one by dtype, head dim
and GQA ratio before the launch (``variant``):

  * ``"wgmma"`` — bf16, D 64, 80, 96 or 128, at most ``MAX_REP`` query
    heads per kv head: a persistent kernel, one CTA an SM, walks work items
    of 128 Q rows longest first, each packing the query heads of one kv
    head (GQA) at 128 / rep positions; a producer thread loads Q and K/V
    tiles (96 keys at D 80-128, 128 at D 64) with TMA into a 4-stage ring,
    two consumer warpgroups take turns running ``wgmma`` (S = Q K^T from
    shared memory, O += P V with P from registers) and an f32 online
    softmax.  D 80 and 96 use D 128's shared-memory layout, the columns
    past D filled with zeros by TMA: Q K^T runs D / 16 k-steps, P.V D
    128's product.  The source encodes the tensor maps at each call;
  * ``"mma"`` — bf16, D 32, or more than ``MAX_REP`` query heads per kv
    head: the first version's ``mma.sync`` kernel;
  * ``"fma"`` — f32, any pair of ``HEAD_DIM_PAIRS``: full-f32 CUDA-core
    FMAs (the parity checks run the model in f32).

V may be narrower than Q/K, as the reference's kernel allows: the pairs
(D, Dv) are every D of ``HEAD_DIMS`` with Dv = D, and (192, 128), which
is deepseek-v2-lite's MLA prefill (``hd`` 128 + ``rope_head_dim`` 64 of
q.k, ``v_hd`` 128).  Every variant takes that pair; in the wgmma kernel
Q K^T runs 12 k16 steps and P.V D 128's product, over a 2-stage K/V ring.

Every variant reads the GQA layout in place (query head ``h`` reads kv
head ``h // rep``), stops at the diagonal when causal and, with a sliding
``window``, starts at the first key tile the window reaches (tiles wholly
before it are neither loaded nor computed; only a tile straddling its edge
is masked).  The source's header says what bounds it and why it is built
so.

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

from repro_torch.kernels import LAUNCHES, cost
from repro_torch.kernels._build import build

NAME = "flash_attention"
SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 80, 96, 128)
# (D of q/k, Dv of v): Dv = D, and MLA's (192, 128)
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
VARIANTS = {"fma": 0, "mma": 1, "wgmma": 2}   # codes of the C entry point
MAX_REP = 128                      # wg::kBM: the wgmma kernel's Q rows per item


def variant(dtype: torch.dtype, d: int, rep: int = 1,
            dv: int | None = None) -> str:
    """The kernel a call launches for ``rep`` query heads per kv head:
    "wgmma" for bf16 at D >= 64 and rep <= ``MAX_REP``, "mma" for any
    other bf16 call, "fma" for f32; raises for any other dtype or any
    (D, Dv) pair outside ``HEAD_DIM_PAIRS`` (``dv`` None: Dv = D)."""
    pair = (d, d if dv is None else dv)
    _check(pair in HEAD_DIM_PAIRS,
           f"head dims (D, Dv) = {pair} (supported: {HEAD_DIM_PAIRS})")
    if dtype == torch.float32:
        return "fma"
    _check(dtype == torch.bfloat16, f"dtype {dtype} (want f32/bf16)")
    return "mma" if d == 32 or rep > MAX_REP else "wgmma"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build("flash_attention", [SOURCE])
    fn = lib.flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{NAME}: {msg}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    kind: str | None = None) -> torch.Tensor:
    """GQA attention forward; returns (B, Sq, H, Dv) in q.dtype, with the
    scale 1/sqrt(D) of the reference's kernel.

    q (B, Sq, H, D), k (B, Skv, KVH, D), v (B, Skv, KVH, Dv), one dtype
    (bf16 or f32), H a multiple of KVH, (D, Dv) in ``HEAD_DIM_PAIRS``; any
    Sq, Skv >= 1.  ``causal`` masks top-left aligned (query i sees keys
    0..i), as the reference's kernel and ``blocked_attention`` with
    ``q_offset=0`` do; ``window`` (>= 1) keeps only keys j > i - window, as
    ``blocked_attention(window=)`` does.  The kernel is chosen by
    ``variant(dtype, D, H // KVH, Dv)`` before the launch; ``kind`` names
    another one that takes the call ("mma" for any bf16 call, "wgmma" for
    bf16 at D >= 64 and rep <= ``MAX_REP``), to hold every variant against
    the plain version.  A build or launch failure raises.  On ``meta``
    tensors (the dry-run) it launches nothing: it reports the launch's
    work (``cost.flash_cost``) to the active op counter and returns an
    empty ``meta`` output."""
    _check(q.is_cuda or q.is_meta, f"q must be a CUDA tensor, got {q.device}")
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
        _check(t.dtype == q.dtype, f"{name} dtype {t.dtype}, q {q.dtype}")
    _check(q.ndim == 4 and k.ndim == 4 and v.ndim == 4
           and k.shape[:3] == v.shape[:3],
           f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
           f"v {tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, skv, kvh, dk = k.shape
    dv = v.shape[3]
    _check(k.shape[0] == b, f"batch {k.shape[0]} of k/v, {b} of q")
    _check(dk == d, f"head dim {d} of q, {dk} of k")
    _check(h % kvh == 0, f"{h} heads over {kvh} kv heads")
    chosen = variant(q.dtype, d, h // kvh, dv)
    if kind is not None and kind != chosen:
        _check(kind in VARIANTS and (kind == "fma") == (chosen == "fma")
               and (kind == "mma" or (d >= 64 and h // kvh <= MAX_REP)),
               f"variant {kind!r} does not take this call ({q.dtype}, "
               f"D {d}, rep {h // kvh})")
        chosen = kind
    _check(sq >= 1 and skv >= 1, f"empty sequence Sq={sq}, Skv={skv}")
    _check(window is None or window >= 1, f"window={window}")
    if q.is_meta:
        cost.record(NAME, *cost.flash_cost(b, sq, skv, h, kvh, causal,
                                           q.element_size(), d, window, dv))
        return q.new_empty((b, sq, h, dv))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
    out = q.new_empty((b, sq, h, dv))
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), b, sq, skv, h, kvh, d, dv,
                                  int(causal), window or 0,
                                  1.0 / math.sqrt(d), VARIANTS[chosen],
                                  stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{NAME} launch failed: {msg} (cudaError {err})")
    LAUNCHES[NAME] += 1
    return out
