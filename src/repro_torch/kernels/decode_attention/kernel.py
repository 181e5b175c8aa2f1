"""Dense-cache single-token GQA decode attention: the CUDA kernel's wrapper.

The Hopper counterpart of the Pallas kernel
``repro/kernels/decode_attention/kernel.py::decode_attention``.  The kernel
itself is ``csrc/dense_decode.cu``: CTAs per (kv head, row, split) walk
their share of the row's valid prefix (``cur_len``) of the dense
``(B, S, KVH, D)`` cache in 32-token tiles, double-buffered in shared
memory, with q and the f32 online-softmax state on chip; a second kernel
folds the splits.  The source's header says what bounds it and why it is
built so.

The library is compiled from the repo's sources by ``nvcc`` at first use
(``kernels/_build.py``) and called through ``ctypes`` on PyTorch's current
stream.  This wrapper checks every tensor before the launch and raises on a
refused launch; it never falls back to the plain version
(``models.common.decode_attention_ref``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels._build import build

NAME = "decode_attention"
SOURCE = Path(__file__).parent / "csrc" / "dense_decode.cu"
HEAD_DIMS = (64, 128, 256)
MAX_REP = 16                      # kMaxRep in the source
TILE = 32                         # kTile in the source
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build("dense_decode", [SOURCE])
    fn = lib.dense_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.dense_decode_error_string.argtypes = [ctypes.c_int]
    lib.dense_decode_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def num_splits(b: int, kvh: int, n_tiles: int, sms: int) -> int:
    """CTAs per (kv head, row): enough for about four per SM across the
    batch, with at least two tiles per split of a full-length row."""
    want = -(-4 * sms // (b * kvh))
    return max(1, min(want, -(-n_tiles // 2)))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{NAME}: {msg}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cur_len: torch.Tensor) -> torch.Tensor:
    """Single-token GQA decode attention over a dense cache; returns
    (B, H, D) in q.dtype.

    q (B, H, D) bf16 or f32; k_cache / v_cache (B, S, KVH, D) bf16 or f32;
    cur_len (B,) int32, each in [1, S]: row b attends positions
    0 .. cur_len[b] - 1, and nothing at or past cur_len[b] is read."""
    _check(q.is_cuda, f"q must be a CUDA tensor, got {q.device}")
    dev = q.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("cur_len", cur_len)):
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
    _check(q.dtype in _DTYPE_CODES, f"q dtype {q.dtype} (want f32/bf16)")
    _check(k_cache.dtype in _DTYPE_CODES and v_cache.dtype == k_cache.dtype,
           f"cache dtypes {k_cache.dtype}/{v_cache.dtype} (want f32/bf16)")
    _check(cur_len.dtype == torch.int32, "cur_len must be int32")
    _check(q.ndim == 3 and k_cache.ndim == 4
           and k_cache.shape == v_cache.shape,
           f"shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
           f"v {tuple(v_cache.shape)}")
    b, h, d = q.shape
    bk, s, kvh, dk = k_cache.shape
    _check(bk == b, f"cache batch {bk}, q batch {b}")
    _check(dk == d and d in HEAD_DIMS, f"head dim {d} / cache {dk} "
           f"(supported: {HEAD_DIMS})")
    _check(h % kvh == 0 and h // kvh <= MAX_REP,
           f"{h} heads over {kvh} kv heads (at most {MAX_REP} per kv head)")
    _check(cur_len.shape == (b,), f"cur_len {tuple(cur_len.shape)}, "
           f"want ({b},)")
    q, k_cache, v_cache = q.contiguous(), k_cache.contiguous(), \
        v_cache.contiguous()
    cur_len = cur_len.contiguous()
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _check(t.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")

    n_split = num_splits(b, kvh, -(-s // TILE), _num_sms(dev.index))
    out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    ws_acc = torch.empty((b, h, n_split, d), dtype=torch.float32, device=dev)
    ws_ml = torch.empty((b, h, n_split, 2), dtype=torch.float32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.dense_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cur_len.data_ptr(), out.data_ptr(), ws_acc.data_ptr(),
            ws_ml.data_ptr(), b, s, kvh, h // kvh, d, n_split,
            1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[k_cache.dtype], stream)
    if err != 0:
        msg = lib.dense_decode_error_string(err).decode()
        raise RuntimeError(f"{NAME} launch failed: {msg} (cudaError {err})")
    LAUNCHES[NAME] += 1
    return out
