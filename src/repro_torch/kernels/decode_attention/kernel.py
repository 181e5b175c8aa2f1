"""Dense-cache single-token GQA decode attention: the CUDA kernel's wrapper.

The Hopper counterpart of the Pallas kernel
``repro/kernels/decode_attention/kernel.py::decode_attention``.  The
kernels are in ``csrc/dense_decode.cu``; the wrapper picks one by dtype
and head dim before the launch (``variant``):

  * ``"tensor_core"`` — bf16 q over a bf16 cache at D 64/128 (the serve
    path): CTAs per (split, kv head, row) of 4 warps walk their share of
    the row's valid prefix (``cur_len``) in 64-token tiles through a
    3-stage ``cp.async`` ring, each warp its own 16 tokens of a tile;
    scores and P.V run ``mma.sync`` (P split into bf16 hi + lo), and the
    last CTA of each (row, kv head) folds the splits in the same launch,
    using a per-device counter array (``_counters``) that it leaves at
    zero;
  * ``"cuda_core"`` — every other pairing (f32 q or cache: the parity
    checks) and D 256: the first version's CUDA-core kernel over 32-token
    tiles and a second kernel that folds the splits.

Calls on one device share its counters, so tensor-core launches on two
streams of one device at once are not supported (the port issues every
launch on the current stream).  The source's header says what bounds each
kernel and why it is built so.

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
TILE = 64                         # tc::kTile: tokens per tile, tensor cores
CUDA_CORE_TILE = 32               # kTile: tokens per tile, CUDA cores
VARIANTS = {"cuda_core": 0, "tensor_core": 1}   # codes of the C entry point
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_COUNTERS: dict[int, torch.Tensor] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build("dense_decode", [SOURCE])
    fn = lib.dense_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.dense_decode_error_string.argtypes = [ctypes.c_int]
    lib.dense_decode_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def num_splits(b: int, kvh: int, n_tiles: int, sms: int) -> int:
    """CUDA-core kernel's CTAs per (kv head, row): enough for about four
    per SM across the batch, with at least two tiles per split of a
    full-length row."""
    want = -(-4 * sms // (b * kvh))
    return max(1, min(want, -(-n_tiles // 2)))


def split_count(kind: str, b: int, kvh: int, s: int, sms: int) -> int:
    """The launch's split count, from the cache's S.  Tensor cores: as
    many as one wave holds (two CTAs an SM, by their shared memory; rounded
    down, so no CTA waits for a second wave), at most one per 64-token
    tile.  CUDA cores: the first version's rule."""
    if kind == "tensor_core":
        return max(1, min(2 * sms // (b * kvh), -(-s // TILE)))
    return num_splits(b, kvh, -(-s // CUDA_CORE_TILE), sms)


def variant(q_dtype: torch.dtype, kv_dtype: torch.dtype, d: int) -> str:
    """The kernel a call launches: "tensor_core" for bf16 q over a bf16
    cache at D 64/128, "cuda_core" for any other pairing of f32 and bf16
    and for D 256; raises for another dtype or head dim."""
    _check(q_dtype in _DTYPE_CODES, f"q dtype {q_dtype} (want f32/bf16)")
    _check(kv_dtype in _DTYPE_CODES,
           f"cache dtype {kv_dtype} (want f32/bf16)")
    _check(d in HEAD_DIMS, f"head dim {d} (supported: {HEAD_DIMS})")
    if q_dtype == torch.bfloat16 and kv_dtype == torch.bfloat16 and d <= 128:
        return "tensor_core"
    return "cuda_core"


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """The device's (row, kv head) arrival counters of the tensor-core
    kernel: zeroed here once, left at zero by every launch."""
    cnt = _COUNTERS.get(dev.index)
    if cnt is None or cnt.numel() < n:
        cnt = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[dev.index] = cnt
    return cnt


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{NAME}: {msg}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: torch.Tensor
                     ) -> torch.Tensor:
    """Single-token GQA decode attention over a dense cache; returns
    (B, H, D) in q.dtype.

    q (B, H, D) bf16 or f32; k_cache / v_cache (B, S, KVH, D) bf16 or f32;
    cur_len (B,) int32, each in [1, S]: row b attends positions
    0 .. cur_len[b] - 1, and nothing at or past cur_len[b] is read.  The
    kernel is chosen by ``variant`` before the launch; a build or launch
    failure raises."""
    _check(q.is_cuda, f"q must be a CUDA tensor, got {q.device}")
    dev = q.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("cur_len", cur_len)):
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
    _check(v_cache.dtype == k_cache.dtype,
           f"cache dtypes {k_cache.dtype}/{v_cache.dtype} differ")
    _check(cur_len.dtype == torch.int32, "cur_len must be int32")
    _check(q.ndim == 3 and k_cache.ndim == 4
           and k_cache.shape == v_cache.shape,
           f"shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
           f"v {tuple(v_cache.shape)}")
    b, h, d = q.shape
    bk, s, kvh, dk = k_cache.shape
    _check(bk == b, f"cache batch {bk}, q batch {b}")
    _check(dk == d, f"head dim {d} of q, {dk} of the cache")
    kind = variant(q.dtype, k_cache.dtype, d)
    _check(h % kvh == 0 and h // kvh <= MAX_REP,
           f"{h} heads over {kvh} kv heads (at most {MAX_REP} per kv head)")
    _check(cur_len.shape == (b,), f"cur_len {tuple(cur_len.shape)}, "
           f"want ({b},)")
    q, k_cache, v_cache = q.contiguous(), k_cache.contiguous(), \
        v_cache.contiguous()
    cur_len = cur_len.contiguous()
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        _check(t.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")

    n_split = split_count(kind, b, kvh, s, _num_sms(dev.index))
    out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    ws_acc = torch.empty((b, h, n_split, d), dtype=torch.float32, device=dev)
    ws_ml = torch.empty((b, h, n_split, 2), dtype=torch.float32, device=dev)
    counters = (_counters(dev, b * kvh).data_ptr()
                if kind == "tensor_core" else None)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.dense_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cur_len.data_ptr(), out.data_ptr(), ws_acc.data_ptr(),
            ws_ml.data_ptr(), counters, b, s, kvh, h // kvh, d, n_split,
            1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[k_cache.dtype], VARIANTS[kind], stream)
    if err != 0:
        msg = lib.dense_decode_error_string(err).decode()
        raise RuntimeError(f"{NAME} launch failed: {msg} (cudaError {err})")
    LAUNCHES[NAME] += 1
    return out
