"""Paged GQA decode attention: the CUDA kernels' wrappers.

The Hopper counterparts of the Pallas kernel
``repro/kernels/decode_attention/paged_kernel.py::paged_decode_attention``,
over dense bf16/f32 pools and over fp8/int8 code pools with per-token f32
scale pools, one per accumulator mode:

  * ``accum="online"`` (``csrc/paged_decode.cu``): CTAs per (split, kv
    head, slot) walk their share of the slot's live pages through the page
    table with q and the f32 online-softmax state on chip.  The split count
    follows the batch, so a row's bits depend on its batch.
  * ``accum="exact"`` (``csrc/paged_exact.cu``, the reference's
    ``_exact_kernel``): every sum's order is fixed by the query's position
    alone (fixed 128-position chunks folded in order).  Its multi-query
    entry ``paged_decode_multi_attention`` (C queries per slot) carries the
    speculative verify step.

Each source holds two kernels, picked by ``variant`` before the launch by
dtype, head dim and page size, never on failure:

  * ``"tensor_core"`` — bf16 q over bf16, fp8 or int8 pools at D 64/128
    with a page that is a multiple of 16 (the serve paths): one launch,
    scores and P.V on ``mma.sync`` (fp8/int8 codes converted to bf16 as the
    fragments form), and the last CTA of each (slot, kv head) folds the
    partial states, found through a per-kernel, per-device integer counter
    array (``_counters``) that it leaves at zero;
  * ``"cuda_core"`` — f32 q or pools (the parity checks), D 256, other
    pages: the first versions' CUDA-core kernels (two launches online, four
    exact).

Calls on one device share its counters, so tensor-core launches on two
streams of one device at once are not supported (the port issues every
launch on the current stream).  Each source's header says what bounds it
and why it is built so.  The libraries are compiled from the repo's
sources by ``nvcc`` at first use (``kernels/_build.py``) and called through
``ctypes`` on PyTorch's current stream.  The wrappers check every tensor
before the launch and raise on a refused launch; they never fall back to
the plain versions (``ref.py``).  Each launch adds one to
``kernels.LAUNCHES`` under the kernel's name and to
``kernels.VARIANT_LAUNCHES`` under ``"<name>:<variant>"``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
from repro_torch.kernels._build import build

NAME = "paged_decode_attention"
NAME_SCALED = "paged_decode_attention_scaled"   # launches on code pools
NAME_EXACT = "paged_decode_attention_exact"     # the exact accumulator
SOURCE = Path(__file__).parent / "csrc" / "paged_decode.cu"
EXACT_SOURCE = Path(__file__).parent / "csrc" / "paged_exact.cu"
EXACT_MAX_ROWS = 64               # kMaxRows: C * rep per (slot, kv head)
EXACT_CHUNK = 128                 # kChunkPos: positions per P.V chunk
EXACT_SCORE_CHUNK = 64            # kScoreChunkPos: the page size divides it
EXACT_SPLIT = 256                 # tc::kSplitPos: positions per partial, tensor cores
HEAD_DIMS = (64, 128, 256)
MAX_REP = 16                      # kMaxRep in the source
SMEM_LIMIT = 232448               # bytes of shared memory a block may use
TILE = 64                         # tc::kTile: tokens per tile, online kernel
TC_HEAD_DIMS = (64, 128)          # head dims of the tensor-core kernels
TC_PAGE_MULTIPLE = 16             # their page: a multiple of 16 tokens
VARIANTS = {"cuda_core": 0, "tensor_core": 1}   # codes of the C entry points
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CODE_DTYPES = {torch.float8_e4m3fn: 2, torch.int8: 3}   # need scale pools
_POOL_DTYPE_CODES = {**_DTYPE_CODES, **_CODE_DTYPES}
_COUNTERS: dict[tuple[str, int], torch.Tensor] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build("paged_decode", [SOURCE])
    fn = lib.paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.paged_decode_error_string.argtypes = [ctypes.c_int]
    lib.paged_decode_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _exact_lib() -> ctypes.CDLL:
    lib = build("paged_exact", [EXACT_SOURCE])
    fn = lib.paged_exact_attention
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.paged_exact_error_string.argtypes = [ctypes.c_int]
    lib.paged_exact_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def num_splits(b: int, kvh: int, n_blocks: int, sms: int) -> int:
    """CUDA-core kernel's CTAs per (kv head, slot): enough for about four
    per SM across the batch, with at least two pages per split."""
    want = -(-4 * sms // (b * kvh))
    return max(1, min(want, -(-n_blocks // 2)))


def split_count(kind: str, b: int, kvh: int, n_blocks: int, page: int,
                sms: int) -> int:
    """The online launch's split count, from the table's width.  Tensor
    cores: as many as one wave holds (two CTAs an SM, by their shared
    memory; rounded down, so no CTA waits for a second wave), at most one
    per 64-token tile of the table.  CUDA cores: the first version's rule."""
    if kind == "tensor_core":
        return max(1, min(2 * sms // (b * kvh), -(-n_blocks * page // TILE)))
    return num_splits(b, kvh, n_blocks, sms)


def variant(q_dtype: torch.dtype, pool_dtype: torch.dtype, d: int,
            page: int) -> str:
    """The kernel a call launches, online or exact: "tensor_core" for bf16
    q over bf16, fp8 or int8 pools at D 64/128 with a page that is a
    multiple of 16; "cuda_core" for every other pairing and shape the
    wrappers take."""
    if (q_dtype == torch.bfloat16 and pool_dtype != torch.float32
            and d in TC_HEAD_DIMS and page % TC_PAGE_MULTIPLE == 0):
        return "tensor_core"
    return "cuda_core"


def _counters(kernel: str, dev: torch.device, n: int) -> torch.Tensor:
    """The (slot, kv head) arrival counters of a tensor-core kernel
    (``kernel``: "online" or "exact") on ``dev``: one array per kernel and
    device, at least ``n`` = B x KVH long, zeroed here when it is made and
    left at zero by every launch."""
    cnt = _COUNTERS.get((kernel, dev.index))
    if cnt is None or cnt.numel() < n:
        cnt = torch.zeros(n, dtype=torch.int32, device=dev)
        _COUNTERS[(kernel, dev.index)] = cnt
    return cnt


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{NAME}: {msg}")


def _check_inputs(q, k_pages, v_pages, page_table, pos, k_scales, v_scales,
                  window, q_ndim: int) -> bool:
    """Device, dtype, shape and contiguity checks shared by both wrappers;
    returns whether the pools hold codes (fp8/int8)."""
    _check(q.is_cuda, f"q must be a CUDA tensor, got {q.device}")
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("pos", pos)):
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("pos", pos)):
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(q.dtype in _DTYPE_CODES, f"q dtype {q.dtype} (want f32/bf16)")
    quantized = k_pages.dtype in _CODE_DTYPES
    _check((k_pages.dtype in _DTYPE_CODES or quantized)
           and v_pages.dtype == k_pages.dtype,
           f"pool dtypes {k_pages.dtype}/{v_pages.dtype} (want one of "
           f"f32/bf16/fp8 e4m3/int8)")
    _check(quantized == (k_scales is not None) == (v_scales is not None),
           f"{k_pages.dtype} pools with k_scales "
           f"{'given' if k_scales is not None else 'None'}: code pools "
           f"(fp8/int8) need both scale pools, dense pools take none")
    if quantized:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            _check(t.device == dev and t.dtype == torch.float32
                   and t.is_contiguous()
                   and tuple(t.shape) == tuple(k_pages.shape[:3]),
                   f"{name} must be a contiguous f32 {tuple(k_pages.shape[:3])}"
                   f" tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                   f"{t.device}")
    _check(page_table.dtype == torch.int32 and pos.dtype == torch.int32,
           "page_table and positions must be int32")
    _check(q.ndim == q_ndim and k_pages.ndim == 4
           and k_pages.shape == v_pages.shape,
           f"shapes q {tuple(q.shape)}, k {tuple(k_pages.shape)}, "
           f"v {tuple(v_pages.shape)}")
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    _, page, kvh, dk = k_pages.shape
    _check(dk == d and d in HEAD_DIMS, f"head dim {d} / pool {dk} "
           f"(supported: {HEAD_DIMS})")
    _check(h % kvh == 0, f"{h} heads over {kvh} kv heads")
    _check(page_table.ndim == 2 and page_table.shape[0] == b
           and page_table.shape[1] >= 1, f"page_table {tuple(page_table.shape)}")
    _check(pos.shape == (b,), f"positions {tuple(pos.shape)}, want ({b},)")
    _check(window is None or window >= 1, f"window={window}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check(t.data_ptr() % 16 == 0, f"{name} is not 16-byte aligned")
    return quantized


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           pos: torch.Tensor, *,
                           k_scales: torch.Tensor | None = None,
                           v_scales: torch.Tensor | None = None,
                           window: int | None = None,
                           accum: str = "online") -> torch.Tensor:
    """Single-token paged GQA decode attention; returns (B, H, D) in q.dtype.

    q (B, H, D) bf16 or f32; k_pages / v_pages (P, page, KVH, D), bf16 or
    f32, or fp8 e4m3 / int8 codes with k_scales / v_scales (P, page, KVH)
    f32; page_table (B, n_blocks) int32; pos (B,) int32, each >= 0.  Every
    entry of the table's live blocks (block ``pos // page`` and below) must
    name a page of the pool: the kernel reads through it unchecked.
    ``accum``: "online" (``paged_decode.cu``) or "exact" (``paged_exact.cu``
    with one query per slot: each sum's order fixed by the position
    alone)."""
    if accum == "exact":
        return paged_decode_multi_attention(
            q[:, None], k_pages, v_pages, page_table, pos, k_scales=k_scales,
            v_scales=v_scales, window=window)[:, 0]
    if accum != "online":
        raise ValueError(f"accum={accum!r} (want 'online' or 'exact')")
    quantized = _check_inputs(q, k_pages, v_pages, page_table, pos, k_scales,
                              v_scales, window, 3)
    dev = q.device
    b, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    _check(h // kvh <= MAX_REP,
           f"{h} heads over {kvh} kv heads (at most {MAX_REP} per kv head)")
    rep = h // kvh
    kind = variant(q.dtype, k_pages.dtype, d, page)
    if kind == "cuda_core":   # shared memory: q, scores, state, 2 pages
        smem = 4 * (rep * d + rep * page + 3 * rep + 3) + 4 * page * d * \
            k_pages.element_size() + (4 * page * 4 if quantized else 0)
        _check(smem <= SMEM_LIMIT, f"page {page} x head dim {d} needs {smem} "
               f"B of shared memory (limit {SMEM_LIMIT})")

    n_blocks = page_table.shape[1]
    n_split = split_count(kind, b, kvh, n_blocks, page, _num_sms(dev.index))
    out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    ws_acc = torch.empty((b, h, n_split, d), dtype=torch.float32, device=dev)
    ws_ml = torch.empty((b, h, n_split, 2), dtype=torch.float32, device=dev)
    counters = (_counters("online", dev, b * kvh).data_ptr()
                if kind == "tensor_core" else None)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            ws_acc.data_ptr(), ws_ml.data_ptr(), counters, b, kvh, rep, d,
            page, n_blocks, n_split, window or 0, 1.0 / math.sqrt(d),
            _DTYPE_CODES[q.dtype], _POOL_DTYPE_CODES[k_pages.dtype],
            VARIANTS[kind], stream)
    if err != 0:
        msg = lib.paged_decode_error_string(err).decode()
        raise RuntimeError(f"{NAME} launch failed: {msg} (cudaError {err})")
    name = NAME_SCALED if quantized else NAME
    LAUNCHES[name] += 1
    VARIANT_LAUNCHES[f"{name}:{kind}"] += 1
    return out


def paged_decode_multi_attention(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 page_table: torch.Tensor, start: torch.Tensor,
                                 *, k_scales: torch.Tensor | None = None,
                                 v_scales: torch.Tensor | None = None,
                                 window: int | None = None) -> torch.Tensor:
    """Multi-query paged GQA decode attention with the exact accumulator
    (``csrc/paged_exact.cu``); returns (B, C, H, D) in q.dtype.

    q (B, C, H, D): query j of row b sits at position start[b] + j and sees
    the positions up to its own (and past position - window with a
    window); start (B,) int32; pools, scales and table as in
    ``paged_decode_attention``, whose ``accum="exact"`` is this entry with
    C = 1.  C * rep must be at most ``EXACT_MAX_ROWS`` and the page size
    must be a multiple of 16 (the tensor-core kernel) or divide
    ``EXACT_SCORE_CHUNK`` (the CUDA-core one).  The table's blocks through
    ``(start + C - 1) // page`` must name pages of the pool."""
    quantized = _check_inputs(q, k_pages, v_pages, page_table, start,
                              k_scales, v_scales, window, 4)
    dev = q.device
    b, c, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    rep = h // kvh
    _check(c * rep <= EXACT_MAX_ROWS,
           f"{c} queries x {rep} heads per kv head = {c * rep} rows (at most "
           f"{EXACT_MAX_ROWS})")
    kind = variant(q.dtype, k_pages.dtype, d, page)
    n_blocks = page_table.shape[1]
    s_len = n_blocks * page
    if kind == "cuda_core":
        n_parts = -(-s_len // EXACT_CHUNK)
        _check(EXACT_SCORE_CHUNK % page == 0,
               f"page {page} does not divide {EXACT_SCORE_CHUNK}")
        rows = next(r for r in (8, 16, 32, 64) if c * rep <= r)   # kRows
        stage = 2 * page * d * k_pages.element_size() + (8 * page if quantized
                                                          else 0)
        smem = max(4 * (c * rep * d + 3) + stage,
                   4 * EXACT_CHUNK * (rows + 4) + stage)
        _check(smem <= SMEM_LIMIT, f"{c * rep} rows x head dim {d} need "
               f"{smem} B of shared memory (limit {SMEM_LIMIT})")
        # the f32 scores of every (query row, position)
        ws_s = torch.empty((b, kvh, c * rep, s_len), dtype=torch.float32,
                           device=dev)
        counters = None
    else:                 # each split's (m, l) of every query row
        n_parts = -(-s_len // EXACT_SPLIT)
        ws_s = torch.empty((b, kvh, n_parts, c * rep, 2),
                           dtype=torch.float32, device=dev)
        counters = _counters("exact", dev, b * kvh).data_ptr()
    out = torch.empty((b, c, h, d), dtype=q.dtype, device=dev)
    # each chunk's (CUDA cores) or split's (tensor cores) partial P.V
    ws_pv = torch.empty((b, kvh, n_parts, c * rep, d), dtype=torch.float32,
                        device=dev)
    lib = _exact_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.paged_exact_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            page_table.data_ptr(), start.data_ptr(), out.data_ptr(),
            ws_s.data_ptr(), ws_pv.data_ptr(), counters, b, c, kvh, rep, d,
            page, n_blocks, window or 0, 1.0 / math.sqrt(d),
            _DTYPE_CODES[q.dtype], _POOL_DTYPE_CODES[k_pages.dtype],
            VARIANTS[kind], stream)
    if err != 0:
        msg = lib.paged_exact_error_string(err).decode()
        raise RuntimeError(f"{NAME_EXACT} launch failed: {msg} "
                           f"(cudaError {err})")
    LAUNCHES[NAME_EXACT] += 1
    VARIANT_LAUNCHES[f"{NAME_EXACT}:{kind}"] += 1
    return out
