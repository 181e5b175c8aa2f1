"""The work of each hand-written kernel, from its shapes: the FLOPs and
bytes a launch must do at the least, and the time they bound it to on one
H100 (the data sheet's rates, ``core/hardware.py``).

Both the card's timings (``chip_smoke.py``: ``bound_ms`` of every kernel
entry) and the dry-run's op counter (``core/op_cost.py``: a kernel is a
``ctypes`` call that no dispatch mode sees, so its wrapper reports its
cost here when it is called on ``meta`` tensors) take their numbers from
these formulas, so the two agree by construction.

Bytes count each input read once and each output written once, whatever
the kernel reads again; operations count 2 flops a multiply-add of q.k
and p.v over the (query, key) pairs the mask lets through (causal, window,
each row's valid prefix), not the blocks a kernel happens to compute.
"""
from __future__ import annotations

import numpy as np

PEAK_BYTES_PER_S = 3.35e12                 # H100 SXM HBM3
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12,   # dense, no sparsity
                  "fp8": 1979e12, "int8": 1979e12}

# where a call on ``meta`` tensors reports its kernel's cost: the op
# counters that are active (``core.op_cost.OpCounter`` pushes itself here)
SINKS: list = []


def record(name: str, flops: int, nbytes: int) -> None:
    """Report one launch's work to the innermost active op counter (a
    wrapper on ``meta`` tensors calls this in place of its launch)."""
    if SINKS:
        SINKS[-1].add_kernel(name, flops, nbytes)


def roofline(nbytes: int, ops: int, ops_type: str) -> tuple[float, str]:
    """The larger of bytes over the memory rate and ops over the peak rate
    of their type, in ms, and which of the two it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[ops_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def window_pairs(Sq, Skv, causal, window) -> int:
    """Visible (query, key) pairs of one head: keys j <= i when causal,
    j > i - window with a window."""
    i = np.arange(Sq)
    hi = np.minimum(i + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.zeros(Sq, np.int64) if window is None else np.maximum(i - window + 1, 0)
    return int(np.maximum(hi - lo, 0).sum())


def flash_cost(B, Sq, Skv, h, kvh, causal, itemsize, d, window=None,
               dv=None) -> tuple[int, int]:
    """(flops, bytes) of a flash-attention forward: q, k, v read once and
    out written once; 2 flops per visible (query, key) pair
    (``window_pairs``) and head dim of q.k (D) and of p.v (Dv, D unless
    given)."""
    dv = d if dv is None else dv
    nbytes = itemsize * B * (Sq * h * (d + dv) + Skv * kvh * (d + dv))
    return 2 * B * h * (d + dv) * window_pairs(Sq, Skv, causal, window), nbytes


def flash_bound(B, Sq, Skv, h, kvh, causal, itemsize, dtype_name, d,
                window=None, dv=None):
    """``flash_cost`` at the inputs' peak rate."""
    flops, nbytes = flash_cost(B, Sq, Skv, h, kvh, causal, itemsize, d,
                               window, dv)
    return roofline(nbytes, flops, dtype_name)


def dense_cost(cur_len, B, itemsize, h, kvh, d,
               lse: bool = False) -> tuple[int, int]:
    """(flops, bytes) of a dense-cache decode: each valid K/V token read
    once, q read and out written once (with ``lse``, the partial mode,
    the f32 log-sum-exp written too), cur_len read; 4 flops per valid
    token, head and head dim."""
    tokens = int(np.sum(cur_len))
    nbytes = (2 * tokens * kvh * d * itemsize + 2 * B * h * d * itemsize
              + 4 * B + (4 * B * h if lse else 0))
    return 4 * tokens * h * d, nbytes


def dense_bound(cur_len, B, itemsize, dtype_name, h, kvh, d,
                lse: bool = False):
    """``dense_cost`` at the inputs' peak rate."""
    flops, nbytes = dense_cost(cur_len, B, itemsize, h, kvh, d, lse)
    return roofline(nbytes, flops, dtype_name)


def paged_cost(pos, window, B, itemsize, q_itemsize=None, scale_itemsize=0,
               C=1, *, geom) -> tuple[int, int]:
    """(flops, bytes) of a paged decode (C 1) or verify (C > 1) launch
    over ``geom`` = (H, KVH, D, page): each slot's live K/V tokens read
    once for all C queries (codes and, for code pools, their per-token
    scales), q read and out written once, plus the live table entries and
    positions; 4 flops per visible (query, key) pair, head and head dim."""
    h, kvh, d, page = geom
    pos = np.asarray(pos)
    q_itemsize = itemsize if q_itemsize is None else q_itemsize
    last = pos + C - 1
    lo = np.zeros_like(pos) if window is None else np.maximum(pos - window + 1, 0)
    tokens = int(np.sum(last - lo + 1))
    pages = int(np.sum(last // page - lo // page + 1))
    visible = 0
    for j in range(C):
        p = pos + j
        first = (np.zeros_like(p) if window is None
                 else np.maximum(p - window + 1, 0))
        visible += int(np.sum(p - first + 1))
    nbytes = (2 * tokens * kvh * (d * itemsize + scale_itemsize)
              + 2 * B * C * h * d * q_itemsize + 4 * pages + 4 * B)
    return 4 * visible * h * d, nbytes


def paged_bound(pos, window, B, dtype_name, itemsize, q_itemsize=None,
                scale_itemsize=0, C=1, *, geom) -> tuple[float, str]:
    """``paged_cost`` at the pools' peak rate."""
    flops, nbytes = paged_cost(pos, window, B, itemsize, q_itemsize,
                               scale_itemsize, C, geom=geom)
    return roofline(nbytes, flops, dtype_name)


def vmm_bytes(m: int, k: int, ns) -> int:
    """Codes (K/2 x N) and scales (K/32 x N) of each weight and bf16 x read
    once, bf16 outputs written once (the serve path's output)."""
    return sum(k * n // 2 + k * n // 32 + 2 * m * n for n in ns) + 2 * m * k


def vmm_cost(m: int, k: int, ns) -> tuple[int, int]:
    """(flops, bytes) of an MXFP4 launch: 2 M K N operations a weight and
    ``vmm_bytes``."""
    return 2 * m * k * sum(ns), vmm_bytes(m, k, ns)


def vmm_bound(m: int, k: int, ns) -> tuple[float, str]:
    """``vmm_bytes`` against 2 M K N operations on bf16 tensor cores."""
    return roofline(vmm_bytes(m, k, ns), 2 * m * k * sum(ns), "bfloat16")
