"""Pool pricing of the paged serve plan.

The port of ``paged_kv_token_bytes`` and ``paged_kv_token_bytes_split``
from ``repro/parallel/plan.py``: the bytes one cached token costs in every
page pool of a model, measured from a tiny pool built at the cache dtype on
the ``meta`` device (shapes and dtypes, no storage), so quantized fp8/int8
pools price their 1-byte codes plus f32 scale leaves, the bytes the engine
allocates.  Tensor-parallel pricing (``tp > 1``) and the rest of the
reference module (``PagedServePlan``) belong to ROADMAP Queue 1, 'Tensor
parallelism'.
"""
from __future__ import annotations

import math


def paged_kv_token_bytes(model, *, tp: int = 1, dtype_bytes: int = 4,
                         cache_dtype=None) -> int:
    """Pool bytes one cached token costs on the device.  With
    ``cache_dtype`` set the bytes are measured from an actual tiny pool at
    that dtype (``dtype_bytes`` is ignored); without it every leaf element
    counts ``dtype_bytes``."""
    full, ring = paged_kv_token_bytes_split(model, tp=tp,
                                            dtype_bytes=dtype_bytes,
                                            cache_dtype=cache_dtype)
    return full + ring


def paged_kv_token_bytes_split(model, *, tp: int = 1, dtype_bytes: int = 4,
                               cache_dtype=None) -> tuple[int, int]:
    """``paged_kv_token_bytes`` split into its ``(full, ring)`` residency
    halves: bytes/token in full-context segments vs sliding-window
    segments (which hold O(window) tokens per slot once ring pages are
    reclaimed).  SSM segments write no token-indexed pages and count in
    neither half."""
    from repro_torch.models.attention_backends import backend_for_kind

    if tp > 1:
        from repro_torch.runtime.engine import _unported
        raise _unported(f"tensor-parallel pool pricing (tp={tp})",
                        "Tensor parallelism")
    full = ring = 0
    for seg in model.plan:
        seg_total = 0
        for kind in seg.kinds:
            be = backend_for_kind(kind)
            if be is None or not be.supports_paged:
                continue
            if cache_dtype is not None:
                pool = be.init_page_pool(model.cfg, 2, 1, dtype=cache_dtype,
                                         device="meta")
                leaf_bytes = [math.prod(v.shape[2:]) * v.element_size()
                              for v in pool.values()]
            else:
                pool = be.init_page_pool(model.cfg, 2, 1, device="meta")
                leaf_bytes = [math.prod(v.shape[2:]) * dtype_bytes
                              for v in pool.values()]
            seg_total += sum(leaf_bytes) * seg.reps
        if seg.window is not None:
            ring += seg_total
        else:
            full += seg_total
    return full, ring
