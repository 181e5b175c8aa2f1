"""Quantized paged-KV cache formats: fp8 (E4M3) and int8 page pools.

The PyTorch counterpart of ``repro/quant/kv.py``.  ``cache_dtype`` takes
two string values — ``"fp8"`` and ``"int8"`` — beside the torch dtypes.  A
quantized pool stores K/V *codes* in the narrow storage dtype plus
per-token-per-KV-head ``float32`` scales in sibling ``k_scale`` /
``v_scale`` pool leaves of shape ``(P, page, KVH)``, so page copy and
permute treat them like any other leaf.

Scales are computed at *write* time (amax of the token's head vector), the
only scheme compatible with incremental scatter writes.  Dequant is one
elementwise multiply (f32 code times f32 scale), the same in the plain
version and inside the CUDA decode kernel's page loop.
"""
from __future__ import annotations

import functools

import torch

# name -> (storage dtype, max representable magnitude)
KV_FORMATS = {
    "fp8": (torch.float8_e4m3fn, 448.0),
    "int8": (torch.int8, 127.0),
}
SCALE_DTYPE = torch.float32


def validate_cache_dtype(dtype) -> None:
    if isinstance(dtype, str) and dtype not in KV_FORMATS:
        raise ValueError(f"unknown quantized cache_dtype {dtype!r}; "
                         f"know {sorted(KV_FORMATS)} (or pass a torch dtype)")


def is_quantized_cache_dtype(dtype) -> bool:
    """True for the string cache dtypes ("fp8" / "int8")."""
    validate_cache_dtype(dtype)
    return isinstance(dtype, str)


def cache_storage_dtype(dtype):
    """The dtype K/V codes are stored in (identity for plain dtypes)."""
    if is_quantized_cache_dtype(dtype):
        return KV_FORMATS[dtype][0]
    return dtype


def pool_cache_format(pool: dict) -> str | None:
    """Which quantized format a pool was built with (None = dense)."""
    if "k_scale" not in pool:
        return None
    for name, (store, _) in KV_FORMATS.items():
        if pool["k"].dtype == store:
            return name
    raise ValueError(f"pool has scale leaves but unrecognized code dtype "
                     f"{pool['k'].dtype}")


def raw_view(t: torch.Tensor) -> torch.Tensor:
    """fp8 codes as their uint8 bits (other dtypes as they are), for the
    indexing, scatter and copy ops that move pool bytes: bit-identical,
    and every device has them for uint8."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@functools.lru_cache(maxsize=None)
def _constants(cache_dtype: str, device: torch.device):
    """(qmax, 1.0) as f32 scalar tensors on ``device``, made once per
    format and device: building them on a CUDA device on every call copies
    from pageable host memory, which makes the host wait."""
    _, qmax = KV_FORMATS[cache_dtype]
    return (torch.tensor(qmax, dtype=torch.float32, device=device),
            torch.tensor(1.0, dtype=torch.float32, device=device))


def kv_quantize(vals: torch.Tensor, cache_dtype: str):
    """Quantize K or V vectors (..., KVH, HD) -> (codes, scales (..., KVH)).

    One f32 scale per stored token per KV head: ``amax / qmax`` (1.0 for
    all-zero vectors so dequant stays finite)."""
    store, qmax = KV_FORMATS[cache_dtype]
    v = vals.to(torch.float32)
    amax = v.abs().amax(dim=-1)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its rounded reciprocal, which is not always amax / qmax
    qmax_t, one = _constants(cache_dtype, amax.device)
    scale = torch.where(amax > 0, amax / qmax_t, one)
    scaled = v / scale[..., None]
    if store == torch.int8:
        codes = torch.clamp(torch.round(scaled), -qmax, qmax).to(store)
    else:
        codes = torch.clamp(scaled, -qmax, qmax).to(store)
    return codes, scale.to(SCALE_DTYPE)


def kv_dequantize(codes: torch.Tensor, scales: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """codes (..., KVH, HD) x scales (..., KVH) -> values in ``dtype``: the
    f32 cast, then one multiply, as the decode kernel does per page."""
    return (codes.to(torch.float32) * scales[..., None]).to(dtype)
