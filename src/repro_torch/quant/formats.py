"""Block-quantized weight formats (the Stream Decoder's formats, paper §V).

The PyTorch counterpart of ``repro/quant/formats.py``, format for format
and bit for bit:

  * **MXFP4** — OCP Microscaling: 32-element blocks, E8M0 shared scale,
    E2M1 (fp4) elements.  The serving default ("MXFP4 weights ... BF16
    activations").
  * **MXFP8** — 32-element blocks, E8M0 scale, E4M3 elements.
  * **BFP16** — Block Floating Point: 16-element blocks, shared 8-bit
    exponent, 8-bit two's-complement mantissas.
  * **NXFP4** — MXFP4 plus a 1-bit micro-exponent per 8-element sub-block.

Every function quantizes along the weight's K axis (axis -2 of a
``(..., K, N)`` weight), the order the stripe dataflow streams it.

Packing layout for MXFP4/NXFP4 (what ``kernels/mxfp4_vmm`` reads):
  codes  : uint8[..., K/2, N]   two fp4 codes per byte, low nibble = even k
  scales : uint8[..., K/32, N]  E8M0 biased exponents (bias 127)

Exponents are exact on every device.  The shared exponent
``floor(log2(amax))`` comes from ``torch.frexp`` and powers of two are
built from their bits (``_pow2``), never from ``log2``/``exp2``, whose
results for exact powers of two differ by device and library.  Casts of
out-of-range floats to integer storage saturate (NaN -> 0), as XLA's do.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

MX_BLOCK = 32
BFP_BLOCK = 16
NX_SUB = 8

# E2M1 representable magnitudes; code = sign<<3 | idx
FP4_VALUES = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], np.float32)
FP4_LUT = np.concatenate([FP4_VALUES, -FP4_VALUES]).astype(np.float32)
_FP4_MAX = 6.0
_E8M0_BIAS = 127


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2**e in f32 for integral f32 ``e``, exact on every device: normal
    and subnormal powers are assembled from their bit patterns; e > 127
    gives inf, e < -149 gives 0; non-finite ``e`` goes through ``exp2``
    (inf -> inf, -inf -> 0, NaN -> NaN)."""
    ei = torch.nan_to_num(e, nan=0.0, posinf=0.0, neginf=0.0)
    ei = ei.clamp(-200, 200).to(torch.int32)
    one = torch.ones_like(ei)
    normal = ((ei + 127).clamp(1, 254) << 23).view(torch.float32)
    sub = (one << (ei + 149).clamp(0, 22)).view(torch.float32)
    val = torch.where(ei >= -126, normal, sub)
    val = torch.where(ei > 127, torch.full_like(val, math.inf), val)
    val = torch.where(ei < -149, torch.zeros_like(val), val)
    return torch.where(torch.isfinite(e), val, torch.exp2(e))


def _floor_log2(a: torch.Tensor) -> torch.Tensor:
    """floor(log2(a)) exactly for finite a > 0 (``frexp``: a = m * 2**x
    with m in [0.5, 1)); non-finite ``a`` passes through as log2 would
    map it (inf -> inf, NaN -> NaN)."""
    _, ex = torch.frexp(torch.where(torch.isfinite(a), a, 1.0))
    return torch.where(torch.isfinite(a), (ex - 1).to(torch.float32), a)


def _ceil_log2(a: torch.Tensor) -> torch.Tensor:
    """ceil(log2(a)) exactly for finite a > 0 (non-finite as above)."""
    m, ex = torch.frexp(torch.where(torch.isfinite(a), a, 1.0))
    e = ex.to(torch.float32) - (m == 0.5).to(torch.float32)
    return torch.where(torch.isfinite(a), e, a)


def _sat_cast(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float -> integer cast that saturates at the type's range and maps
    NaN to 0 (XLA's convert semantics; a plain ``.to`` is undefined
    there)."""
    info = torch.iinfo(dtype)
    return torch.nan_to_num(v, nan=0.0).clamp(info.min, info.max).to(dtype)


def _e8m0_scale_exp(amax: torch.Tensor, elem_emax: float) -> torch.Tensor:
    """Shared-scale exponent: floor(log2(amax)) - elem_emax (OCP MX spec);
    0 for all-zero blocks."""
    e = _floor_log2(torch.where(amax > 0, amax, 1.0)) - elem_emax
    return torch.where(amax > 0, e, 0.0)      # NaN amax -> 0, as well


def _quantize_fp4_codes(x_scaled: torch.Tensor) -> torch.Tensor:
    """Round scaled values to nearest E2M1 (OCP-MX round-to-nearest-even);
    non-finite inputs saturate to +/-6.0.  Returns uint8 codes 0..15."""
    sign = torch.signbit(x_scaled).to(torch.uint8)
    mag = x_scaled.abs()
    idx = torch.zeros(mag.shape, dtype=torch.uint8, device=mag.device)
    # idx counts crossed midpoints; a tie at the midpoint between codes j
    # and j+1 picks the even mantissa, i.e. crosses (>=) exactly when j+1
    # is even: 0.25->0.0, 0.75->1.0, 1.25->1.0, 2.5->2.0, 3.5->4.0
    for j in range(len(FP4_VALUES) - 1):
        mid = float(FP4_VALUES[j] + FP4_VALUES[j + 1]) / 2.0
        crossed = mag >= mid if (j + 1) % 2 == 0 else mag > mid
        idx += crossed.to(torch.uint8)
    idx = torch.where(torch.isfinite(mag), idx, len(FP4_VALUES) - 1)
    return (sign << 3) | idx.to(torch.uint8)


def _pack_nibbles(codes4: torch.Tensor) -> torch.Tensor:
    """uint8 codes (..., K, N) -> (..., K/2, N), low nibble = even k."""
    return codes4[..., 0::2, :] | (codes4[..., 1::2, :] << 4)


def _unpack_nibbles(codes: torch.Tensor, lead, k: int, n: int) -> torch.Tensor:
    """Inverse of ``_pack_nibbles`` through the E2M1 table: f32 (..., K, N)."""
    lut = torch.as_tensor(FP4_LUT, device=codes.device)
    lo = lut[(codes & 0xF).long()]
    hi = lut[(codes >> 4).long()]
    return torch.stack([lo, hi], dim=-2).reshape(*lead, k, n)


def _block_scale(exps: torch.Tensor, block: int) -> torch.Tensor:
    """Per-block exponents (..., K/block, N) -> per-row powers (..., K, N)."""
    return torch.repeat_interleave(_pow2(exps), block, dim=-2)


class _Packed:
    """Shared behaviour of the packed classes: the tensor fields in
    declaration order, the logical ``shape`` last."""

    def tensors(self) -> tuple:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self)
                     if f.name != "shape")

    def map(self, fn):
        """The same packed tensor with ``fn`` applied to every tensor field
        (``p.map(lambda t: t.to("cuda"))``)."""
        return type(self)(*(fn(t) for t in self.tensors()), self.shape)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())


# ---------------------------------------------------------------------------
# MXFP4
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedMXFP4(_Packed):
    """MXFP4-packed tensor, blocks along the original K axis.  ``shape`` is
    the logical unpacked shape."""

    codes: torch.Tensor    # uint8 [..., K/2, N] (packed pairs along K)
    scales: torch.Tensor   # uint8 [..., K/32, N] biased exponents
    shape: tuple           # logical (..., K, N)


def _blocks(w: torch.Tensor, block: int):
    *lead, k, n = w.shape
    assert k % block == 0, f"K={k} must be a multiple of {block}"
    x = w.to(torch.float32).reshape(*lead, k // block, block, n)
    return lead, k, n, x, x.abs().amax(dim=-2, keepdim=True)


def quantize_mxfp4(w: torch.Tensor) -> PackedMXFP4:
    """Quantize ``w`` (..., K, N) to MXFP4 with blocks along K (axis -2)."""
    lead, k, n, x, amax = _blocks(w, MX_BLOCK)
    e = _e8m0_scale_exp(amax, 2.0)
    codes4 = _quantize_fp4_codes(x * _pow2(-e)).reshape(*lead, k, n)
    scales = _sat_cast(e[..., 0, :] + _E8M0_BIAS, torch.uint8)
    return PackedMXFP4(_pack_nibbles(codes4), scales, tuple(w.shape))


def dequantize_mxfp4(p: PackedMXFP4, dtype=torch.bfloat16) -> torch.Tensor:
    """The plain stream decoder: unpack to ``dtype``."""
    *lead, k, n = p.shape
    vals = _unpack_nibbles(p.codes, lead, k, n)
    e = p.scales.to(torch.float32) - _E8M0_BIAS
    return (vals * _block_scale(e, MX_BLOCK)).to(dtype)


# ---------------------------------------------------------------------------
# MXFP8 (E4M3 elements)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedMXFP8(_Packed):
    codes: torch.Tensor    # float8_e4m3fn [..., K, N]
    scales: torch.Tensor   # uint8 [..., K/32, N]
    shape: tuple


def quantize_mxfp8(w: torch.Tensor) -> PackedMXFP8:
    lead, k, n, x, amax = _blocks(w, MX_BLOCK)
    e = _e8m0_scale_exp(amax, 8.0)    # E4M3 emax = 8 (448 = 1.75*2^8)
    # saturate to the E4M3 range before casting (the cast NaNs on overflow)
    scaled = torch.clamp(x * _pow2(-e), -448.0, 448.0)
    codes = scaled.to(torch.float8_e4m3fn).reshape(*lead, k, n)
    scales = _sat_cast(e[..., 0, :] + _E8M0_BIAS, torch.uint8)
    return PackedMXFP8(codes, scales, tuple(w.shape))


def dequantize_mxfp8(p: PackedMXFP8, dtype=torch.bfloat16) -> torch.Tensor:
    e = p.scales.to(torch.float32) - _E8M0_BIAS
    return (p.codes.to(torch.float32) * _block_scale(e, MX_BLOCK)).to(dtype)


# ---------------------------------------------------------------------------
# BFP16 (shared-exponent int8 mantissas)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedBFP(_Packed):
    mantissas: torch.Tensor  # int8 [..., K, N]
    exponents: torch.Tensor  # int8 [..., K/16, N] unbiased shared exponents
    shape: tuple


def quantize_bfp(w: torch.Tensor) -> PackedBFP:
    lead, k, n, x, amax = _blocks(w, BFP_BLOCK)
    # mantissa in [-127, 127]: value = m * 2^(e - 7)  with amax -> ~127
    # (a tensor divisor: CUDA divides by a Python scalar through its
    # rounded reciprocal, which is not always amax / 127)
    y = amax / amax.new_tensor(127.0) + 1e-45
    e = torch.where(amax > 0, _ceil_log2(y) + 7.0, 0.0)
    m = torch.clamp(torch.round(x * _pow2(-(e - 7.0))), -127, 127)
    mant = _sat_cast(m.reshape(*lead, k, n), torch.int8)
    exps = _sat_cast(e[..., 0, :], torch.int8)
    return PackedBFP(mant, exps, tuple(w.shape))


def dequantize_bfp(p: PackedBFP, dtype=torch.bfloat16) -> torch.Tensor:
    e = p.exponents.to(torch.float32)
    scale = _block_scale(e - 7.0, BFP_BLOCK)
    return (p.mantissas.to(torch.float32) * scale).to(dtype)


# ---------------------------------------------------------------------------
# NXFP4: MXFP4 + per-8-element 1-bit micro-exponent
# ---------------------------------------------------------------------------


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack {0,1} uint8 [..., M, N] into uint8 [..., ceil(M/8), N]
    (bit b of byte i holds entry 8*i + b; zero-padded tail)."""
    *lead, m, n = bits.shape
    pad = (-m) % 8
    if pad:
        bits = torch.cat([bits, bits.new_zeros((*lead, pad, n))], dim=-2)
    b = bits.reshape(*lead, -1, 8, n).to(torch.int32)
    weights = (1 << torch.arange(8, dtype=torch.int32,
                                 device=bits.device))[:, None]
    return (b * weights).sum(dim=-2).to(torch.uint8)


def _unpack_bits(packed: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse of ``_pack_bits``: uint8 [..., ceil(M/8), N] -> [..., M, N]."""
    *lead, _, n = packed.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)[:, None]
    bits = (packed[..., :, None, :] >> shifts) & 1
    return bits.reshape(*lead, -1, n)[..., :m, :]


@dataclasses.dataclass
class PackedNXFP4(_Packed):
    codes: torch.Tensor     # uint8 [..., K/2, N]
    scales: torch.Tensor    # uint8 [..., K/32, N]
    micro: torch.Tensor     # uint8 [..., ceil(K/8/8), N] bit-packed micro-exps
    shape: tuple


def quantize_nxfp4(w: torch.Tensor) -> PackedNXFP4:
    lead, k, n, x, amax = _blocks(w, MX_BLOCK)
    e = _e8m0_scale_exp(amax, 2.0)
    # sub-blocks of 8: if the sub-block max is < half the block max, shift
    # the local grid down one exponent step (micro-exponent = 1).
    xs = x.reshape(*lead, k // MX_BLOCK, MX_BLOCK // NX_SUB, NX_SUB, n)
    sub_amax = xs.abs().amax(dim=-2, keepdim=True)
    e_sub = e[..., None, :, :]
    micro = (sub_amax * 2.0 <= _pow2(e_sub) * _FP4_MAX).to(torch.float32)
    codes4 = _quantize_fp4_codes(xs * _pow2(-(e_sub - micro)))
    codes4 = codes4.reshape(*lead, k, n)
    scales = _sat_cast(e[..., 0, :] + _E8M0_BIAS, torch.uint8)
    micro_u8 = micro[..., 0, :].reshape(*lead, k // NX_SUB, n).to(torch.uint8)
    return PackedNXFP4(_pack_nibbles(codes4), scales, _pack_bits(micro_u8),
                       tuple(w.shape))


def dequantize_nxfp4(p: PackedNXFP4, dtype=torch.bfloat16) -> torch.Tensor:
    *lead, k, n = p.shape
    vals = _unpack_nibbles(p.codes, lead, k, n)
    e = p.scales.to(torch.float32) - _E8M0_BIAS
    micro_bits = _unpack_bits(p.micro, k // NX_SUB).to(torch.float32)
    micro = torch.repeat_interleave(_pow2(-micro_bits), NX_SUB, dim=-2)
    return (vals * _block_scale(e, MX_BLOCK) * micro).to(dtype)


# ---------------------------------------------------------------------------
# Registry — the software stream decoder
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FormatSpec:
    """One quantized format: the single source of truth every derived
    value (``bits_per_element``, byte accounting) reads."""

    quantize: callable
    dequantize: callable
    packed_cls: type
    block: int            # elements sharing one scale along K
    bits: float           # average storage bits/element incl. scales


_CANONICAL = {
    "mxfp4": FormatSpec(quantize_mxfp4, dequantize_mxfp4, PackedMXFP4,
                        MX_BLOCK, 4 + 8.0 / MX_BLOCK),
    "mxfp8": FormatSpec(quantize_mxfp8, dequantize_mxfp8, PackedMXFP8,
                        MX_BLOCK, 8 + 8.0 / MX_BLOCK),
    "bfp": FormatSpec(quantize_bfp, dequantize_bfp, PackedBFP,
                      BFP_BLOCK, 8 + 8.0 / BFP_BLOCK),
    "nxfp4": FormatSpec(quantize_nxfp4, dequantize_nxfp4, PackedNXFP4,
                        MX_BLOCK, 4 + 8.0 / MX_BLOCK + 8.0 / NX_SUB / 8),
}
_ALIASES = {"bfp16": "bfp"}      # alias: 16-elem BFP blocks

PACKED_TYPES = tuple(s.packed_cls for s in _CANONICAL.values())
_FORMAT_BY_TYPE = {s.packed_cls: name for name, s in _CANONICAL.items()}


def canonical_format(fmt: str) -> str:
    """Resolve aliases (``bfp16`` -> ``bfp``); KeyError on unknown names."""
    fmt = _ALIASES.get(fmt, fmt)
    if fmt not in _CANONICAL:
        raise KeyError(f"unknown quantized format {fmt!r}; "
                       f"know {sorted([*_CANONICAL, *_ALIASES])}")
    return fmt


def format_spec(fmt: str) -> FormatSpec:
    return _CANONICAL[canonical_format(fmt)]


def quantize(w: torch.Tensor, fmt: str):
    return format_spec(fmt).quantize(w)


def dequantize(p, fmt: str, dtype=torch.bfloat16) -> torch.Tensor:
    return format_spec(fmt).dequantize(p, dtype)


def dequantize_any(p, dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize any packed tensor, dispatching on its type."""
    return _CANONICAL[_FORMAT_BY_TYPE[type(p)]].dequantize(p, dtype)


def bits_per_element(fmt: str) -> float:
    """Average storage bits/element including scale overheads."""
    return format_spec(fmt).bits


def packed_nbytes(shape, fmt: str) -> int:
    """Exact bytes ``quantize(w, fmt)`` allocates for a ``shape`` weight
    (scale/micro metadata included) — the budget==execution invariant."""
    *lead, k, n = shape
    spec = format_spec(fmt)
    cols = math.prod(lead) * n
    per_col = {
        "mxfp4": k // 2 + k // MX_BLOCK,
        "mxfp8": k + k // MX_BLOCK,
        "bfp": k + k // BFP_BLOCK,
        "nxfp4": k // 2 + k // MX_BLOCK + -(-(k // NX_SUB) // 8),
    }[canonical_format(fmt)]
    assert k % spec.block == 0, f"K={k} not a multiple of {spec.block}"
    return per_col * cols
