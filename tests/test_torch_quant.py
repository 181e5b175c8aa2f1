"""The port's quantization against the JAX reference's, bit for bit: the
four block weight formats (``quant/formats.py``), the fp8/int8 KV codes
(``quant/kv.py``) and model quantization (``quant/linear.py``), plus the
weight bridge for quantized pytrees.

One known deviation of the reference is isolated rather than copied: on
this CPU ``jnp.exp2`` of an integer is not an exact power of two outside
about [-14, 12] (off by up to 4e-6 relative) and ``jnp.log2`` of an exact
power of two misses the integer at k in {±13, ±15, ±26, ...}.  The port
builds exponents exactly (``frexp``, bit-assembled powers of two).  So the
port is held bitwise to the unmodified reference on f32 weights (whose
midpoint ties the inexact scaling cannot reach) and dequantization to
bf16 (which absorbs it), and bitwise everywhere to the reference run with
exact ``exp2``/``log2`` swapped in."""
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp
import ml_dtypes

from repro.configs import get_config, reduced_config
from repro.models.model import build_model
from repro.quant import formats as jformats
from repro.quant import kv as jkv
from repro.quant.linear import quantize_params as jquantize_params
from repro.quant.linear import serve_weight_bytes as jserve_weight_bytes
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.quant import formats, kv
from repro_torch.quant.linear import (
    is_packed, packed_leaves, quantize_params, serve_weight_bytes,
)

FORMATS = ["mxfp4", "mxfp8", "bfp", "nxfp4"]


def _weights(seed: int, nan_block: bool = True) -> np.ndarray:
    """(256, 48) f32 weights: columns at scales 2^-8..2^3, blocks whose
    amax is exactly 2^k for k in -20..12, a zero block, +-inf blocks and
    (optionally) a NaN block."""
    rng = np.random.default_rng(seed)
    k, n = 256, 48
    w = (rng.standard_normal((k, n))
         * np.exp2(rng.integers(-8, 4, (1, n)))).astype(np.float32)
    for j, e in enumerate(range(-20, 13)):
        blk = j % (k // 32)
        w[blk * 32:(blk + 1) * 32, j] = rng.uniform(-1, 1, 32) * 2.0 ** e
        w[blk * 32 + 3, j] = 2.0 ** e
    w[:32, 40] = 0.0
    w[32:64, 41] = np.inf
    w[64:96, 42] = -np.inf
    w[70, 42] = 1.0
    if nan_block:
        w[96:128, 43] = np.nan
        w[100, 43] = 2.0
    return w


def _bits(a) -> np.ndarray:
    """Raw bits of a numpy/jax array or torch tensor (NaN-safe compare)."""
    if isinstance(a, torch.Tensor):
        a = kv.raw_view(a)
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _compare(w: np.ndarray, in_dtype: str, fmt: str, out_dtypes) -> None:
    jw = jnp.asarray(w.astype(ml_dtypes.bfloat16 if in_dtype == "bfloat16"
                              else np.float32))
    tw = torch.from_numpy(w).to(getattr(torch, in_dtype))
    jp = jformats.quantize(jw, fmt)
    tp = formats.quantize(tw, fmt)
    assert type(tp).__name__ == type(jp).__name__
    assert tp.shape == tuple(jp.shape)
    for a, b in zip(jp.tree_flatten()[0], tp.tensors()):
        np.testing.assert_array_equal(_bits(b), _bits(a))
    for jd, td in out_dtypes:       # values; NaN == NaN whatever its bits
        np.testing.assert_array_equal(
            formats.dequantize(tp, fmt, td).float().numpy(),
            np.asarray(jformats.dequantize(jp, fmt, jd), np.float32))


@pytest.mark.parametrize("fmt", FORMATS)
def test_formats_bitwise_vs_reference_f32(fmt):
    """Codes and scales equal the unmodified reference's bits, and the bf16
    dequantization its values (NaN for NaN), on f32 weights with
    non-finite blocks."""
    _compare(_weights(0), "float32", fmt, [(jnp.bfloat16, torch.bfloat16)])


@pytest.fixture
def exact_jax_exponents(monkeypatch):
    """The reference with exact jnp.exp2 (integral arguments) and
    jnp.log2 (exact powers of two) swapped in for this test."""
    real_exp2, real_log2 = jnp.exp2, jnp.log2

    def exp2(e):
        e = jnp.asarray(e, jnp.float32)
        fin = jnp.isfinite(e) & (e == jnp.round(e))
        ei = jnp.where(fin, e, 0).astype(jnp.int32)
        return jnp.where(fin, jnp.ldexp(jnp.float32(1), ei), real_exp2(e))

    def log2(x):
        x = jnp.asarray(x, jnp.float32)
        m, ex = jnp.frexp(x)
        exact = jnp.isfinite(x) & (x > 0) & (m == 0.5)
        return jnp.where(exact, (ex - 1).astype(jnp.float32), real_log2(x))

    monkeypatch.setattr(jnp, "exp2", exp2)
    monkeypatch.setattr(jnp, "log2", log2)


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_formats_bitwise_vs_reference_exact_exponents(
        exact_jax_exponents, fmt, in_dtype):
    """With exact exponents on the reference's side every code, scale and
    dequantized value (bf16 and f32) is equal, bf16 weights included.
    XLA reduces a bf16 NaN block in its own way, so the bf16 case has no
    NaN block."""
    w = _weights(1, nan_block=in_dtype == "float32")
    _compare(w, in_dtype, fmt, [(jnp.bfloat16, torch.bfloat16),
                                (jnp.float32, torch.float32)])


def test_fp4_rne_midpoints_and_nonfinite():
    """Every E2M1 midpoint rounds to the even mantissa, both signs, through
    ``quantize_mxfp4`` (a block with amax 6 has scale 1, so the midpoints
    are met exactly); inf/-inf/NaN saturate to +-6."""
    mids = [0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0]
    want = [0.0, 1.0, 1.0, 2.0, 2.0, 4.0, 4.0]
    col = np.array([6.0] + mids + [-m for m in mids]
                   + [np.inf, -np.inf, np.nan] + [0.0] * 14, np.float32)
    p = formats.quantize_mxfp4(torch.from_numpy(col[:, None].copy()))
    assert p.scales.item() == 127
    deq = formats.dequantize_mxfp4(p, torch.float32)[:, 0].numpy()
    np.testing.assert_array_equal(deq[1:15], want + [-x for x in want])
    np.testing.assert_array_equal(deq[15:17], [6.0, -6.0])
    codes = formats._quantize_fp4_codes(torch.from_numpy(col))
    jcodes = jformats._quantize_fp4_codes(jnp.asarray(col))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))


def test_pow2_and_exponents_exact():
    e = np.arange(-160, 140)
    got = formats._pow2(torch.from_numpy(e.astype(np.float32))).numpy()
    with np.errstate(over="ignore"):               # 2^128 and up -> inf
        want = np.array([np.ldexp(1.0, int(i)) for i in e]).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    k = np.arange(-140, 128)
    a = torch.from_numpy(np.ldexp(1.0, k).astype(np.float32))
    np.testing.assert_array_equal(formats._floor_log2(a).numpy(), k)
    np.testing.assert_array_equal(formats._floor_log2(a * 1.5).numpy(), k)
    np.testing.assert_array_equal(formats._ceil_log2(a).numpy(), k)
    np.testing.assert_array_equal(formats._ceil_log2(a * 1.5).numpy(), k + 1)


def test_packed_nbytes_and_registry():
    for fmt in FORMATS + ["bfp16"]:
        p = formats.quantize(torch.randn(96, 40), fmt)
        assert p.nbytes == formats.packed_nbytes((96, 40), fmt) \
            == jformats.packed_nbytes((96, 40), fmt)
        assert formats.bits_per_element(fmt) == jformats.bits_per_element(fmt)
        assert formats.dequantize_any(p).shape == (96, 40)
    with pytest.raises(KeyError):
        formats.canonical_format("fp4")


@pytest.mark.parametrize("cache_dtype", ["fp8", "int8"])
def test_kv_quantize_bitwise_vs_reference(cache_dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((6, 5, 2, 16)) * 3.0).astype(np.float32)
    x[0, 0] = 0.0                                 # all-zero head vectors
    x[1, 1, 0, 3] = 1e6                           # one large outlier
    codes, scales = kv.kv_quantize(torch.from_numpy(x), cache_dtype)
    jcodes, jscales = jkv.kv_quantize(jnp.asarray(x), cache_dtype)
    assert codes.dtype == kv.cache_storage_dtype(cache_dtype)
    np.testing.assert_array_equal(_bits(codes), _bits(jcodes))
    np.testing.assert_array_equal(_bits(scales), _bits(jscales))
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            _bits(kv.kv_dequantize(codes, scales, td)),
            _bits(jkv.kv_dequantize(jcodes, jscales, jd)))


def test_cache_dtype_validation():
    assert kv.is_quantized_cache_dtype("fp8")
    assert not kv.is_quantized_cache_dtype(torch.bfloat16)
    assert kv.cache_storage_dtype(torch.float32) == torch.float32
    with pytest.raises(ValueError, match="cache_dtype"):
        kv.validate_cache_dtype("fp4")


# ---------------------------------------------------------------------------
# model quantization and the bridge
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reduced():
    cfg = reduced_config(get_config("qwen3-14b"))
    params = build_model(cfg).init(jax.random.PRNGKey(5))
    tcfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-14b"))
    return params, tcfg


def test_quantize_params_packs_seven_leaves_per_layer(reduced):
    params, tcfg = reduced
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    before = {n: p.clone() for n, p in model.named_parameters()}
    view = quantize_params(model, "mxfp4")
    names = [n for n, _ in packed_leaves(view)]
    assert len(names) == 7 * tcfg.n_layers
    assert {n.split(".")[-1] for n in names} == {
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
    assert all(isinstance(w, formats.PackedMXFP4)
               for _, w in packed_leaves(view))
    # the caller's model is untouched; every unquantized tensor is shared
    assert not list(packed_leaves(model))
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n])
    shared = dict(view.named_parameters())
    assert shared and all(shared[n] is p for n, p in model.named_parameters()
                          if n in shared)
    assert view.param_count() == model.param_count()
    assert is_packed(view.layers[0].attn.wq)


@pytest.mark.parametrize("fmt", [None] + FORMATS)
def test_serve_weight_bytes_match_reference(reduced, fmt):
    params, tcfg = reduced
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                            device="cpu")
    want = jserve_weight_bytes(params, fmt)
    assert serve_weight_bytes(model, fmt) == want
    if fmt is not None:          # what the view really allocates
        view = quantize_params(model, fmt)
        allocated = (sum(p.numel() * p.element_size()
                         for p in view.parameters())
                     + sum(w.nbytes for _, w in packed_leaves(view)))
        assert allocated == want


@pytest.mark.parametrize("fmt", FORMATS)
def test_bridge_carries_packed_params_bit_identically(reduced, fmt):
    """JAX's packed params through the bridge == the port's own
    quantize_params of the bridged dense params, leaf for leaf."""
    params, tcfg = reduced
    np_q = jax.tree.map(np.asarray, jquantize_params(params, fmt))
    bridged = params_from_jax(np_q, tcfg, device="cpu")
    own = quantize_params(params_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg, device="cpu"), fmt)
    got, want = dict(packed_leaves(bridged)), dict(packed_leaves(own))
    assert sorted(got) == sorted(want) and len(got) == 7 * tcfg.n_layers
    for name, w in want.items():
        assert type(got[name]) is type(w) and got[name].shape == w.shape
        for a, b in zip(got[name].tensors(), w.tensors()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(_bits(a), _bits(b))
    for (n1, p1), (n2, p2) in zip(bridged.named_parameters(),
                                  own.named_parameters()):
        assert n1 == n2 and torch.equal(p1, p2)
