"""The MXFP4 VMM: the port's plain version against the JAX reference's
oracle and its Pallas kernel (interpret mode), the group op (several
weights that read one x) against the per-weight op and the JAX op, the op
wrapper's dispatch and bf16 activation cast, the CUDA wrapper's host-side
schedule (stream-K split of the (tile, K stage) units, the fold's
contributors, the decode / wgmma crossover), and — where there is a card
— the CUDA kernel against the plain version.

Tolerance: 1e-5 of the output's largest magnitude.  Both sides multiply
the same bf16 operands exactly in f32 and differ only in the order of
the f32 sums."""
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax.numpy as jnp
import ml_dtypes

from repro.kernels.mxfp4_vmm.kernel import mxfp4_vmm as pallas_vmm
from repro.kernels.mxfp4_vmm.ops import mxfp4_matmul as jax_matmul
from repro.kernels.mxfp4_vmm.ref import mxfp4_vmm_ref as jax_ref
from repro.quant import formats as jformats
from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
from repro_torch.kernels.mxfp4_vmm import kernel as vmm_kernel
from repro_torch.kernels.mxfp4_vmm.ops import (
    mxfp4_matmul, mxfp4_matmul_group, mxfp4_tileable,
)
from repro_torch.kernels.mxfp4_vmm.ref import mxfp4_vmm_ref
from repro_torch.quant import formats
from repro_torch.quant.linear import qdot, qdot_group

RTOL = 1e-5


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def _case(seed, m, k, n, x_dtype=ml_dtypes.bfloat16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(x_dtype)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    jp = jformats.quantize_mxfp4(jnp.asarray(w))
    codes, scales = np.array(jp.codes), np.array(jp.scales)   # writable
    return x, codes, scales


def _tx(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x)


# the shapes and tiles of tests/test_kernels.py::test_mxfp4_vmm_shapes
@pytest.mark.parametrize("b,k,n,bk,bn", [
    (1, 128, 256, 64, 128),
    (4, 512, 512, 512, 256),
    (8, 1024, 384, 256, 128),
    (16, 256, 1024, 128, 512),
    (3, 160, 128, 32, 64),
])
def test_ref_matches_jax_oracle_and_pallas(b, k, n, bk, bn):
    x, codes, scales = _case(b * 1000 + k + n, b, k, n)
    got = mxfp4_vmm_ref(_tx(x), torch.from_numpy(codes),
                        torch.from_numpy(scales))
    assert got.dtype == torch.float32 and got.shape == (b, n)
    jargs = (jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scales))
    assert _rel_err(got, jax_ref(*jargs)) <= RTOL
    assert _rel_err(got, pallas_vmm(*jargs, block_n=bn, block_k=bk,
                                    interpret=True)) <= RTOL


@pytest.mark.parametrize("m,k,n", [(1, 96, 100), (5, 544, 8), (37, 64, 333)])
def test_ragged_shapes_match_jax(m, k, n):
    """M = 1, ragged M and N, K a multiple of 32 only: shapes the Pallas
    kernel does not tile (the reference's oracle fallback covers them)."""
    x, codes, scales = _case(m + k + n, m, k, n)
    got = mxfp4_matmul(_tx(x), formats.PackedMXFP4(
        torch.from_numpy(codes), torch.from_numpy(scales), (k, n)),
        out_dtype=torch.float32)
    want = jax_matmul(jnp.asarray(x), jformats.PackedMXFP4(
        jnp.asarray(codes), jnp.asarray(scales), (k, n)),
        out_dtype=jnp.float32)
    assert _rel_err(got, want) <= RTOL
    assert mxfp4_tileable(k, n)


def test_f32_activations_cast_to_bf16_like_the_reference():
    """f32 x is rounded to bf16 before the product and the result comes
    back in x's dtype (``qdot``: out_dtype = x.dtype), as in the
    reference; without the cast the result would differ at ~1e-3."""
    x, codes, scales = _case(9, 6, 256, 64, np.float32)
    jw = jformats.PackedMXFP4(jnp.asarray(codes), jnp.asarray(scales),
                              (256, 64))
    tw = formats.PackedMXFP4(torch.from_numpy(codes),
                             torch.from_numpy(scales), (256, 64))
    got = qdot(torch.from_numpy(x)[None], tw)
    want = np.asarray(jax_matmul(jnp.asarray(x)[None], jw,
                                 out_dtype=jnp.float32))
    assert got.dtype == torch.float32 and got.shape == (1, 6, 64)
    assert _rel_err(got, want) <= RTOL
    exact = x @ np.asarray(formats.dequantize_mxfp4(tw, torch.float32))
    assert _rel_err(got[0], exact) > 1e-4          # the cast did happen


def _packed(codes, scales):
    k, n = 2 * codes.shape[0], codes.shape[1]
    return (formats.PackedMXFP4(torch.from_numpy(codes),
                                torch.from_numpy(scales), (k, n)),
            jformats.PackedMXFP4(jnp.asarray(codes), jnp.asarray(scales),
                                 (k, n)))


# a qkv-shaped triple (GQA: N 64, 16, 16), a gate/up pair, ragged N, and
# one weight; f32 x is cast to bf16 as in the per-weight op
@pytest.mark.parametrize("m,k,ns,x_dtype", [
    (5, 128, (64, 16, 16), ml_dtypes.bfloat16),
    (3, 256, (48, 48), ml_dtypes.bfloat16),
    (7, 96, (100, 33, 5), ml_dtypes.bfloat16),
    (1, 64, (40,), ml_dtypes.bfloat16),
    (6, 160, (64, 16, 16), np.float32),
])
def test_group_matches_per_weight_and_jax(m, k, ns, x_dtype):
    """The group op's plain path (one kernel launch on a card) equals the
    per-weight op bit for bit and the JAX op per weight within RTOL."""
    rng = np.random.default_rng(m * 100 + k + sum(ns))
    x = rng.standard_normal((2, m, k)).astype(x_dtype)
    ws = []
    for i, n in enumerate(ns):
        _, codes, scales = _case(1000 * i + n + k, 1, k, n)
        ws.append(_packed(codes, scales))
    out_dtype = torch.float32 if x_dtype == np.float32 else torch.bfloat16
    got = mxfp4_matmul_group(_tx(x), [t for t, _ in ws], out_dtype=out_dtype)
    assert len(got) == len(ns)
    for o, (tw, jw), n in zip(got, ws, ns):
        assert o.shape == (2, m, n) and o.dtype == out_dtype
        assert torch.equal(o, mxfp4_matmul(_tx(x), tw, out_dtype=out_dtype))
        want = jax_matmul(jnp.asarray(x), jw, out_dtype=jnp.float32)
        assert _rel_err(o.float(), want) <= (
            RTOL if out_dtype == torch.float32 else 2.0 ** -8)
    # qdot_group: the same outputs in x's dtype, as qdot gives them
    for o, (tw, _) in zip(qdot_group(_tx(x), [t for t, _ in ws]), ws):
        assert torch.equal(o, qdot(_tx(x), tw))


def test_group_shape_and_mixed_format_rules():
    _, c1, s1 = _case(1, 1, 64, 32)
    _, c2, s2 = _case(2, 1, 128, 32)
    w1, _ = _packed(c1, s1)
    w2, _ = _packed(c2, s2)
    x = torch.randn(3, 64)
    with pytest.raises(ValueError, match="share K"):
        mxfp4_matmul_group(x, [w1, w2])
    with pytest.raises(ValueError, match="1..3"):
        mxfp4_matmul_group(x, [w1] * 4)
    # a plain or other-format weight in the group: qdot per weight
    dense = torch.randn(64, 8)
    other = formats.quantize(torch.randn(64, 8) * 0.1, "mxfp8")
    got = qdot_group(x, [w1, dense, other])
    for o, w in zip(got, [w1, dense, other]):
        assert torch.equal(o, qdot(x, w))


def test_dispatch_on_cpu():
    x, codes, scales = _case(3, 4, 128, 64)
    w = formats.PackedMXFP4(torch.from_numpy(codes),
                            torch.from_numpy(scales), (128, 64))
    before = LAUNCHES[vmm_kernel.NAME]
    variants = dict(VARIANT_LAUNCHES)
    auto = mxfp4_matmul(_tx(x), w)
    ref = mxfp4_matmul(_tx(x), w, impl="reference")
    assert torch.equal(auto, ref) and auto.dtype == torch.bfloat16
    mxfp4_matmul_group(_tx(x), [w, w])
    assert LAUNCHES[vmm_kernel.NAME] == before        # no kernel on CPU
    assert dict(VARIANT_LAUNCHES) == variants
    with pytest.raises(ValueError, match="CUDA"):
        mxfp4_matmul(_tx(x), w, impl="fused")
    with pytest.raises(ValueError, match="CUDA"):
        mxfp4_matmul_group(_tx(x), [w, w], impl="fused")
    with pytest.raises(ValueError):
        mxfp4_matmul(_tx(x), w, impl="nope")
    with pytest.raises(ValueError, match="CUDA"):
        vmm_kernel.mxfp4_vmm(_tx(x), w.codes, w.scales)
    with pytest.raises(ValueError, match="CUDA"):
        vmm_kernel.mxfp4_vmm_group(_tx(x), [(w.codes, w.scales)] * 2)


@pytest.mark.parametrize("fmt", ["mxfp8", "bfp", "nxfp4"])
def test_qdot_other_formats_dequantize_then_matmul(fmt):
    x = torch.randn(3, 64)
    w = torch.randn(64, 48) * 0.1
    p = formats.quantize(w, fmt)
    got = qdot(x, p)
    torch.testing.assert_close(got, x @ formats.dequantize(p, fmt,
                                                           torch.float32),
                               rtol=0, atol=0)
    assert torch.equal(qdot(x, w), x @ w)


def _cases(*cases):
    """pytest params (m, k, ns) with ids m-k-n (one weight) or
    m-k-n1+n2+... (a group)."""
    return [pytest.param(m, k, ns, id=f"{m}-{k}-{'+'.join(map(str, ns))}")
            for m, k, ns in cases]


@pytest.mark.parametrize("m,k,ns", _cases(
    (1, 4096, (4096,)), (8, 4096, (1024,)), (8, 14336, (4096,)),
    (256, 4096, (14336,)), (2048, 4096, (1024,)), (37, 544, (1000,)),
    (3, 32, (5,)), (8, 4096, (4096, 1024, 1024)), (8, 4096, (14336, 14336)),
    (16, 4096, (1024,)), (32, 544, (1000,)), (33, 4096, (4096,)),
    (1000, 4096, (4096, 1024, 1024))))
def test_split_k_covers_k_without_empty_splits(m, k, ns):
    """The host-side schedule the CUDA wrapper hands the kernel (the
    source computes the same ranges): every (output tile, K stage) unit
    belongs to exactly one CTA's piece, no CTA's range is empty, the pieces
    of a split tile are held by the CTAs the fold walks, each in its own
    workspace slot, the tile counters cover every tile, and the schedule
    follows the M crossover."""
    sms = 132
    sc = vmm_kernel.schedule(m, k, ns, sms)
    assert sc.variant == ("decode" if m <= vmm_kernel.DECODE_MAX_M
                          else "wgmma")
    assert (sc.bm >= m if sc.variant == "decode"
            else sc.bm == vmm_kernel.WGMMA_BM)
    assert sc.m_tiles * sc.bm >= m
    assert sc.stages * sc.stage_k >= k > (sc.stages - 1) * sc.stage_k
    assert all(s * vmm_kernel.BLOCK_N >= n for s, n in zip(sc.stripes, ns))
    per_sm = (vmm_kernel.DECODE_CTAS_PER_SM if sc.variant == "decode"
              else 1)
    want = sc.units // vmm_kernel.MIN_UNITS[sc.variant]
    assert sc.grid == max(1, min(want, per_sm * sms))
    seen = np.zeros((sc.tiles, sc.stages), np.int32)
    holders: dict[int, list] = {}
    for c in range(sc.grid):
        lo, hi = sc.cta_range(c)
        assert hi - lo >= min(sc.units, vmm_kernel.MIN_UNITS[sc.variant])
        assert all(sc.cta_of(u) == c for u in (lo, hi - 1))
        slots = []
        for tile, a, b, slot in sc.pieces(c):
            assert 0 <= a < b <= sc.stages
            seen[tile, a:b] += 1
            if slot < 0:
                assert (a, b) == (0, sc.stages)
                assert list(sc.contributors(tile)) == [c]
            else:
                slots.append(slot)
                holders.setdefault(tile, []).append((c, slot))
        assert len(slots) == len(set(slots)) <= 2
    assert (seen == 1).all()
    for tile, held in holders.items():           # the fold's view
        assert [c for c, _ in held] == list(sc.contributors(tile))
        t_lo = tile * sc.stages
        assert all(slot == int(sc.cta_range(c)[0] < t_lo)
                   for c, slot in held)
    # the counters and workspace the wrapper allocates cover the launch
    cnt, ws = vmm_kernel._COUNTERS, vmm_kernel._WORKSPACE
    vmm_kernel._scratch(torch.device("cpu"), sc)
    try:
        assert cnt[None].numel() >= sc.tiles
        assert not cnt[None].any()
        assert ws[None].numel() >= sc.workspace_floats
    finally:
        cnt.pop(None)
        ws.pop(None)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,ns", _cases(
    (1, 4096, (1024,)), (8, 4096, (4096,)), (256, 1024, (14336,)),
    (37, 544, (1000,)), (2048, 4096, (1024,)), (16, 4096, (64, 16, 16)),
    (300, 512, (4096, 1024, 1024)), (5, 544, (1000, 5))))
def test_cuda_kernel_matches_ref(m, k, ns):
    """The hand-written kernel, single and grouped launches and both
    schedules, against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ps = [formats.quantize_mxfp4(torch.randn((k, n), generator=gen,
                                             device="cuda") * 0.02)
          for n in ns]
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    ws = [(p.codes, p.scales) for p in ps]
    out = vmm_kernel.mxfp4_vmm_group(x, ws)
    out16 = vmm_kernel.mxfp4_vmm_group(x, ws, torch.bfloat16)
    for o, o16, p in zip(out, out16, ps):
        ref = mxfp4_vmm_ref(x, p.codes, p.scales)
        torch.cuda.synchronize()
        assert ((o - ref).abs().max() / ref.abs().max()).item() <= RTOL
        assert torch.equal(o16, o.to(torch.bfloat16))     # one rounding
    if len(ns) == 1:
        single = vmm_kernel.mxfp4_vmm(x, ps[0].codes, ps[0].scales)
        assert torch.equal(single, out[0])
