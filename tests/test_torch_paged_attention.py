"""Paged decode attention: the port's plain version against the JAX
reference's oracle and its Pallas kernel (online accumulator, interpret
mode), over dense pools and over fp8/int8 code pools with per-token scale
pools, the chunked-prefill multi-token attention over code pools, plus
the op wrapper's dispatch rules and the kernel wrapper's pure-Python
routing (variant, split count, counter arrays).  The tensor-core kernel's
arithmetic (codes to bf16, the K scale after the product, the V scale
folded into P before its bf16 hi + lo split) is emulated in torch against
the card check's limit.  The tests marked ``cuda`` hold the CUDA kernels
against the plain version and run only where there is a card.

Tolerance 1e-5 absolute in f32, not bitwise: on jax 0.9 even the Pallas
interpret paths differ from the JAX oracle by up to ~1e-6 (ROADMAP
Queue 3), and the port sums in another order again."""
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels.ref)
import jax.numpy as jnp
import ml_dtypes

from repro.kernels.decode_attention.paged_kernel import (
    paged_decode_attention as jax_paged_kernel,
)
from repro.kernels.decode_attention.ops import (
    paged_gqa_multi_attention as jax_multi,
)
from repro.kernels.decode_attention.ref import (
    paged_decode_attention_ref as jax_paged_ref,
)
from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
from repro_torch.kernels.decode_attention import ops, paged_kernel
from repro_torch.kernels.decode_attention.ref import (
    gather_pages, paged_decode_attention_ref, paged_valid_mask,
)
from repro_torch.quant.kv import kv_quantize


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5


def _case(seed, B, H, KVH, D, page, n_blocks, *, scratch_tail=False):
    """Random f32 pools (scratch page 0 poisoned), per-row permuted page
    tables, ragged mid-page positions.  With ``scratch_tail`` each row's
    table past its position points at the scratch page, as the engine's
    tables do."""
    rng = np.random.default_rng(seed)
    P = 1 + B * n_blocks
    ids = rng.permutation(np.arange(1, P))
    table = ids.reshape(B, n_blocks).astype(np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, KVH, D)).astype(np.float32)
    kp[0], vp[0] = 1e4, -1e4
    pos = rng.integers(0, page * n_blocks, B).astype(np.int32)
    pos[0] = page + page // 2                      # mid-page
    if scratch_tail:
        live = np.arange(n_blocks)[None, :] <= (pos // page)[:, None]
        table = np.where(live, table, 0).astype(np.int32)
    return q, kp, vp, table, pos


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


CASES = [
    # seed, B, H, KVH, D, page, n_blocks, scratch_tail, window
    (0, 3, 8, 2, 32, 8, 5, True, None),      # GQA 4:1, dead tail pages
    (1, 2, 16, 2, 64, 16, 3, True, None),    # GQA 8:1
    (2, 1, 4, 4, 16, 4, 7, False, None),     # MHA, many small pages
    (3, 3, 8, 2, 32, 8, 5, True, 5),         # sliding window
    (4, 2, 8, 2, 32, 8, 6, False, 11),       # window across pages
]


@pytest.mark.parametrize("seed,B,H,KVH,D,page,nb,tail,window", CASES)
def test_ref_matches_jax_oracle_and_pallas_kernel(seed, B, H, KVH, D, page,
                                                  nb, tail, window):
    q, kp, vp, table, pos = _case(seed, B, H, KVH, D, page, nb,
                                  scratch_tail=tail)
    got = paged_decode_attention_ref(*_torch(q, kp, vp, table, pos),
                                     window=window).numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, pos)]
    oracle = np.asarray(jax_paged_ref(*jargs, window=window))
    pallas = np.asarray(jax_paged_kernel(*jargs, window=window,
                                         accum="online", interpret=True))
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)


def test_gather_and_mask():
    q, kp, vp, table, pos = _case(5, 2, 4, 2, 16, 4, 3)
    kt, tt, pt = _torch(kp, table, pos)
    g = gather_pages(kt, tt)
    assert g.shape == (2, 12, 2, 16)
    np.testing.assert_array_equal(g[1, 4:8].numpy(), kp[table[1, 1]])
    m = paged_valid_mask(tt, 4, pt, window=3).numpy()
    idx = np.arange(12)[None, :]
    np.testing.assert_array_equal(
        m, (idx <= pos[:, None]) & (idx > pos[:, None] - 3))


def test_op_dispatch_on_cpu():
    q, kp, vp, table, pos = _torch(*_case(6, 2, 8, 2, 32, 8, 4))
    before = LAUNCHES["paged_decode_attention"]
    auto = ops.paged_gqa_decode_attention(q, kp, vp, table, pos)
    ref = ops.paged_gqa_decode_attention(q, kp, vp, table, pos,
                                         impl="reference")
    np.testing.assert_array_equal(auto.numpy(), ref.numpy())
    assert LAUNCHES["paged_decode_attention"] == before   # no kernel on CPU
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_gqa_decode_attention(q, kp, vp, table, pos, impl="fused")
    with pytest.raises(ValueError):
        ops.paged_gqa_decode_attention(q, kp, vp, table, pos, impl="nope")
    # code pools: the plain version with the scales, no kernel either
    kc, ks = kv_quantize(kp, "int8")
    vc, vs = kv_quantize(vp, "int8")
    auto = ops.paged_gqa_decode_attention(q, kc, vc, table, pos,
                                          k_scales=ks, v_scales=vs)
    ref = paged_decode_attention_ref(q, kc, vc, table, pos, k_scales=ks,
                                     v_scales=vs)
    np.testing.assert_array_equal(auto.numpy(), ref.numpy())
    assert LAUNCHES["paged_decode_attention_scaled"] == 0


def _quantized(q, kp, vp, cache_dtype):
    """Code pools written from the f32 pools, the scratch page's codes and
    scales poisoned."""
    kc, ks = kv_quantize(torch.from_numpy(kp), cache_dtype)
    vc, vs = kv_quantize(torch.from_numpy(vp), cache_dtype)
    ks[0], vs[0] = 1e4, -1e4
    return kc, vc, ks, vs


def _jax_codes(t: torch.Tensor):
    """A torch code/scale tensor as the same bits in a jax array."""
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy().view(
            ml_dtypes.float8_e4m3fn))
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("cache_dtype", ["fp8", "int8"])
@pytest.mark.parametrize("seed,B,H,KVH,D,page,nb,tail,window", CASES[:2] + CASES[3:])
def test_scaled_ref_matches_jax_oracle_and_pallas_kernel(
        cache_dtype, seed, B, H, KVH, D, page, nb, tail, window):
    """Code pools: the dequant (f32 cast, one multiply) then attention,
    against the reference's oracle and its Pallas online kernel's scale
    branch (interpret mode), within 1e-5."""
    q, kp, vp, table, pos = _case(seed, B, H, KVH, D, page, nb,
                                  scratch_tail=tail)
    kc, vc, ks, vs = _quantized(q, kp, vp, cache_dtype)
    got = paged_decode_attention_ref(
        torch.from_numpy(q), kc, vc, torch.from_numpy(table),
        torch.from_numpy(pos), k_scales=ks, v_scales=vs,
        window=window).numpy()
    jq, jt, jp = (jnp.asarray(a) for a in (q, table, pos))
    jkc, jvc, jks, jvs = (_jax_codes(t) for t in (kc, vc, ks, vs))
    oracle = np.asarray(jax_paged_ref(jq, jkc, jvc, jt, jp, k_scales=jks,
                                      v_scales=jvs, window=window))
    pallas = np.asarray(jax_paged_kernel(
        jq, jkc, jvc, jt, jp, k_scales=jks, v_scales=jvs, window=window,
        accum="online", interpret=True))
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)


@pytest.mark.parametrize("cache_dtype", ["fp8", "int8"])
@pytest.mark.parametrize("window", [None, 6])
def test_scaled_multi_attention_matches_jax(cache_dtype, window):
    """Chunked prefill over code pools: gathered pages dequantized to q's
    dtype, then the blocked online softmax — the reference's
    ``impl="blocked"`` — within 1e-5."""
    q1, kp, vp, table, pos = _case(8, 3, 8, 2, 32, 8, 5, scratch_tail=False)
    rng = np.random.default_rng(8)
    q = rng.standard_normal((3, 4, 8, 32)).astype(np.float32)
    start = np.minimum(pos, 8 * 5 - 4).astype(np.int32)
    kc, vc, ks, vs = _quantized(q1, kp, vp, cache_dtype)
    got = ops.paged_gqa_multi_attention(
        torch.from_numpy(q), kc, vc, torch.from_numpy(table),
        torch.from_numpy(start), k_scales=ks, v_scales=vs,
        window=window).numpy()
    jkc, jvc, jks, jvs = (_jax_codes(t) for t in (kc, vc, ks, vs))
    want = np.asarray(jax_multi(
        jnp.asarray(q), jkc, jvc, jnp.asarray(table), jnp.asarray(start),
        k_scales=jks, v_scales=jvs, window=window, impl="blocked"))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["fp8", "int8"])
@pytest.mark.parametrize("window", [None, 7])
def test_cuda_scaled_kernel_matches_ref(cache_dtype, window):
    """The kernel over code pools against its plain version on the card
    (f32 q within 1e-5; bf16 q within 2e-2 on the bf16 output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, kp, vp, table, pos = _case(9, 4, 32, 8, 128, 16, 9, scratch_tail=True)
    kc, vc, ks, vs = (t.cuda() for t in _quantized(q, kp, vp, cache_dtype))
    table, pos = torch.from_numpy(table).cuda(), torch.from_numpy(pos).cuda()
    for qd, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        qt = torch.from_numpy(q).cuda().to(qd)
        out = ops.paged_gqa_decode_attention(qt, kc, vc, table, pos,
                                             k_scales=ks, v_scales=vs,
                                             window=window)
        ref = paged_decode_attention_ref(qt, kc, vc, table, pos, k_scales=ks,
                                         v_scales=vs, window=window)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 7])
def test_cuda_kernel_matches_ref(dtype, window):
    """The hand-written kernel against its plain version on the card
    (f32 pools within 1e-5; bf16 pools within 2e-2 on the bf16 output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, kp, vp, table, pos = [t.cuda() for t in _torch(
        *_case(7, 4, 32, 8, 128, 16, 9, scratch_tail=True))]
    q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
    out = ops.paged_gqa_decode_attention(q, kp, vp, table, pos, window=window)
    ref = paged_decode_attention_ref(q, kp, vp, table, pos, window=window)
    torch.cuda.synchronize()
    tol = 1e-5 if dt == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_variant_choice():
    """bf16 q over bf16, fp8 or int8 pools at D 64/128 with a page that is
    a multiple of 16 takes the tensor-core kernel; f32 q or pools, D 256
    and other pages keep the CUDA-core one."""
    v = paged_kernel.variant
    bf, f32 = torch.bfloat16, torch.float32
    codes = (torch.float8_e4m3fn, torch.int8)
    assert {v(bf, pool, d, page) for pool in (bf, *codes)
            for d in (64, 128) for page in (16, 32, 64)} == {"tensor_core"}
    assert {v(f32, pool, 128, 16) for pool in (f32, bf, *codes)} \
        == {"cuda_core"}
    assert {v(bf, f32, 128, 16), v(bf, bf, 256, 16), v(bf, bf, 128, 8),
            v(bf, torch.int8, 64, 4), v(bf, bf, 128, 24)} == {"cuda_core"}


@pytest.mark.parametrize("b,kvh,n_blocks,page,want", [
    (8, 8, 128, 16, 4),        # the continuous serve: one wave, 4 splits
    (8, 8, 256, 16, 4),        # ctx 4096
    (1, 8, 256, 16, 33),       # a wave (33) within the table's 64 tiles
    (1, 8, 6, 16, 2),          # one split per 64-token tile of the table
    (4, 2, 5, 16, 2),          # a ragged last tile
    (8, 8, 64, 32, 4),         # page 32
    (64, 8, 128, 16, 1),       # more (slot, kv head) pairs than a wave
])
def test_split_count_tensor_core(b, kvh, n_blocks, page, want):
    """The tensor-core launch's split count: floor(2 x SMs / (B x KVH))
    (one wave at two CTAs an SM), at most one per 64-token tile of the
    table, at least one."""
    assert paged_kernel.split_count("tensor_core", b, kvh, n_blocks, page,
                                    132) == want


def test_split_count_cuda_core_unchanged():
    """The CUDA-core kernel (f32 parity runs) keeps the first version's
    rule, so its sums keep their order."""
    for b, nb in ((1, 32), (8, 128), (8, 256)):
        want = paged_kernel.num_splits(b, 8, nb, 132)
        assert paged_kernel.split_count("cuda_core", b, 8, nb, 16, 132) \
            == want


def test_counter_arrays(monkeypatch):
    """Each tensor-core kernel has its own zeroed int32 counter array per
    device, B x KVH long, reused while it is long enough and replaced by a
    longer one when a batch needs more."""
    monkeypatch.setattr(paged_kernel, "_COUNTERS", {})
    dev = torch.device("cpu")
    online = paged_kernel._counters("online", dev, 8 * 8)
    exact = paged_kernel._counters("exact", dev, 8 * 8)
    assert online is not exact
    for cnt in (online, exact):
        assert cnt.dtype == torch.int32 and cnt.numel() == 64
        assert int(cnt.abs().sum()) == 0
    assert paged_kernel._counters("online", dev, 4 * 2) is online
    wider = paged_kernel._counters("online", dev, 16 * 8)
    assert wider is not online and wider.numel() == 128
    assert paged_kernel._counters("exact", dev, 64) is exact


def _emulate_tensor_core(q, kc, vc, ks, vs, table, pos, page):
    """The tensor-core kernel's arithmetic over code pools in torch, per
    (slot, kv head): 16-token slices in order with one f32 online softmax
    in the log2 domain; a score is q (bf16) . code (exact in bf16) summed
    in f32, times the token's K scale; P times the token's V scale is split
    into bf16 hi + lo, each times the codes.  (The kernel also splits the
    walk over warps and CTAs and folds their states; that changes no
    precision argument.)"""
    b, h, d = q.shape
    kvh = kc.shape[2]
    rep = h // kvh
    c = 1.0 / np.sqrt(d) * np.log2(np.e)
    bf = torch.bfloat16
    out = torch.empty((b, h, d), dtype=torch.float32)
    for bi in range(b):
        n = int(pos[bi]) + 1
        toks = torch.arange(n)
        phys = table[bi, toks // page].long()
        for g in range(kvh):
            k = kc[phys, toks % page, g].float()        # codes, exact
            v = vc[phys, toks % page, g].float()
            sk = ks[phys, toks % page, g]
            sv = vs[phys, toks % page, g]
            qg = q[bi, g * rep:(g + 1) * rep].to(bf).float()
            m = torch.full((rep,), -1e30)
            l = torch.zeros(rep)
            acc = torch.zeros(rep, d)
            for t0 in range(0, n, 16):
                sl = slice(t0, min(t0 + 16, n))
                s = (qg @ k[sl].T) * (sk[sl] * c)
                m_new = torch.maximum(m, s.max(-1).values)
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[:, None])
                l = l * corr + p.sum(-1)
                pv = p * sv[sl]
                hi = pv.to(bf).float()
                lo = (pv - hi).to(bf).float()
                acc = acc * corr[:, None] + hi @ v[sl] + lo @ v[sl]
                m = m_new
            out[bi, g * rep:(g + 1) * rep] = acc / l[:, None]
    return out


@pytest.mark.parametrize("cache_dtype", ["fp8", "int8"])
def test_tensor_core_code_pool_arithmetic(cache_dtype):
    """Codes converted to bf16 (exact), the K scale applied after the
    product and the V scale folded into P before the hi + lo split stay
    within the card check's limit of the plain version (dequantize first),
    2^-7 |ref| + 1e-4 per bf16 output, with room to spare; before the
    output's rounding they are within 1e-5 of it."""
    q, kp, vp, table, pos = _case(12, 2, 16, 4, 64, 16, 6,
                                  scratch_tail=True)
    kc, vc, ks, vs = _quantized(q, kp, vp, cache_dtype)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    tt, pt = torch.from_numpy(table), torch.from_numpy(pos)
    got = _emulate_tensor_core(qb, kc, vc, ks, vs, tt, pt, 16)
    ref32 = paged_decode_attention_ref(qb.float(), kc, vc, tt, pt,
                                       k_scales=ks, v_scales=vs)
    assert (got - ref32).abs().max().item() < 1e-5
    ref = paged_decode_attention_ref(qb, kc, vc, tt, pt, k_scales=ks,
                                     v_scales=vs).float()
    share = ((got.to(torch.bfloat16).float() - ref).abs()
             / (2.0 ** -7 * ref.abs() + 1e-4)).max().item()
    assert share <= 1.0


def _ulp_ok(out, ref, atol=1e-4) -> bool:
    """Each bf16 output within one bf16 ulp (2^-7 of its magnitude) of its
    plain version's, plus ``atol`` for f32 sums in another order."""
    ref = ref.float()
    return bool(((out.float() - ref).abs()
                 <= 2.0 ** -7 * ref.abs() + atol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("pools", ["bfloat16", "fp8", "int8"])
@pytest.mark.parametrize("h,kvh,d,page", [
    (32, 8, 128, 16),          # llama3-8b
    (40, 8, 128, 16),          # rep 5 (qwen2.5-14b / qwen3-14b)
    (16, 4, 64, 16),           # D 64
    (32, 8, 128, 32),          # page 32
])
@pytest.mark.parametrize("window", [None, 1, 1000])
def test_cuda_tensor_core_kernel_matches_ref(pools, h, kvh, d, page, window):
    """The tensor-core online kernel against its plain version on the card,
    bf16 q over bf16 / fp8 / int8 pools, ragged positions up to 4096 with
    the table past each position on the poisoned scratch page: each bf16
    output within one bf16 ulp of its magnitude plus 1e-4.  It launches
    once per call and leaves its counters at zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, kp, vp, table, pos = _case(13, 8, h, kvh, d, page, 4096 // page + 2,
                                  scratch_tail=True)
    qt = torch.from_numpy(q).cuda().to(torch.bfloat16)
    table, pos = torch.from_numpy(table).cuda(), torch.from_numpy(pos).cuda()
    scales = {}
    if pools == "bfloat16":
        kt, vt = (torch.from_numpy(a).cuda().to(torch.bfloat16)
                  for a in (kp, vp))
        name = paged_kernel.NAME
    else:
        kt, vt, ks, vs = (t.cuda() for t in _quantized(q, kp, vp, pools))
        scales = dict(k_scales=ks, v_scales=vs)
        name = paged_kernel.NAME_SCALED
    assert paged_kernel.variant(qt.dtype, kt.dtype, d, page) == "tensor_core"
    before = VARIANT_LAUNCHES[f"{name}:tensor_core"]
    out = paged_kernel.paged_decode_attention(qt, kt, vt, table, pos,
                                              window=window, **scales)
    ref = paged_decode_attention_ref(qt, kt, vt, table, pos, window=window,
                                     **scales)
    torch.cuda.synchronize()
    assert VARIANT_LAUNCHES[f"{name}:tensor_core"] == before + 1
    assert _ulp_ok(out, ref)
    cnt = paged_kernel._COUNTERS[("online", qt.device.index)]
    assert int(cnt.abs().sum()) == 0
