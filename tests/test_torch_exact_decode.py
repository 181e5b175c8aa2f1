"""The exact-accumulator paged decode (the speculative verify step's
attention): the port's plain multi-query oracle against the JAX
reference's oracle (C = 1 and 5 queries per slot, sliding window, fp8 and
int8 code pools, a poisoned tail) and, at C = 1, against the reference's
Pallas ``accum="exact"`` kernel in interpret mode; the op's ``impl``
dispatch; the kernel wrapper's pure-Python routing (variant, counter
arrays) and the tensor-core kernel's arithmetic (per-chunk softmax, P as
bf16 hi + lo, chunks folded in order) emulated in torch; and, where there
is a card, the CUDA kernels against their plain version with the bitwise
invariance contract.

Tolerance 1e-6 absolute in f32, not bitwise: on jax 0.9 the reference's own
bitwise exact-mode tests fail (its interpret kernel is 2e-7 to 1e-6 off its
oracle, ROADMAP Queue 3), and the port's einsums sum in another order."""
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels.ref)
import jax.numpy as jnp
import ml_dtypes

from repro.kernels.decode_attention.paged_kernel import (
    paged_decode_attention as jax_paged_kernel,
)
from repro.kernels.decode_attention.ref import (
    paged_decode_multi_attention_ref as jax_multi_ref,
)
from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
from repro_torch.kernels.decode_attention import ops, paged_kernel
from repro_torch.kernels.decode_attention.ref import (
    paged_decode_attention_ref, paged_decode_multi_attention_ref,
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


ATOL = 1e-6


def _case(seed, B, C, H, KVH, D, page, n_blocks):
    """Random f32 pools with a poisoned scratch page 0; per-row permuted
    page tables whose blocks past the row's last query point at page 0;
    ragged starts (row 0 at 0); and every pool position after a row's last
    query (start + C - 1) filled with +-1e4, which the causal mask must
    give zero weight."""
    rng = np.random.default_rng(seed)
    P = 1 + B * n_blocks
    table = rng.permutation(np.arange(1, P)).reshape(B, n_blocks)
    start = rng.integers(0, page * n_blocks - C + 1, B).astype(np.int32)
    start[0] = 0
    last = start + C - 1
    live = np.arange(n_blocks)[None, :] <= (last // page)[:, None]
    table = np.where(live, table, 0).astype(np.int32)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, KVH, D)).astype(np.float32)
    kp[0], vp[0] = 1e4, -1e4
    for b in range(B):
        for t in range(last[b] + 1, (last[b] // page + 1) * page):
            kp[table[b, t // page], t % page] = 1e4
            vp[table[b, t // page], t % page] = -1e4
    return q, kp, vp, table, start


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _code_pools(kp, vp, cache_dtype):
    kc, ks = kv_quantize(torch.from_numpy(kp), cache_dtype)
    vc, vs = kv_quantize(torch.from_numpy(vp), cache_dtype)
    ks[0], vs[0] = 1e4, -1e4
    return kc, vc, ks, vs


def _jax(t: torch.Tensor):
    """A torch tensor as the same bits in a jax array (fp8 via uint8)."""
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy().view(
            ml_dtypes.float8_e4m3fn))
    return jnp.asarray(t.numpy())


CASES = [
    # seed, B, C, H, KVH, D, page, n_blocks, window
    (0, 3, 1, 8, 2, 32, 8, 5, None),
    (1, 3, 5, 8, 2, 32, 8, 5, None),       # the verify shape (gamma 4)
    (2, 2, 5, 16, 2, 64, 16, 3, None),     # GQA 8:1
    (3, 3, 5, 8, 2, 32, 8, 6, 7),          # window shorter than a page pair
    (4, 1, 1, 4, 4, 16, 4, 7, 5),          # MHA, many small pages, window
]


@pytest.mark.parametrize("seed,B,C,H,KVH,D,page,nb,window", CASES)
def test_multi_ref_matches_jax_oracle(seed, B, C, H, KVH, D, page, nb,
                                      window):
    q, kp, vp, table, start = _case(seed, B, C, H, KVH, D, page, nb)
    got = paged_decode_multi_attention_ref(*_torch(q, kp, vp, table, start),
                                           window=window).numpy()
    want = np.asarray(jax_multi_ref(*(jnp.asarray(a) for a in
                                      (q, kp, vp, table, start)),
                                    window=window))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("cache_dtype", ["fp8", "int8"])
@pytest.mark.parametrize("seed,B,C,H,KVH,D,page,nb,window",
                         [CASES[1], CASES[3]])
def test_multi_ref_code_pools_match_jax_oracle(cache_dtype, seed, B, C, H,
                                               KVH, D, page, nb, window):
    q, kp, vp, table, start = _case(seed, B, C, H, KVH, D, page, nb)
    kc, vc, ks, vs = _code_pools(kp, vp, cache_dtype)
    qt, tt, st = _torch(q, table, start)
    got = paged_decode_multi_attention_ref(qt, kc, vc, tt, st, k_scales=ks,
                                           v_scales=vs, window=window).numpy()
    want = np.asarray(jax_multi_ref(
        jnp.asarray(q), *(_jax(t) for t in (kc, vc)), jnp.asarray(table),
        jnp.asarray(start), k_scales=_jax(ks), v_scales=_jax(vs),
        window=window))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_one_query_matches_pallas_exact_kernel(window, cache_dtype):
    """C = 1 is ``accum="exact"``: the plain version against the
    reference's Pallas exact kernel (interpret mode) and against the
    single-token oracle."""
    q, kp, vp, table, start = _case(5, 3, 1, 8, 2, 32, 8, 5)
    qt, kt, vt, tt, st = _torch(q, kp, vp, table, start)
    scales = {}
    if cache_dtype is not None:
        kt, vt, ks, vs = _code_pools(kp, vp, cache_dtype)
        scales = dict(k_scales=ks, v_scales=vs)
    got = paged_decode_multi_attention_ref(qt, kt, vt, tt, st, window=window,
                                           **scales)[:, 0].numpy()
    pallas = np.asarray(jax_paged_kernel(
        jnp.asarray(q[:, 0]), _jax(kt), _jax(vt), jnp.asarray(table),
        jnp.asarray(start), window=window, accum="exact", interpret=True,
        **{k: _jax(v) for k, v in scales.items()}))
    single = paged_decode_attention_ref(qt[:, 0], kt, vt, tt, st,
                                        window=window, **scales).numpy()
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, single, rtol=0, atol=ATOL)


def test_query_j_is_the_single_token_oracle_at_start_plus_j():
    """Each of the C queries attends exactly what a single-token decode at
    its own position would (the verify step's contract on the CPU)."""
    q, kp, vp, table, start = _case(6, 3, 5, 8, 2, 32, 8, 5)
    qt, kt, vt, tt, st = _torch(q, kp, vp, table, start)
    multi = paged_decode_multi_attention_ref(qt, kt, vt, tt, st, window=9)
    for j in range(5):
        one = paged_decode_attention_ref(qt[:, j], kt, vt, tt, st + j,
                                         window=9)
        np.testing.assert_allclose(multi[:, j].numpy(), one.numpy(), rtol=0,
                                   atol=ATOL)


def test_op_dispatch_on_cpu():
    q, kp, vp, table, start = _torch(*_case(7, 2, 5, 8, 2, 32, 8, 4))
    before = dict(LAUNCHES)
    auto = ops.paged_gqa_multi_attention(q, kp, vp, table, start)
    ref = paged_decode_multi_attention_ref(q, kp, vp, table, start)
    np.testing.assert_array_equal(auto.numpy(), ref.numpy())
    explicit = ops.paged_gqa_multi_attention(q, kp, vp, table, start,
                                             impl="reference")
    np.testing.assert_array_equal(explicit.numpy(), ref.numpy())
    # the blocked online softmax (chunked prefill) is another function
    # order, the same attention
    blocked = ops.paged_gqa_multi_attention(q, kp, vp, table, start,
                                            impl="blocked")
    np.testing.assert_allclose(blocked.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5)
    assert dict(LAUNCHES) == before                  # no kernel on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_gqa_multi_attention(q, kp, vp, table, start, impl="fused")
    with pytest.raises(ValueError, match="causal"):
        ops.paged_gqa_multi_attention(q, kp, vp, table, start, causal=False,
                                      impl="reference")
    with pytest.raises(ValueError, match="impl"):
        ops.paged_gqa_multi_attention(q, kp, vp, table, start, impl="nope")
    with pytest.raises(ValueError, match="CUDA"):
        paged_kernel.paged_decode_multi_attention(q, kp, vp, table, start)
    with pytest.raises(ValueError, match="CUDA"):
        paged_kernel.paged_decode_attention(q[:, 0], kp, vp, table, start,
                                            accum="exact")
    with pytest.raises(ValueError, match="accum"):
        paged_kernel.paged_decode_attention(q[:, 0], kp, vp, table, start,
                                            accum="nope")


def _ulp_share(out, ref, atol=1e-4) -> float:
    """max |out - ref| / (2^-7 |ref| + atol): at most 1 when each bf16
    output is within one bf16 ulp of its plain version's."""
    ref = ref.float()
    return ((out.float() - ref).abs() / (2.0 ** -7 * ref.abs() + atol)
            ).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("pools", ["float32", "bfloat16", "fp8", "int8"])
@pytest.mark.parametrize("window", [None, 300])
def test_cuda_exact_kernel_matches_ref_and_is_invariant(pools, window):
    """The CUDA kernel against its plain version on the card (f32 within
    1e-5, bf16 output within one bf16 ulp + 1e-4), and its contract: query
    j of a C = 5 launch equals, bit for bit, a C = 1 launch at start + j;
    row b of a B = 4 launch equals that row launched alone with a wider
    page table."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, kp, vp, table, start = _case(8, 4, 5, 32, 8, 128, 16, 40)
    q = torch.from_numpy(q).cuda()
    table, start = torch.from_numpy(table).cuda(), torch.from_numpy(start).cuda()
    scales = {}
    if pools in ("fp8", "int8"):
        kc, vc, ks, vs = (t.cuda() for t in _code_pools(kp, vp, pools))
        kt, vt = kc, vc
        scales = dict(k_scales=ks, v_scales=vs)
        q = q.to(torch.bfloat16)
    else:
        dt = getattr(torch, pools)
        kt, vt = (torch.from_numpy(a).cuda().to(dt) for a in (kp, vp))
        q = q.to(dt)
    kw = dict(window=window, **scales)
    out = paged_kernel.paged_decode_multi_attention(q, kt, vt, table, start,
                                                    **kw)
    ref = paged_decode_multi_attention_ref(q, kt, vt, table, start, **kw)
    torch.cuda.synchronize()
    if q.dtype == torch.float32:
        assert (out - ref).abs().max().item() <= 1e-5
    else:
        assert _ulp_share(out, ref) <= 1.0
    for j in range(5):
        one = paged_kernel.paged_decode_multi_attention(
            q[:, j:j + 1].contiguous(), kt, vt, table, start + j, **kw)
        assert torch.equal(one[:, 0], out[:, j])
    wide = torch.cat([table, torch.zeros_like(table)], dim=1)
    for b in range(4):
        alone = paged_kernel.paged_decode_multi_attention(
            q[b:b + 1].contiguous(), kt, vt, wide[b:b + 1].contiguous(),
            start[b:b + 1].contiguous(), **kw)
        assert torch.equal(alone[0], out[b])


def test_variant_choice():
    """The exact entry routes as the online one: bf16 q over bf16, fp8 or
    int8 pools at D 64/128 with a page that is a multiple of 16 (also one
    the CUDA-core kernel refuses, such as 48) takes the one-launch
    tensor-core kernel; f32 q or pools (the parity checks, the card's f32
    speculative streams), D 256 and pages of 8 or fewer keep the
    four-launch kernel."""
    v = paged_kernel.variant
    bf, f32 = torch.bfloat16, torch.float32
    for pool in (bf, torch.float8_e4m3fn, torch.int8):
        assert [v(bf, pool, 128, p) for p in (16, 32, 48)] == \
            ["tensor_core"] * 3
        assert v(bf, pool, 64, 16) == "tensor_core"
        assert v(f32, pool, 128, 16) == "cuda_core"
        assert v(bf, pool, 256, 16) == "cuda_core"
        assert v(bf, pool, 128, 8) == "cuda_core"
    assert v(bf, f32, 128, 16) == v(f32, f32, 128, 16) == "cuda_core"


def test_exact_counter_array_is_its_own(monkeypatch):
    """The exact kernel's arrival counters are not the online kernel's:
    the verify step's launch and the draft steps' never share an array."""
    monkeypatch.setattr(paged_kernel, "_COUNTERS", {})
    dev = torch.device("cpu")
    exact = paged_kernel._counters("exact", dev, 4 * 8)
    online = paged_kernel._counters("online", dev, 4 * 8)
    assert exact is not online
    assert exact.numel() == 32 and exact.dtype == torch.int32
    assert int(exact.abs().sum()) == 0
    assert paged_kernel._counters("exact", dev, 32) is exact


def _emulate_exact_tensor_core(q, k, v, table, start, page, window=None):
    """The tensor-core exact kernel's arithmetic in torch (bf16 pools):
    per query row, each absolute 128-position chunk it sees gets its own
    max m_c, p = exp2(s - m_c) and l_c; P as bf16 hi + lo times V; the
    chunks' (m_c, l_c, acc_c) are folded in chunk order (max first, then
    rescaled sums left to right) and divided."""
    b_, c_, h, d = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    cl2 = 1.0 / np.sqrt(d) * np.log2(np.e)
    bf = torch.bfloat16
    out = torch.empty((b_, c_, h, d), dtype=torch.float32)
    for bi in range(b_):
        for c in range(c_):
            p = int(start[bi]) + c
            lo = 0 if window is None else max(0, p - window + 1)
            toks = torch.arange(lo, p + 1)
            phys = table[bi, toks // page].long()
            for g in range(kvh):
                kk = k[phys, toks % page, g].float()
                vv = v[phys, toks % page, g].float()
                for i in range(rep):
                    s = (q[bi, c, g * rep + i].float() @ kk.T) * cl2
                    parts = []
                    for ch in range(lo // 128, p // 128 + 1):
                        sel = (toks >= ch * 128) & (toks < ch * 128 + 128)
                        m_c = s[sel].max()
                        pc = torch.exp2(s[sel] - m_c)
                        hi = pc.to(bf).float()
                        lo_ = (pc - hi).to(bf).float()
                        parts.append((m_c, pc.sum(),
                                      hi @ vv[sel] + lo_ @ vv[sel]))
                    m = max(x[0] for x in parts)
                    l = sum(x[1] * torch.exp2(x[0] - m) for x in parts)
                    a = sum(x[2] * torch.exp2(x[0] - m) for x in parts)
                    out[bi, c, g * rep + i] = a / l
    return out


def test_tensor_core_exact_arithmetic():
    """The per-chunk softmax with P as bf16 hi + lo and the chunks folded
    in order keeps f32 precision (within 1e-5 of the plain version before
    the output's rounding) and, rounded to bf16, the card check's limit of
    2^-7 |ref| + 1e-4 per element; rows span several 128-position chunks
    and a window cuts one mid-chunk."""
    q, kp, vp, table, start = _case(14, 2, 3, 8, 2, 64, 16, 20)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp))
    tt, st = torch.from_numpy(table), torch.from_numpy(start)
    for window in (None, 150):
        got = _emulate_exact_tensor_core(qb, kb, vb, tt, st, 16, window)
        ref32 = paged_decode_multi_attention_ref(
            qb.float(), kb.float(), vb.float(), tt, st, window=window)
        assert (got - ref32).abs().max().item() < 1e-5
        ref = paged_decode_multi_attention_ref(qb, kb, vb, tt, st,
                                               window=window)
        assert _ulp_share(got.to(torch.bfloat16), ref) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("pools", ["bfloat16", "fp8", "int8"])
@pytest.mark.parametrize("h,kvh,d,page", [
    (32, 8, 128, 16),          # llama3-8b
    (40, 8, 128, 16),          # rep 5: C 5 x rep 5 = 25 rows
    (16, 4, 64, 16),           # D 64
    (32, 8, 128, 32),          # page 32
    (64, 8, 128, 16),          # rep 8: 40 rows, the 64-row M tile
])
@pytest.mark.parametrize("window", [None, 1, 1000])
def test_cuda_tensor_core_exact_matches_ref_and_is_invariant(pools, h, kvh,
                                                             d, page, window):
    """The one-launch tensor-core exact kernel against its plain version on
    the card (each bf16 output within one bf16 ulp + 1e-4), launched as the
    tensor-core variant, leaving its counters at zero, and its contract bit
    for bit: query j of a C = 5 launch equals a C = 1 launch at start + j,
    and row b of a B = 8 launch equals the row alone with a wider table."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, kp, vp, table, start = _case(15, 8, 5, h, kvh, d, page,
                                    4096 // page + 2)
    q = torch.from_numpy(q).cuda().to(torch.bfloat16)
    table, start = torch.from_numpy(table).cuda(), torch.from_numpy(start).cuda()
    scales = {}
    if pools == "bfloat16":
        kt, vt = (torch.from_numpy(a).cuda().to(torch.bfloat16)
                  for a in (kp, vp))
    else:
        kt, vt, ks, vs = (t.cuda() for t in _code_pools(kp, vp, pools))
        scales = dict(k_scales=ks, v_scales=vs)
    kw = dict(window=window, **scales)
    key = f"{paged_kernel.NAME_EXACT}:tensor_core"
    before = VARIANT_LAUNCHES[key]
    out = paged_kernel.paged_decode_multi_attention(q, kt, vt, table, start,
                                                    **kw)
    ref = paged_decode_multi_attention_ref(q, kt, vt, table, start, **kw)
    torch.cuda.synchronize()
    assert VARIANT_LAUNCHES[key] == before + 1
    assert _ulp_share(out, ref) <= 1.0
    for j in range(5):
        one = paged_kernel.paged_decode_multi_attention(
            q[:, j:j + 1].contiguous(), kt, vt, table, start + j, **kw)
        assert torch.equal(one[:, 0], out[:, j])
    wide = torch.cat([table, torch.zeros_like(table)], dim=1)
    for b in range(8):
        alone = paged_kernel.paged_decode_multi_attention(
            q[b:b + 1].contiguous(), kt, vt, wide[b:b + 1].contiguous(),
            start[b:b + 1].contiguous(), **kw)
        assert torch.equal(alone[0], out[b])
    cnt = paged_kernel._COUNTERS[("exact", q.device.index)]
    assert int(cnt.abs().sum()) == 0
