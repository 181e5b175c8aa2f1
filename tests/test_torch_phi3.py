"""phi3-mini-3.8b (full MHA, head dim 96) on the CPU against the reference:
the plain versions of the attention kernels at D 96 (flash, dense decode,
paged online, fp8 and exact), the static path, and ``LLMEngine`` streams
of every backend (continuous through preemption and prefix hits, static,
legacy speculative, and ``speculative=`` self-draft through the exact
path), prompt scoring, and the head dims the kernels take.

Two configs: the reference's ``reduced_config`` (head dim 16) and a
narrow one at the real head dim (H = KVH = 2, d_model 192, D 96, 2
layers), which the reduced one never reaches.  Weights come from the
reference ``Model.init`` through ``bridge.params_from_jax``; inputs from
seeded numpy generators.  Tolerances: f32 throughout, logits and caches
within 1e-5 (XLA:CPU and PyTorch sum in other orders), token streams
identical, greedy and sampled; the reference's Pallas kernels run in
interpret mode, as its own tests run them."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced_config
from repro.kernels.decode_attention.ops import (
    gqa_decode_attention as jax_gqa_decode,
)
from repro.kernels.decode_attention.paged_kernel import (
    paged_decode_attention as jax_paged_kernel,
)
from repro.kernels.decode_attention.ref import (
    paged_decode_attention_ref as jax_paged_ref,
    paged_decode_multi_attention_ref as jax_multi_ref,
)
from repro.kernels.flash_attention.ops import (
    gqa_flash_attention as jax_gqa_flash,
)
from repro.models.common import blocked_attention as jax_blocked
from repro.models.model import build_model
from repro.runtime.llm import LLMEngine as RefLLM
from repro.runtime.sampling import SamplingParams as RefSP
from repro.runtime.speculative import SpeculativeConfig as RefSpecConfig
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.kernels.decode_attention import kernel as dense_kernel
from repro_torch.kernels.decode_attention import paged_kernel
from repro_torch.kernels.decode_attention.ops import (
    gqa_decode_attention, paged_gqa_decode_attention,
    paged_gqa_multi_attention,
)
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import gqa_flash_attention
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.speculative import SpeculativeConfig

PHI3 = "phi3-mini-3.8b"
NARROW = dict(n_heads=2, n_kv_heads=2, head_dim=96, d_model=192, n_layers=2)
SAMPLING = [dict(), dict(temperature=0.9, top_k=8, seed=101, logprobs=True),
            dict(repetition_penalty=1.2),
            dict(temperature=0.7, top_p=0.8, min_p=0.05, seed=5)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(narrow: bool, seed: int = 0):
    """Reference model, its f32 params, and the port in f32 on its
    weights."""
    jcfg = reduced_config(get_config(PHI3))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(PHI3))
    if narrow:
        jcfg = dataclasses.replace(jcfg, **NARROW)
        tcfg = dataclasses.replace(tcfg, **NARROW)
    ref = build_model(jcfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(seed)))
    port = params_from_jax(params, tcfg, device="cpu").float()
    return (jcfg, ref, jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                                    params), port)


@pytest.fixture(scope="module", params=[False, True],
                ids=["reduced", "narrow_d96"])
def phi3(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def reduced():
    return _build(False)


def _close(got: torch.Tensor, want, atol=1e-5):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------------------
# the kernels' plain versions at D 96
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_version_at_d96(causal, window):
    """``flash_attention_ref`` through the GQA op at D 96, MHA: against the
    reference's Pallas kernel (interpret mode; it takes no window) and
    ``blocked_attention``."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 64, 2, 96)).astype(np.float32)
               for _ in range(3))
    got = gqa_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(got, jax_blocked(jq, jk, jv, causal=causal, window=window))
    if window is None:
        _close(got, jax_gqa_flash(jq, jk, jv, causal=causal, block_q=32,
                                  block_k=32))


def test_dense_decode_plain_version_at_d96():
    """The dense decode's plain version at D 96 and rep 1 against the
    reference's Pallas kernel over ragged ``cur_len`` (the tail poisoned)."""
    rng = np.random.default_rng(2)
    b, s, h, d = 3, 64, 4, 96
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    cur_len = np.array([64, 1, 37], np.int32)
    dead = np.arange(s)[None, :] >= cur_len[:, None]
    k[dead], v[dead] = 1e4, -1e4
    got = gqa_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(cur_len))
    _close(got, jax_gqa_decode(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(cur_len),
                               block_s=32))


@pytest.mark.parametrize("pools", ["float32", "fp8"])
@pytest.mark.parametrize("window", [None, 9])
def test_paged_plain_versions_at_d96(window, pools):
    """The online, scale-pool and exact plain versions at D 96, rep 1,
    against the reference's refs and its Pallas kernel in interpret mode
    (online and exact accumulators), dead table entries on the poisoned
    scratch page."""
    from repro.quant import kv as jkvq
    rng = np.random.default_rng(3)
    b, h, d, page, nb = 3, 2, 96, 4, 8
    P = 1 + b * nb
    kp = rng.standard_normal((P, page, h, d)).astype(np.float32)
    vp = rng.standard_normal((P, page, h, d)).astype(np.float32)
    kp[0], vp[0] = 1e4, -1e4
    pos = np.array([nb * page - 1, 13, 2], np.int32)
    table = rng.permutation(np.arange(1, P)).reshape(b, nb)
    table = np.where(np.arange(nb)[None, :] <= (pos // page)[:, None], table,
                     0).astype(np.int32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    scales, jscales = {}, {}
    tk, tv = torch.from_numpy(kp), torch.from_numpy(vp)
    if pools == "fp8":
        kc, ks = (np.array(a) for a in jkvq.kv_quantize(jnp.asarray(kp), "fp8"))
        vc, vs = (np.array(a) for a in jkvq.kv_quantize(jnp.asarray(vp), "fp8"))
        ks[0], vs[0] = 1e4, -1e4
        kp, vp = kc, vc
        tk = torch.from_numpy(kc.view(np.uint8)).view(torch.float8_e4m3fn)
        tv = torch.from_numpy(vc.view(np.uint8)).view(torch.float8_e4m3fn)
        scales = dict(k_scales=torch.from_numpy(ks),
                      v_scales=torch.from_numpy(vs))
        jscales = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    tq, tt, tp = (torch.from_numpy(a) for a in (q, table, pos))
    jq, jk, jv, jt, jp = (jnp.asarray(a) for a in (q, kp, vp, table, pos))
    got = paged_gqa_decode_attention(tq, tk, tv, tt, tp, window=window,
                                     **scales)
    _close(got, jax_paged_ref(jq, jk, jv, jt, jp, window=window, **jscales))
    for accum in ("online", "exact"):
        _close(got, jax_paged_kernel(jq, jk, jv, jt, jp, window=window,
                                     accum=accum, interpret=True, **jscales))
    c = 5                         # the verify step of gamma 4
    qm = rng.standard_normal((b, c, h, d)).astype(np.float32)
    start = np.maximum(pos - c + 1, 0).astype(np.int32)
    gotm = paged_gqa_multi_attention(torch.from_numpy(qm), tk, tv, tt,
                                     torch.from_numpy(start), window=window,
                                     **scales)
    _close(gotm, jax_multi_ref(jnp.asarray(qm), jk, jv, jt,
                               jnp.asarray(start), window=window, **jscales))


def test_kernels_take_head_dim_96():
    """Every attention kernel takes D 96 and picks its tensor-core (or
    wgmma) variant for bf16 there; f32 keeps the CUDA-core kernels; the
    exact kernel's rows at D 96 are bounded where the wrapper checks them."""
    bf, f32 = torch.bfloat16, torch.float32
    assert 96 in flash_kernel.HEAD_DIMS and 96 in dense_kernel.HEAD_DIMS
    assert 96 in paged_kernel.HEAD_DIMS and 96 in paged_kernel.TC_HEAD_DIMS
    assert flash_kernel.variant(bf, 96, 1) == "wgmma"
    assert flash_kernel.variant(f32, 96) == "fma"
    assert dense_kernel.variant(bf, bf, 96) == "tensor_core"
    assert dense_kernel.variant(bf, f32, 96) == "cuda_core"
    for pool in (bf, torch.float8_e4m3fn, torch.int8):
        assert paged_kernel.variant(bf, pool, 96, 16) == "tensor_core"
        assert paged_kernel.variant(bf, pool, 96, 8) == "cuda_core"
    assert paged_kernel.EXACT_TC_MAX_ROWS >= 5      # phi3's verify: C 5 x rep 1


# ---------------------------------------------------------------------------
# the static path and the engines
# ---------------------------------------------------------------------------


def test_static_prefill_decode_forward_match_reference(phi3):
    """Prefill logits and the dense cache, five decode steps, the cache
    after them, and ``forward``'s logits, in f32."""
    cfg, ref, params, port = phi3
    B, S, max_len = 2, 9, 16
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jcache = ref.init_cache(B, max_len, dtype=jnp.float32)
    tcache = port.init_cache(B, max_len, dtype=torch.float32)
    jl, jcache = ref.prefill(params, {"tokens": jnp.asarray(tokens)}, jcache)
    _close(port.prefill(torch.from_numpy(tokens), tcache), jl)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for pos in range(S, S + 5):
        jl, jcache = ref.decode_step(params, jnp.asarray(tok), jcache,
                                     jnp.int32(pos))
        _close(port.decode_step(torch.from_numpy(tok), tcache, pos), jl)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    seg = jcache[0][0]
    for i in range(cfg.n_layers):
        for key in ("k", "v"):
            _close(tcache[i][key], seg[key][i])
    jf = ref.forward(params, {"tokens": jnp.asarray(tokens)})
    _close(port.forward(torch.from_numpy(tokens)), jf)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    base = rng.integers(0, vocab, (3, 20))
    # request 2 repeats request 0's leading blocks: a prefix hit
    return [base[0], base[1], base[0][:18], base[2], rng.integers(0, vocab, 9)]


def _drive(llm, prompts, sps):
    for p, sp in zip(prompts, sps):
        llm.add_request(p, sp)
    done = {}
    while llm.has_unfinished():
        for o in llm.step():
            if o.finished:
                done[o.rid] = o
    return [done[i] for i in range(len(prompts))]


# a pool of 20 pages of 4 tokens for 3 slots: requests are preempted
ENGINE = dict(backend="continuous", max_len=48, num_slots=3, page_size=4,
              prefill_chunk=8, num_pages=20)


def test_continuous_streams_match_reference(phi3):
    """f32 greedy and sampled streams of ``LLMEngine(backend="continuous")``
    through chunked prefill, a prefix hit and preemption equal the
    reference engine's; one request's prompt scores too."""
    cfg, ref, params, port = phi3
    prompts = _prompts(cfg.vocab_size)
    kws = [dict(SAMPLING[0], prompt_logprobs=True)] + SAMPLING[1:] + [dict()]
    want = _drive(RefLLM(ref, params, cache_dtype=jnp.float32, **ENGINE),
                  prompts, [RefSP(max_tokens=12, **kw) for kw in kws])
    llm = LLMEngine(port, device="cpu", cache_dtype=torch.float32, **ENGINE)
    got = _drive(llm, prompts, [SamplingParams(max_tokens=12, **kw)
                                for kw in kws])
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids, (g.rid, w.token_ids, g.token_ids)
    np.testing.assert_allclose(got[1].logprobs, want[1].logprobs, atol=1e-5)
    np.testing.assert_allclose(got[0].prompt_logprobs,
                               want[0].prompt_logprobs, rtol=0, atol=1e-5)
    stats = llm.stats()
    assert stats.preemptions > 0, "the pool no longer forces a preemption"
    assert stats.prefix_hit_tokens > 0, "no prefix-cache hit"


def test_static_and_legacy_speculative_match_reference(reduced):
    """``LLMEngine(backend="static")`` (with prompt scores) and the legacy
    ``backend="speculative"`` (self-draft) give the reference's streams;
    the static scores are the continuous engine's."""
    cfg, ref, params, port = reduced
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, 12) for _ in range(4)]
    kws = [dict(SAMPLING[0], prompt_logprobs=True)] + SAMPLING[1:]
    want = RefLLM(ref, params, backend="static", max_len=32,
                  cache_dtype=jnp.float32).generate(
        prompts, [RefSP(max_tokens=8, **kw) for kw in kws])
    static = LLMEngine(port, backend="static", device="cpu", max_len=32,
                       cache_dtype=torch.float32)
    got = static.generate(prompts, [SamplingParams(max_tokens=8, **kw)
                                    for kw in kws])
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids and g.finish_reason == w.finish_reason
    np.testing.assert_allclose(got[0].prompt_logprobs,
                               want[0].prompt_logprobs, rtol=0, atol=1e-5)
    (cont,) = LLMEngine(port, device="cpu", cache_dtype=torch.float32,
                        **ENGINE).generate(
        prompts[:1], SamplingParams(max_tokens=8, prompt_logprobs=True))
    assert cont.token_ids == got[0].token_ids
    np.testing.assert_allclose(cont.prompt_logprobs, got[0].prompt_logprobs,
                               rtol=0, atol=1e-5)
    sps = [dict(max_tokens=12), dict(max_tokens=12, temperature=1.2, seed=7,
                                     top_p=0.95)]
    want = RefLLM(ref, params, backend="speculative", max_len=64,
                  gamma=4).generate(prompts[:2], [RefSP(**kw) for kw in sps])
    got = LLMEngine(port, backend="speculative", device="cpu", max_len=64,
                    gamma=4).generate(prompts[:2], [SamplingParams(**kw)
                                                    for kw in sps])
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids
        assert g.metrics["windows"] == w.metrics["windows"]


def test_self_draft_speculation_equals_plain_and_reference(phi3):
    """``speculative=SpeculativeConfig(gamma=4)``, self-draft, f32: the
    verify step's multi-query path gives the plain engine's greedy streams
    and accepts every proposal; greedy and sampled streams and acceptance
    counts equal the reference's speculative engine's."""
    cfg, ref, params, port = phi3
    prompts = _prompts(cfg.vocab_size)[:3]
    kw = dict(max_len=48, num_slots=3, page_size=4, prefill_chunk=8,
              num_pages=40)
    greedy = [SamplingParams(max_tokens=10)] * len(prompts)
    spec = LLMEngine(port, device="cpu", cache_dtype=torch.float32,
                     backend="continuous",
                     speculative=SpeculativeConfig(gamma=4), **kw)
    plain = LLMEngine(port, device="cpu", cache_dtype=torch.float32,
                      backend="continuous", **kw)
    a = spec.generate(prompts, greedy)
    assert [o.token_ids for o in a] == \
        [o.token_ids for o in plain.generate(prompts, greedy)]
    st = spec.last_stats
    assert st.spec_windows > 0 and st.spec_accepted == st.spec_drafted
    sps = [dict(max_tokens=10), dict(max_tokens=10, temperature=0.9, seed=3),
           dict(max_tokens=10, temperature=1.1, top_k=20, seed=4)]
    want = RefLLM(ref, params, cache_dtype=jnp.float32, backend="continuous",
                  speculative=RefSpecConfig(gamma=4), **kw).generate(
        prompts, [RefSP(**s) for s in sps])
    got = spec.generate(prompts, [SamplingParams(**s) for s in sps])
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        assert g.metrics["spec_accepted"] == w.metrics["spec_accepted"]
