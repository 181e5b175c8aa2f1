"""h2o-danube-1.8b (every layer a sliding window, GQA at head dim 80) on
the CPU against the reference: the plain versions of the attention kernels
at D 80 with windows and ring tables, the static path (prefill into a ring
cache shorter than the prompt, decode steps that wrap it, ``forward``),
``ServeEngine`` / ``LLMEngine`` streams of every backend the reference
serves it through, the continuous engine's ring pages (residency bounds,
reclamation, a forced preemption storm), prompt scoring and the refusals.

Two configs: the reference's ``reduced_config`` (head dim 16, window 8)
and a narrow one at the real head dim (H 4, KVH 2, d_model 320, D 80,
window 8, 2 layers), which the reduced one never reaches.  Weights come
from the reference ``Model.init`` through ``bridge.params_from_jax``;
inputs from seeded numpy generators.  Tolerances: f32 throughout, logits
and caches within 1e-5 (XLA:CPU and PyTorch sum in other orders), token
streams identical, greedy and sampled; the reference's Pallas kernels run
in interpret mode, as its own tests run them."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp
import ml_dtypes

from repro.configs import get_config, reduced_config
from repro.kernels.decode_attention.ops import (
    gqa_decode_attention as jax_gqa_decode,
)
from repro.kernels.decode_attention.paged_kernel import (
    paged_decode_attention as jax_paged_kernel,
)
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as jax_decode_ref,
    paged_decode_attention_ref as jax_paged_ref,
    paged_decode_multi_attention_ref as jax_multi_ref,
)
from repro.kernels.flash_attention.ops import (
    gqa_flash_attention as jax_gqa_flash,
)
from repro.models.common import blocked_attention as jax_blocked
from repro.models.model import build_model
from repro.runtime.engine import ContinuousServeEngine as RefEngine
from repro.runtime.engine import ServeEngine as RefServeEngine
from repro.runtime.llm import LLMEngine as RefLLM
from repro.runtime.sampling import SamplingParams as RefSP
from repro.runtime.scheduler import Request as RefRequest
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
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import Model
from repro_torch.runtime.engine import ContinuousServeEngine, ServeEngine
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.speculative import SpeculativeConfig
from repro_torch.runtime.state_cache import ring_blocks_cap

DANUBE = "h2o-danube-1.8b"
NARROW = dict(n_heads=4, n_kv_heads=2, head_dim=80, d_model=320, n_layers=2,
              sliding_window=8)
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


def _configs(narrow: bool):
    jcfg = reduced_config(get_config(DANUBE))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(DANUBE))
    if narrow:
        jcfg = dataclasses.replace(jcfg, **NARROW)
        tcfg = dataclasses.replace(tcfg, **NARROW)
    return jcfg, tcfg


def _build(narrow: bool, seed: int = 0):
    """Reference model, its f32 params, and the port in f32 on its
    weights."""
    jcfg, tcfg = _configs(narrow)
    ref = build_model(jcfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(seed)))
    port = params_from_jax(params, tcfg, device="cpu").float()
    return (jcfg, ref, jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                                    params), port)


@pytest.fixture(scope="module", params=[False, True],
                ids=["reduced", "narrow_d80"])
def danube(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def reduced():
    return _build(False)


def _close(got: torch.Tensor, want, atol=1e-5):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


# ---------------------------------------------------------------------------
# the kernels' plain versions at D 80, with windows and ring tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 8, 37])
def test_flash_plain_version_with_window_at_d80(window, causal):
    """``flash_attention_ref`` through the GQA op: without a window against
    the reference's Pallas kernel (interpret mode) and ``blocked_attention``;
    with one against ``blocked_attention(window=)``, which the reference's
    kernel does not take."""
    rng = np.random.default_rng(window or 0)
    q = rng.standard_normal((2, 64, 4, 80)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 80)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 80)).astype(np.float32)
    got = gqa_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(got, jax_blocked(jq, jk, jv, causal=causal, window=window))
    if window is None:
        _close(got, jax_gqa_flash(jq, jk, jv, causal=causal, block_q=32,
                                  block_k=32))


@pytest.mark.parametrize("pos", [3, 7, 8, 13, 30])
def test_dense_decode_plain_version_over_a_wrapped_ring(pos):
    """The dense kernel's plain version over the first ``min(pos + 1, w)``
    entries of a ring of w = window entries is the reference's
    ``attn_decode``: its masked ring decode (``slot_pos`` validity with the
    window), and its Pallas dense kernel over the same prefix."""
    w, b, kvh, h, d = 8, 2, 2, 4, 80
    rng = np.random.default_rng(pos)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, w, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, w, kvh, d)).astype(np.float32)
    slot_pos = np.full(w, -1, np.int32)
    for t in range(max(0, pos - w + 1), pos + 1):
        slot_pos[t % w] = t
    k[:, slot_pos < 0], v[:, slot_pos < 0] = 1e4, -1e4   # never written
    valid = (slot_pos >= 0) & (slot_pos <= pos) & (slot_pos > pos - w)
    want = jax_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None, valid=jnp.asarray(np.repeat(valid[None], b,
                                                            0)))
    cur_len = torch.full((b,), min(pos + 1, w), dtype=torch.int32)
    got = gqa_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), cur_len)
    _close(got, want)
    _close(got, jax_gqa_decode(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(cur_len.numpy())))


def _ring_case(seed, window, page=4, b=3, h=4, kvh=2, d=80, n_blocks=10):
    """Pools with a poisoned scratch page 0 and a ring table: each row's
    blocks wholly behind its window (and past its position) point at page
    0, as ``RingPageSpace`` leaves them."""
    rng = np.random.default_rng(seed)
    P = 1 + b * n_blocks
    kp = rng.standard_normal((P, page, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((P, page, kvh, d)).astype(np.float32)
    kp[0], vp[0] = 1e4, -1e4
    pos = np.array([n_blocks * page - 1, window + 5, 2])[:b].astype(np.int32)
    table = rng.permutation(np.arange(1, P)).reshape(b, n_blocks)
    first = np.maximum(pos - window + 1, 0) // page
    blk = np.arange(n_blocks)[None, :]
    live = (blk >= first[:, None]) & (blk <= (pos // page)[:, None])
    table = np.where(live, table, 0).astype(np.int32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    return q, kp, vp, table, pos


def _fp8(a: np.ndarray):
    """Per-token fp8 codes and scales of the reference's KV quantizer."""
    from repro.quant import kv as jkvq
    codes, scales = jkvq.kv_quantize(jnp.asarray(a), "fp8")
    return np.array(codes), np.array(scales)


@pytest.mark.parametrize("pools", ["float32", "fp8"])
@pytest.mark.parametrize("window", [8, 13])
def test_paged_plain_versions_over_ring_tables_at_d80(window, pools):
    """The online plain version (``paged_decode_attention_ref``) and the
    exact multi-query one over a ring table whose early blocks are the
    poisoned scratch page, against the reference's refs and its online
    Pallas kernel (interpret mode), dense and fp8 pools."""
    q, kp, vp, table, pos = _ring_case(window, window)
    scales, jscales = {}, {}
    if pools == "fp8":
        kp, ks = _fp8(kp)
        vp, vs = _fp8(vp)
        ks[0], vs[0] = 1e4, -1e4
        scales = dict(k_scales=torch.from_numpy(ks),
                      v_scales=torch.from_numpy(vs))
        jscales = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
        tk = torch.from_numpy(kp.view(np.uint8)).view(torch.float8_e4m3fn)
        tv = torch.from_numpy(vp.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        tk, tv = torch.from_numpy(kp), torch.from_numpy(vp)
    tq, tt, tp = (torch.from_numpy(a) for a in (q, table, pos))
    jq, jk, jv, jt, jp = (jnp.asarray(a) for a in (q, kp, vp, table, pos))
    got = paged_gqa_decode_attention(tq, tk, tv, tt, tp, window=window,
                                     **scales)
    _close(got, jax_paged_ref(jq, jk, jv, jt, jp, window=window, **jscales))
    _close(got, jax_paged_kernel(jq, jk, jv, jt, jp, window=window,
                                 interpret=True, **jscales))
    # three queries a slot, ending at each row's position
    c = 3
    qm = np.random.default_rng(1).standard_normal(
        (q.shape[0], c, 4, 80)).astype(np.float32)
    start = np.maximum(pos - c + 1, 0).astype(np.int32)
    gotm = paged_gqa_multi_attention(torch.from_numpy(qm), tk, tv, tt,
                                     torch.from_numpy(start), window=window,
                                     **scales)
    _close(gotm, jax_multi_ref(jnp.asarray(qm), jk, jv, jt,
                               jnp.asarray(start), window=window, **jscales))


def test_kernels_take_head_dim_80():
    """Every attention kernel takes D 80 and picks its tensor-core (or
    wgmma) variant for bf16 there; f32 keeps the CUDA-core kernels."""
    bf, f32 = torch.bfloat16, torch.float32
    assert 80 in flash_kernel.HEAD_DIMS and 80 in dense_kernel.HEAD_DIMS
    assert 80 in paged_kernel.HEAD_DIMS and 80 in paged_kernel.TC_HEAD_DIMS
    assert flash_kernel.variant(bf, 80, 4) == "wgmma"
    assert flash_kernel.variant(f32, 80, 4) == "fma"
    assert dense_kernel.variant(bf, bf, 80) == "tensor_core"
    assert dense_kernel.variant(f32, f32, 80) == "cuda_core"
    for pool in (bf, torch.float8_e4m3fn, torch.int8):
        assert paged_kernel.variant(bf, pool, 80, 16) == "tensor_core"
    assert paged_kernel.variant(f32, f32, 80, 16) == "cuda_core"


# ---------------------------------------------------------------------------
# the static path
# ---------------------------------------------------------------------------


def test_static_prefill_decode_forward_match_reference(danube):
    """Prompts of 11 tokens (window 8): prefill keeps the ring's tail,
    decode steps wrap it; logits and caches (k, v, slot_pos) after the
    prefill and after six steps, and ``forward``'s logits, in f32."""
    cfg, ref, params, port = danube
    B, S, max_len = 2, 11, 24
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jcache = ref.init_cache(B, max_len, dtype=jnp.float32)
    tcache = port.init_cache(B, max_len, dtype=torch.float32)
    assert tcache[0]["k"].shape[1] == cfg.sliding_window

    def check_cache():
        seg = jcache[0][0]
        for i in range(cfg.n_layers):
            for key in ("k", "v"):
                _close(tcache[i][key], seg[key][i])
            np.testing.assert_array_equal(tcache[i]["slot_pos"].numpy(),
                                          np.asarray(seg["slot_pos"][i]))

    jl, jcache = ref.prefill(params, {"tokens": jnp.asarray(tokens)}, jcache)
    tl = port.prefill(torch.from_numpy(tokens), tcache)
    _close(tl, jl)
    check_cache()
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for pos in range(S, S + 6):
        jl, jcache = ref.decode_step(params, jnp.asarray(tok), jcache,
                                     jnp.int32(pos))
        _close(port.decode_step(torch.from_numpy(tok), tcache, pos), jl)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    check_cache()
    jf = ref.forward(params, {"tokens": jnp.asarray(tokens)})
    _close(port.forward(torch.from_numpy(tokens)), jf)


def test_static_engines_match_reference(reduced):
    """``ServeEngine.generate`` and ``LLMEngine(backend="static")``:
    greedy and sampled streams identical, logprobs and prompt scores within
    1e-5, for prompts longer than the window."""
    cfg, ref, params, port = reduced
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (4, 12))
    want = RefServeEngine(ref, params, max_len=24, donate_cache=False,
                          cache_dtype=jnp.float32).generate(
        {"tokens": jnp.asarray(toks)}, max_new_tokens=9,
        sampling_params=[RefSP(**kw) for kw in SAMPLING])
    got = ServeEngine(port, device="cpu", max_len=24,
                      cache_dtype=torch.float32).generate(
        {"tokens": toks}, max_new_tokens=9,
        sampling_params=[SamplingParams(**kw) for kw in SAMPLING])
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(want.logprobs),
                               rtol=0, atol=1e-5)
    kws = [dict(SAMPLING[0], prompt_logprobs=True)] + SAMPLING[1:]
    want = RefLLM(ref, params, backend="static", max_len=32,
                  cache_dtype=jnp.float32).generate(
        list(toks), [RefSP(max_tokens=8, **kw) for kw in kws])
    got = LLMEngine(port, backend="static", device="cpu", max_len=32,
                    cache_dtype=torch.float32).generate(
        list(toks), [SamplingParams(max_tokens=8, **kw) for kw in kws])
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids and g.finish_reason == w.finish_reason
    np.testing.assert_allclose(got[0].prompt_logprobs,
                               want[0].prompt_logprobs, rtol=0, atol=1e-5)


def test_legacy_speculative_matches_reference(reduced):
    """``LLMEngine(backend="speculative")`` over the dense ring caches,
    self-draft, greedy and sampled, as the reference serves it."""
    cfg, ref, params, port = reduced
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 10))
    sps = [dict(max_tokens=12), dict(max_tokens=12, temperature=1.2, seed=7,
                                     top_p=0.95)]
    want = RefLLM(ref, params, backend="speculative", max_len=64,
                  gamma=4).generate(toks, [RefSP(**kw) for kw in sps])
    got = LLMEngine(port, backend="speculative", device="cpu", max_len=64,
                    gamma=4).generate(toks, [SamplingParams(**kw)
                                             for kw in sps])
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids
        assert g.metrics["windows"] == w.metrics["windows"]


# ---------------------------------------------------------------------------
# the continuous engine over ring pages
# ---------------------------------------------------------------------------

ENGINE = dict(max_len=48, num_slots=3, page_size=4, prefill_chunk=5,
              num_pages=20)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n) for n in (20, 13, 9, 17, 30)]


def _drive(llm, prompts, sps, preempt_every=0):
    """Serve through the incremental interface.  ``preempt_every``: every
    that many iterations, preempt the decoding request with the lowest rid
    that was not preempted yet (a ring layout never runs out of pages, so
    pressure cannot force it; once each, so every request finishes).
    After every iteration the ring's invariants hold; returns the finished
    outputs and, per iteration, each live slot's ring blocks (decoding
    slots, prefilling slots)."""
    for p, sp in zip(prompts, sps):
        llm.add_request(p, sp)
    eng = llm._eng
    done, live, it, hit = {}, [], 0, set()
    while llm.has_unfinished():
        it += 1
        if preempt_every and it % preempt_every == 0:
            dec = sorted((r for r in eng._sched.decoding()
                          if r.rid not in hit), key=lambda r: r.rid)
            if dec:
                hit.add(dec[0].rid)
                eng._sched.preempt(dec[0])
        for o in llm.step():
            if o.finished:
                done[o.rid] = o
        ring = eng.cache.ring
        ring.check()
        live.append((tuple(ring.live_blocks(r.slot)
                           for r in eng._sched.decoding()),
                     tuple(ring.live_blocks(r.slot)
                           for r in eng._sched.prefilling())))
    return [done[i] for i in range(len(prompts))], live


@pytest.mark.parametrize("preempt_every", [0, 3], ids=["plain", "storm"])
def test_continuous_streams_match_reference(danube, preempt_every):
    """f32 greedy and sampled streams of ``LLMEngine(backend="continuous")``
    equal the reference engine's, prompts longer than the window and
    chunked (chunk 5, page 4), with and without a forced preemption storm;
    the ring pages resident per step are the reference's, within
    ``ring_blocks_cap`` while decoding and the transient bound while
    prefilling; every page returns at the end."""
    cfg, ref, params, port = danube
    prompts = _prompts(cfg.vocab_size)
    sps = SAMPLING + [dict(temperature=1.0, seed=9, logit_bias={3: 2.0})]
    want, wlive = _drive(RefLLM(ref, params, cache_dtype=jnp.float32,
                                backend="continuous", **ENGINE), prompts,
                         [RefSP(max_tokens=14, **kw) for kw in sps],
                         preempt_every)
    llm = LLMEngine(port, device="cpu", cache_dtype=torch.float32,
                    backend="continuous", **ENGINE)
    got, live = _drive(llm, prompts,
                       [SamplingParams(max_tokens=14, **kw) for kw in sps],
                       preempt_every)
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids, (g.rid, w.token_ids, g.token_ids)
    np.testing.assert_allclose(got[1].logprobs, want[1].logprobs, atol=1e-5)
    assert live == wlive
    cap = ring_blocks_cap(cfg.sliding_window, ENGINE["page_size"])
    transient = -(-(cfg.sliding_window + ENGINE["prefill_chunk"])
                  // ENGINE["page_size"]) + 1
    assert max(max(d, default=0) for d, _ in live) <= cap
    assert max(max(p, default=0) for _, p in live) <= transient
    eng = llm._eng
    assert eng.cache.ring.allocator.num_live == 0
    assert eng.cache.allocator.num_live == 0
    stats = llm.stats()
    assert stats.chunks > len(prompts)
    assert (stats.preemptions > 0) == bool(preempt_every)


def test_residency_bounded_per_step_as_the_reference(reduced):
    """The reference's ``test_windowed_residency_bounded_per_step`` on the
    port: a 40-token stream (window 8, page 4) keeps at most
    ``ring_blocks_cap`` = 3 live ring blocks after every decode step,
    step for step the reference's numbers, and reclaims as it goes."""
    cfg, ref, params, port = reduced
    G = 40
    prompt = np.arange(1, 13, dtype=np.int32) % cfg.vocab_size
    kw = dict(num_slots=2, page_size=4, num_pages=17, max_len=64,
              prefill_chunk=5)

    def run(eng, req_cls):
        eng.add_request(req_cls(rid=0, prompt=prompt, max_new_tokens=G))
        seen = []
        while eng.has_unfinished():
            eng.step()
            eng.cache.ring.check()
            seen.append(tuple(eng.cache.ring.live_blocks(r.slot)
                              for r in eng._sched.decoding()))
        return seen, eng.cache.ring.allocator.num_live

    want, _ = run(RefEngine(ref, params, **kw), RefRequest)
    got, left = run(ContinuousServeEngine(port, device="cpu", **kw), Request)
    assert ring_blocks_cap(cfg.sliding_window, 4) == 3
    assert got == want
    assert max(max(s, default=0) for s in got) <= 3
    assert sum(bool(s) for s in got) >= G - 3
    assert left == 0


def test_prompt_logprobs_match_reference_and_forward(reduced):
    """Continuous prompt scores (chunked, ring pages) equal the
    reference's and the static backend's ``Model.forward`` scores."""
    cfg, ref, params, port = reduced
    prompts = _prompts(cfg.vocab_size)[:3]
    want = RefLLM(ref, params, cache_dtype=jnp.float32, backend="continuous",
                  **ENGINE).generate(prompts, RefSP(max_tokens=3,
                                                    prompt_logprobs=True))
    sp = SamplingParams(max_tokens=3, prompt_logprobs=True)
    got = LLMEngine(port, device="cpu", cache_dtype=torch.float32,
                    backend="continuous", **ENGINE).generate(prompts, sp)
    static = LLMEngine(port, backend="static", device="cpu", max_len=48,
                       cache_dtype=torch.float32)
    for p, w, g in zip(prompts, want, got):
        assert g.token_ids == w.token_ids
        assert len(g.prompt_logprobs) == len(p) - 1
        np.testing.assert_allclose(g.prompt_logprobs, w.prompt_logprobs,
                                   rtol=0, atol=1e-5)
        (s,) = static.generate([p], sp)
        np.testing.assert_allclose(g.prompt_logprobs, s.prompt_logprobs,
                                   rtol=0, atol=1e-5)


def test_continuous_equals_static_greedy():
    """Within the port, bf16: the continuous engine over ring pages gives
    the static engine's ring-cache greedy stream token for token (the
    reference's ``test_continuous_engine_matches_static_greedy_sliding_
    window``: prompts of 12 > window 8, chunk 5, page 4)."""
    cfg = tconfigs.reduced_config(tconfigs.get_config(DANUBE))
    model = Model(cfg, device="cpu").init(0)
    B, S, G = 3, 12, 8
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    sp = SamplingParams(max_tokens=G)
    static = LLMEngine(model, backend="static", device="cpu",
                       max_len=S + G + 1)
    cont = LLMEngine(model, backend="continuous", device="cpu",
                     max_len=S + G + 1, num_slots=B, page_size=4,
                     num_pages=48, prefill_chunk=5)
    assert ([o.token_ids for o in static.generate(list(toks), sp)]
            == [o.token_ids for o in cont.generate(list(toks), sp)])


def test_refusals_and_prefix_cache(reduced):
    """As the reference: no ``speculative=`` and no disaggregated phase for
    a ring layout (its reasons), the prefix cache off with no full-KV
    segment; mamba2 and hymba, given as the reference's config fields,
    build the reference's plans (their ``ssm`` and ``hybrid`` kinds are
    ported)."""
    cfg, ref, params, port = reduced
    for kw, match in ((dict(speculative=SpeculativeConfig(gamma=2)),
                       "speculative decoding is unsupported"),
                      (dict(phase="prefill"),
                       "disaggregated serving is unsupported")):
        with pytest.raises(NotImplementedError, match=match):
            ContinuousServeEngine(port, device="cpu", **ENGINE, **kw)
    with pytest.raises(NotImplementedError, match="speculative"):
        RefEngine(ref, params, **ENGINE,
                  speculative=RefSpecConfig(gamma=2))
    with pytest.raises(NotImplementedError, match="reclaimed ring pages"):
        LLMEngine(port, device="cpu", backend="continuous",
                  speculative=SpeculativeConfig(gamma=2), **ENGINE)
    eng = ContinuousServeEngine(port, device="cpu", enable_prefix_cache=True,
                                **ENGINE)
    assert eng.enable_prefix_cache is False
    prompt = np.arange(1, 13, dtype=np.int32) % cfg.vocab_size
    stats = eng.run([Request(rid=i, prompt=prompt.copy(), max_new_tokens=4,
                             arrival_time=0.0) for i in range(3)])
    assert stats.prefix_hit_tokens == 0
    assert len({tuple(stats.results[i]) for i in range(3)}) == 1
    for name in ("mamba2-370m", "hymba-1.5b"):
        jcfg = reduced_config(get_config(name))
        model = Model(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
        assert [dataclasses.astuple(seg) for seg in model.plan] == \
            [dataclasses.astuple(seg) for seg in build_model(jcfg).plan]
        assert model.needs_state
