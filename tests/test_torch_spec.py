"""Speculative decoding in the port against the JAX reference on the CPU:
the sampling helpers of the draft/verify window (bit-equal uniforms, a
tied-logit row), the acceptance rule's statistics, the continuous engine's
``speculative=`` mode (greedy and sampled streams and per-request
acceptance counts, self-draft and a separate 1-layer draft, through forced
preemption and a prefix hit; also over int8 and fp8 code pools, with and
without mxfp4 weights, on reduced qwen3-14b), the multi-token decode's
chunk-shaped layer path, the legacy ``LLMEngine(backend="speculative")``,
and the refusals.

Weights are cast to f32 on both sides and the page pools are f32 (see
test_torch_engine.py: in bf16 a near-tied argmax of a random-weight model
may flip between the frameworks).  The legacy backend keeps its bf16 dense
caches, as the reference's does."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced_config
from repro.models.model import build_model
from repro.quant import formats as jformats
from repro.quant.linear import quantizable_leaf
from repro.runtime import sampling as ref_sampling
from repro.runtime.engine import ContinuousServeEngine as RefEngine
from repro.runtime.llm import LLMEngine as RefLLM
from repro.runtime.sampling import SamplingParams as RefSP
from repro.runtime.scheduler import Request as RefRequest
from repro.runtime.speculative import SpeculativeConfig as RefSpecConfig
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.models.model import Model
from repro_torch.runtime import prng, sampling
from repro_torch.runtime.engine import ContinuousServeEngine
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.speculative import SpeculativeConfig

GAMMA = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# sampling helpers
# ---------------------------------------------------------------------------


def _slot_case():
    rng = np.random.default_rng(0)
    b, v = 6, 300
    lg = (rng.standard_normal((b, v)) * 2).astype(np.float32)
    lg[2, [10, 20, 30]] = lg[2].max() + 1.0       # a tie at the top
    lg[3] = 0.5                                   # every logit tied
    lg[4, 100:140] = lg[4].max() + 1.0            # a tie across the top-k cut
    temp = np.array([0.0, 0.8, 1.0, 0.7, 1.3, 0.9], np.float32)
    topk = np.array([0, 5, 0, 0, 8, 3], np.int32)
    topp = np.array([1.0, 0.9, 1.0, 0.5, 0.95, 1.0], np.float32)
    minp = np.array([0.0, 0.0, 0.05, 0.0, 0.0, 0.1], np.float32)
    return lg, (temp, topk, topp, minp)


def test_slot_dist_slot_draw_spec_uniform_match_reference():
    lg, params = _slot_case()
    want = np.array(ref_sampling.slot_dist(
        jnp.asarray(lg), *(jnp.asarray(a) for a in params)))
    got = sampling.slot_dist(torch.from_numpy(lg),
                             *(torch.from_numpy(a) for a in params)).numpy()
    # same support (ties broken lower index first, as lax.top_k), the same
    # probabilities up to exp/logsumexp rounding
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    seed = np.arange(6, dtype=np.int32) * 7
    pos = np.arange(6, dtype=np.int32) + 100
    for tag in (sampling.TAG_PROPOSE, sampling.TAG_ACCEPT,
                sampling.TAG_CORRECT):
        uw = np.asarray(ref_sampling.spec_uniform(jnp.asarray(seed),
                                                  jnp.asarray(pos), tag))
        ug = sampling.spec_uniform(torch.from_numpy(seed),
                                   torch.from_numpy(pos), tag).numpy()
        np.testing.assert_array_equal(ug.view(np.int32), uw.view(np.int32))
        np.testing.assert_array_equal(
            sampling.slot_draw(torch.from_numpy(want),
                               torch.from_numpy(ug)).numpy(),
            np.asarray(ref_sampling.slot_draw(jnp.asarray(want),
                                              jnp.asarray(uw))))
    assert (sampling.TAG_PROPOSE, sampling.TAG_ACCEPT, sampling.TAG_CORRECT) \
        == (ref_sampling.TAG_PROPOSE, ref_sampling.TAG_ACCEPT,
            ref_sampling.TAG_CORRECT)


@pytest.mark.parametrize("kw", [
    dict(), dict(temperature=0.8, top_k=7), dict(temperature=1.1, top_p=0.8,
                                                 min_p=0.02),
    dict(temperature=0.9, top_p=0.999)])
def test_dist_and_draw_match_reference(kw):
    lg, _ = _slot_case()
    want = np.array(ref_sampling.dist(jnp.asarray(lg), RefSP(**kw)))
    got = sampling.dist(torch.from_numpy(lg), SamplingParams(**kw)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for seed in range(4):
        k = jax.random.PRNGKey(seed)
        tk = prng.prng_key(torch.tensor(seed))
        assert np.asarray(ref_sampling.draw(k, jnp.asarray(want))).tolist() \
            == sampling.draw(tk, torch.from_numpy(want)).tolist()


def test_prng_split_and_shaped_draws_match_jax():
    for seed in (0, 7, 12345):
        k = jax.random.PRNGKey(seed)
        tk = prng.prng_key(torch.tensor(seed))
        np.testing.assert_array_equal(
            prng.split(tk, 5).numpy(),
            np.asarray(jax.random.split(k, 5)).astype(np.int64))
        np.testing.assert_array_equal(
            prng.uniform_shaped(tk, (3, 7)).numpy().view(np.int32),
            np.asarray(jax.random.uniform(k, (3, 7))).view(np.int32))
        tiny = float(np.finfo(np.float32).tiny)
        np.testing.assert_array_equal(
            prng.uniform_shaped(tk, (2, 50), tiny, 1.0).numpy().view(np.int32),
            np.asarray(jax.random.uniform(k, (2, 50), minval=tiny)).view(
                np.int32))
        # the two logs are each framework's own: within an ulp or two
        np.testing.assert_allclose(prng.gumbel(tk, (1, 300)).numpy(),
                                   np.asarray(jax.random.gumbel(k, (1, 300))),
                                   rtol=1e-6, atol=1e-6)


def test_acceptance_rate_matches_analytic_min_p_over_q():
    """Monte-Carlo over the port's own primitives (slot_dist, slot_draw,
    spec_uniform tags): the acceptance rate converges to sum_t q(t) min(1,
    p(t)/q(t)), and the emitted marginal (accepted proposals + residual
    corrections) to p itself."""
    v, n = 12, 4096
    rng = np.random.default_rng(20)
    lq = torch.from_numpy(rng.standard_normal((1, v)).astype(np.float32) * 1.5)
    lp = torch.from_numpy(rng.standard_normal((1, v)).astype(np.float32) * 1.5)
    one = torch.ones(n)
    zero_i = torch.zeros(n, dtype=torch.int32)
    q = sampling.slot_dist(lq.repeat(n, 1), one, zero_i, one, one * 0.0)
    p = sampling.slot_dist(lp.repeat(n, 1), one, zero_i, one, one * 0.0)
    pos = torch.arange(n, dtype=torch.int32)
    prop = sampling.slot_draw(q, sampling.spec_uniform(0, pos,
                                                       sampling.TAG_PROPOSE))
    rows = torch.arange(n)
    ratio = p[rows, prop.long()] / q[rows, prop.long()].clamp_min(1e-20)
    accept = (sampling.spec_uniform(0, pos, sampling.TAG_ACCEPT)
              < ratio.clamp_max(1.0)).numpy()
    analytic = float((q[0] * (p[0] / q[0].clamp_min(1e-20)).clamp_max(1.0)
                      ).sum())
    se = np.sqrt(analytic * (1 - analytic) / n)
    assert abs(accept.mean() - analytic) < 4 * se + 1e-6
    resid = (p - q).clamp_min(0.0)
    resid = resid / resid.sum(-1, keepdim=True).clamp_min(1e-20)
    corr = sampling.slot_draw(resid, sampling.spec_uniform(
        0, pos, sampling.TAG_CORRECT))
    out = np.where(accept, prop.numpy(), corr.numpy())
    emp = np.bincount(out, minlength=v) / n
    tv = 0.5 * np.abs(emp - p[0].numpy()).sum()
    assert tv < 0.05, f"total variation {tv:.3f} vs target p"


# ---------------------------------------------------------------------------
# the continuous engine's speculative= mode against the reference's
# ---------------------------------------------------------------------------


def _bridge(params, cfg):
    return params_from_jax(jax.tree.map(np.asarray, params), cfg,
                           device="cpu").float()


def _f32(params):
    return jax.tree.map(lambda a: a.astype(jnp.float32), params)


@pytest.fixture(scope="module")
def models():
    cfg = reduced_config(get_config("llama3-8b"))
    tcfg = tconfigs.reduced_config(tconfigs.get_config("llama3-8b"))
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    dcfg = dataclasses.replace(cfg, name=cfg.name + "-draft", n_layers=1)
    dref = build_model(dcfg)
    dparams = dref.init(jax.random.PRNGKey(3))
    port = _bridge(params, tcfg)
    dport = _bridge(dparams, dataclasses.replace(tcfg, name=dcfg.name,
                                                 n_layers=1))
    return dict(cfg=cfg, ref=ref, params=_f32(params), dref=dref,
                dparams=_f32(dparams), port=port, dport=dport)


ENGINE = dict(num_slots=3, page_size=4, max_len=24, prefill_chunk=5)
SAMPLING = [dict(), dict(temperature=0.9, top_k=8, top_p=0.95, seed=100),
            dict(), dict(temperature=1.0, seed=9, repetition_penalty=1.3,
                         logit_bias={3: 2.0}, logprobs=True)]


def _prompts(vocab):
    return np.random.default_rng(1).integers(0, vocab, (4, 12)).astype(
        np.int32)


def _ref_run(m, draft, num_pages, requests):
    sc = (RefSpecConfig(gamma=GAMMA) if draft == "self" else
          RefSpecConfig(draft_model=m["dref"], draft_params=m["dparams"],
                        gamma=GAMMA)) if draft else None
    eng = RefEngine(m["ref"], m["params"], num_pages=num_pages,
                    cache_dtype=jnp.float32, speculative=sc, **ENGINE)
    return eng.run([RefRequest(rid=r, prompt=p, max_new_tokens=8,
                               sampling=RefSP(**kw), arrival_time=t)
                    for r, p, kw, t in requests])


def _port_engine(m, draft, num_pages):
    sc = (SpeculativeConfig(gamma=GAMMA) if draft == "self" else
          SpeculativeConfig(draft_model=m["dport"], gamma=GAMMA)) \
        if draft else None
    return ContinuousServeEngine(m["port"], device="cpu", num_pages=num_pages,
                                 cache_dtype=torch.float32, speculative=sc,
                                 **ENGINE)


def _port_run(m, draft, num_pages, requests):
    return _port_engine(m, draft, num_pages).run(
        [Request(rid=r, prompt=p, max_new_tokens=8,
                 sampling=SamplingParams(**kw), arrival_time=t)
         for r, p, kw, t in requests])


@pytest.mark.parametrize("draft", ["self", "separate"])
def test_spec_streams_and_acceptance_match_reference_through_preemption(
        models, draft):
    """A pool of 9 pages forces preemption restarts mid-stream; greedy and
    sampled streams, logprobs and every request's acceptance count equal
    the reference's."""
    toks = _prompts(models["cfg"].vocab_size)
    reqs = [(i, toks[i], SAMPLING[i], 0.0) for i in range(4)]
    want = _ref_run(models, draft, 9, reqs)
    got = _port_run(models, draft, 9, reqs)
    assert got.preemptions > 0, "the pool no longer forces a preemption"
    for i in range(4):
        np.testing.assert_array_equal(got.results[i], want.results[i])
        for key in ("spec_windows", "spec_accepted"):
            assert got.per_request[i][key] == want.per_request[i][key], key
    np.testing.assert_allclose(got.outputs[3].logprobs,
                               want.outputs[3].logprobs, atol=1e-5)
    assert (got.spec_windows, got.spec_drafted, got.spec_accepted) == (
        want.spec_windows, want.spec_drafted, want.spec_accepted)
    if draft == "self":
        # greedy rows accept every proposal whatever the pool; sampled ones
        # too (a self-draft scores q == p)
        assert got.spec_accepted > 0
    else:
        assert got.spec_accepted < got.spec_drafted


def test_spec_greedy_equals_plain_engine_and_counters(models):
    """Within the port: greedy speculation emits the plain engine's stream
    (self-draft: gamma accepted in every window), and the counters add up
    across requests, outputs and the session."""
    toks = _prompts(models["cfg"].vocab_size)
    reqs = [(i, toks[i], {}, 0.0) for i in range(4)]
    plain = _port_run(models, None, 64, reqs)
    for draft in ("self", "separate"):
        got = _port_run(models, draft, 64, reqs)
        for i in range(4):
            np.testing.assert_array_equal(got.results[i], plain.results[i])
        assert got.spec_drafted == GAMMA * got.spec_windows
        if draft == "self":
            assert got.accepted_per_window == pytest.approx(GAMMA)
            assert got.spec_wasted == 0
        assert sum(r["spec_windows"] for r in got.per_request.values()) \
            == got.spec_windows
        assert sum(r["spec_accepted"] for r in got.per_request.values()) \
            == got.spec_accepted
        for o in got.outputs.values():
            assert o.metrics["spec_windows"] == \
                got.per_request[o.rid]["spec_windows"]
    assert plain.spec_windows == 0


@pytest.fixture(scope="module")
def qwen():
    """Reduced qwen3-14b (qk-norm) with its projection weights round-tripped
    through mxfp4, so that quantizing them again is idempotent (the
    reference's ``served`` fixture), in f32 on both sides."""
    cfg = reduced_config(get_config("qwen3-14b"))
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(5))

    def rt(path, leaf):
        if quantizable_leaf(path, leaf, "mxfp4"):
            p = jformats.quantize(leaf, "mxfp4")
            return jformats.dequantize(p, "mxfp4").astype(leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(rt, params)
    port = _bridge(params, tconfigs.reduced_config(
        tconfigs.get_config("qwen3-14b")))
    return cfg, ref, _f32(params), port


CODE_ENGINE = dict(num_slots=3, page_size=4, max_len=48, prefill_chunk=8)


@pytest.mark.parametrize("weight_format", [None, "mxfp4"])
@pytest.mark.parametrize("cache", ["int8", "fp8"])
def test_spec_code_pools_match_reference(qwen, cache, weight_format):
    """Speculation (self-draft, gamma 3) over int8 and fp8 code pools, with
    and without mxfp4 weights: a pool of 20 pages forces a preemption,
    requests 2 and 4 repeat earlier requests' leading pages (prefix hits);
    greedy and sampled streams, every request's windows and accepted
    proposals, and the session's totals equal the reference's."""
    cfg, ref, params, port = qwen
    rng = np.random.default_rng(0)
    base = rng.integers(0, cfg.vocab_size, (3, 20))
    prompts = [base[0], base[1], base[0][:18], base[2], base[1][:13]]
    kws = [dict(), dict(temperature=0.9, top_k=8, top_p=0.95, seed=101),
           dict(), dict(temperature=0.7, min_p=0.05, seed=5), dict()]
    want = RefEngine(ref, params, num_pages=20, cache_dtype=cache,
                     weight_format=weight_format,
                     speculative=RefSpecConfig(gamma=GAMMA),
                     **CODE_ENGINE).run([
                         RefRequest(rid=i, prompt=p, max_new_tokens=8,
                                    sampling=RefSP(**kw))
                         for i, (p, kw) in enumerate(zip(prompts, kws))])
    got = ContinuousServeEngine(
        port, device="cpu", num_pages=20, cache_dtype=cache,
        weight_format=weight_format, speculative=SpeculativeConfig(
            gamma=GAMMA), **CODE_ENGINE).run([
                Request(rid=i, prompt=p, max_new_tokens=8,
                        sampling=SamplingParams(**kw))
                for i, (p, kw) in enumerate(zip(prompts, kws))])
    assert got.preemptions > 0, "the pool no longer forces a preemption"
    assert got.prefix_hit_tokens > 0, "no prefix-cache hit"
    assert got.spec_windows > 0
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got.results[i], want.results[i])
        for key in ("spec_windows", "spec_accepted"):
            assert got.per_request[i][key] == want.per_request[i][key], key
    assert (got.spec_windows, got.spec_drafted, got.spec_accepted) == (
        want.spec_windows, want.spec_drafted, want.spec_accepted)


def _prefix_session(eng, request_cls, sp, prompt):
    """Request 1 repeats request 0's prompt and is added once request 0 has
    its first token (its prompt blocks indexed), so it is admitted through
    shared prefix pages.  Returns (streams, prefix-hit tokens)."""
    eng.add_request(request_cls(rid=0, prompt=prompt, max_new_tokens=8,
                                sampling=sp))
    done, added = {}, False
    while eng.has_unfinished() or not added:
        for o in eng.step():
            if o.finished:
                done[o.rid] = o.token_ids
            if o.rid == 0 and o.new_token_ids and not added:
                eng.add_request(request_cls(rid=1, prompt=prompt,
                                            max_new_tokens=8, sampling=sp))
                added = True
    return [done[0], done[1]], eng.cache.hit_tokens


def test_spec_prefix_hit_equals_plain(models):
    """port-spec == port-plain == reference-plain through a prefix hit."""
    prompt = _prompts(models["cfg"].vocab_size)[0]
    want, _ = _prefix_session(
        RefEngine(models["ref"], models["params"], num_pages=64,
                  cache_dtype=jnp.float32, **ENGINE), RefRequest, RefSP(),
        prompt)
    plain, _ = _prefix_session(_port_engine(models, None, 64), Request,
                               SamplingParams(), prompt)
    got, hits = _prefix_session(_port_engine(models, "separate", 64),
                                Request, SamplingParams(), prompt)
    assert hits > 0
    assert plain == want
    assert got == want


def test_chunk_shaped_multi_decode_matches_virtual_slots(models):
    """The multi-token decode's chunk-shaped layer path (what runs on the
    card; its attention here the plain multi-query oracle) gives the
    virtual-slot logits within 1e-5, and writes the same KV."""
    port = models["port"]
    rng = np.random.default_rng(4)
    b, c, page, nb = 3, GAMMA + 1, 4, 6
    pools = port.init_paged_cache(1 + b * nb, page, dtype=torch.float32)
    table = torch.arange(1, 1 + b * nb, dtype=torch.int32).reshape(b, nb)
    for pool in pools:                     # a resident history
        for leaf in pool.values():
            leaf.copy_(torch.from_numpy(rng.standard_normal(
                tuple(leaf.shape)).astype(np.float32)))
    tokens = torch.from_numpy(rng.integers(0, 256, (b, c)).astype(np.int32))
    pos = torch.tensor([0, 7, 19], dtype=torch.int32)
    valid = torch.tensor([c, c, 2], dtype=torch.int32)
    chunk_pools = [{k: v.clone() for k, v in p.items()} for p in pools]
    want = port.decode_step_paged(tokens, pools, table, pos, valid)
    got = port._decode_multi_chunked(tokens, chunk_pools, table, pos, valid)
    assert want.shape == got.shape == (b, c, port.cfg.padded_vocab)
    ok = torch.arange(c)[None, :] < valid[:, None]
    np.testing.assert_allclose(got[ok].numpy(), want[ok].numpy(), rtol=0,
                               atol=1e-5)
    for p_want, p_got in zip(pools, chunk_pools):
        np.testing.assert_allclose(p_got["k"][1:].numpy(),
                                   p_want["k"][1:].numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# LLMEngine: the legacy speculative backend, routing, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft", ["self", "separate"])
def test_legacy_speculative_backend_matches_reference(models, draft):
    toks = _prompts(models["cfg"].vocab_size)[:2, :10]
    sps = [dict(max_tokens=12), dict(max_tokens=12, temperature=1.2, seed=7,
                                     top_p=0.95)]
    dkw = {} if draft == "self" else dict(draft_model=models["dref"],
                                          draft_params=models["dparams"])
    want = RefLLM(models["ref"], models["params"], backend="speculative",
                  max_len=64, gamma=GAMMA, **dkw).generate(
        toks, [RefSP(**kw) for kw in sps])
    llm = LLMEngine(models["port"], backend="speculative", device="cpu",
                    max_len=64, gamma=GAMMA,
                    draft_model=None if draft == "self" else models["dport"])
    got = llm.generate(toks, [SamplingParams(**kw) for kw in sps])
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids
        assert g.finish_reason == w.finish_reason
        assert g.metrics["windows"] == w.metrics["windows"]
        assert g.metrics["accepted_per_window"] == pytest.approx(
            w.metrics["accepted_per_window"])


def test_llm_speculative_routes_to_continuous(models):
    toks = _prompts(models["cfg"].vocab_size)[:2, :8]
    kw = dict(max_len=24, num_slots=2, page_size=4,
              cache_dtype=torch.float32, device="cpu")
    llm = LLMEngine(models["port"], backend="continuous",
                    speculative=SpeculativeConfig(
                        draft_model=models["dport"], gamma=2), **kw)
    plain = LLMEngine(models["port"], backend="continuous", **kw)
    a = llm.generate(toks, max_new_tokens=6)
    b = plain.generate(toks, max_new_tokens=6)
    for i in range(2):
        assert a[i].token_ids == b[i].token_ids
        assert a[i].metrics["spec_windows"] > 0
    assert llm.last_stats.spec_windows > 0


def test_refusals(models):
    port = models["port"]
    with pytest.raises(ValueError, match="gamma"):
        SpeculativeConfig(gamma=0)
    with pytest.raises(ValueError, match="continuous"):
        LLMEngine(port, backend="static", device="cpu", max_len=24,
                  speculative=SpeculativeConfig(gamma=2))
    llm = LLMEngine(port, backend="speculative", device="cpu", max_len=24)
    prompt = [np.arange(8) % 256]
    for sp in (SamplingParams(repetition_penalty=1.2),
               SamplingParams(logit_bias={3: 1.0})):
        with pytest.raises(ValueError, match="repetition_penalty"):
            llm.generate(prompt, sp, max_new_tokens=4)
    with pytest.raises(ValueError, match="prompt"):
        llm.generate(prompt, SamplingParams(prompt_logprobs=True),
                     max_new_tokens=4)
    with pytest.raises(ValueError, match="continuous"):
        llm.add_request(prompt[0], max_new_tokens=2)
    with pytest.raises(ValueError, match="max_len"):
        LLMEngine(port, backend="continuous", device="cpu", max_len=24,
                  page_size=4, speculative=SpeculativeConfig(gamma=4)
                  ).generate([np.arange(12) % 256], max_new_tokens=12)
    with pytest.raises(ValueError, match="vocabulary"):
        other = dataclasses.replace(port.cfg, vocab_size=512,
                                    name="other-vocab")
        ContinuousServeEngine(port, device="cpu", num_pages=20,
                              speculative=SpeculativeConfig(
                                  draft_model=Model(other, device="cpu")),
                              **ENGINE)
