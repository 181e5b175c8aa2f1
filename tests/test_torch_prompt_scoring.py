"""Prompt scoring (``SamplingParams.prompt_logprobs``) in the port's
continuous engine on the CPU.

The scores are held against the reference's continuous engine (f32
weights and pools on both sides, within 1e-5) for a request mix that
scores prompts over several prefill chunks, beside unscored requests in
the same chunk calls, greedy and sampled, through a forced preemption
(whose restart must not score the prompt twice); against the port's own
static scores (``Model.forward``); and a scored admission must draw the
first token an unscored one draws (bf16: the last-position logits come
from the same head call).  ``ContinuousStats.prefix_hit_rate`` and
``ttft_quantiles`` are the reference's too."""
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced_config
from repro.models.model import build_model
from repro.runtime.llm import LLMEngine as RefLLM
from repro.runtime.sampling import SamplingParams as RefSP
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENGINE = dict(backend="continuous", max_len=48, num_slots=3, page_size=4,
              prefill_chunk=8, num_pages=20)
SAMPLING = [
    dict(prompt_logprobs=True),
    dict(temperature=0.9, top_k=8, top_p=0.95, seed=101, logprobs=True),
    dict(prompt_logprobs=True, temperature=0.7, min_p=0.05, seed=5),
    dict(),
    dict(temperature=1.0, seed=9, prompt_logprobs=True),
    dict(prompt_logprobs=True, repetition_penalty=1.2),
]


@pytest.fixture(scope="module")
def models():
    cfg = reduced_config(get_config("llama3-8b"))
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    bf16 = params_from_jax(jax.tree.map(np.asarray, params),
                           tconfigs.reduced_config(
                               tconfigs.get_config("llama3-8b")),
                           device="cpu")
    port = params_from_jax(jax.tree.map(np.asarray, params), bf16.cfg,
                           device="cpu").float()
    return (cfg, ref, jax.tree.map(lambda a: a.astype(jnp.float32), params),
            port, bf16)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    base = rng.integers(0, vocab, (3, 20))
    # request 2 repeats request 0's leading blocks and request 4 shares
    # 1's: a scored request recomputes its prompt, an unscored one may
    # share it
    return [base[0], base[1], base[0][:18], base[2], base[1][:13],
            rng.integers(0, vocab, 9)]


def _drive(llm, prompts, sps):
    for p, sp in zip(prompts, sps):
        llm.add_request(p, sp)
    done = {}
    while llm.has_unfinished():
        for o in llm.step():
            if o.finished:
                done[o.rid] = o
    return [done[i] for i in range(len(prompts))]


def test_continuous_prompt_logprobs_match_reference(models):
    cfg, ref, ref_params, port, _ = models
    prompts = _prompts(cfg.vocab_size)
    want = _drive(RefLLM(ref, ref_params, cache_dtype=jnp.float32, **ENGINE),
                  prompts, [RefSP(max_tokens=10, **kw) for kw in SAMPLING])
    llm = LLMEngine(port, device="cpu", cache_dtype=torch.float32, **ENGINE)
    got = _drive(llm, prompts,
                 [SamplingParams(max_tokens=10, **kw) for kw in SAMPLING])
    stats = llm.stats()
    assert stats.preemptions > 0, "the pool no longer forces a preemption"
    assert stats.chunks > len(prompts), "no prompt took more than one chunk"
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.token_ids == w.token_ids, i
        if SAMPLING[i].get("prompt_logprobs"):
            assert len(g.prompt_logprobs) == len(prompts[i]) - 1
            np.testing.assert_allclose(g.prompt_logprobs, w.prompt_logprobs,
                                       rtol=0, atol=1e-5)
        else:
            assert g.prompt_logprobs is None and w.prompt_logprobs is None
    np.testing.assert_allclose(got[1].logprobs, want[1].logprobs, atol=1e-5)


def test_continuous_scores_equal_static_forward(models):
    """Within the port: the continuous engine's chunked scores are the
    static backend's ``Model.forward`` scores of the same prompt."""
    cfg, _, _, port, _ = models
    prompts = _prompts(cfg.vocab_size)
    sp = SamplingParams(max_tokens=3, prompt_logprobs=True)
    cont = LLMEngine(port, device="cpu", cache_dtype=torch.float32,
                     **ENGINE).generate(prompts, sp)
    static = LLMEngine(port, backend="static", device="cpu", max_len=48,
                       cache_dtype=torch.float32)
    for p, c in zip(prompts, cont):
        (s,) = static.generate([p], sp)
        np.testing.assert_allclose(c.prompt_logprobs, s.prompt_logprobs,
                                   rtol=0, atol=1e-5)
        assert c.token_ids == s.token_ids


def test_scoring_leaves_the_first_token_unchanged(models):
    """bf16 weights and pools: a scored and an unscored request with the
    same prompt and sampling draw the same first token (and, greedy, the
    same stream), in one chunk call and across sessions."""
    cfg, _, _, _, bf16 = models
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (19, 7, 12)]
    kws = [dict(), dict(temperature=0.8, top_k=16, seed=3), dict()]
    eng = dict(ENGINE, enable_prefix_cache=False, num_pages=64)
    plain = LLMEngine(bf16, device="cpu", **eng).generate(
        prompts, [SamplingParams(max_tokens=6, **kw) for kw in kws])
    both = LLMEngine(bf16, device="cpu", **eng).generate(
        prompts + prompts,
        [SamplingParams(max_tokens=6, **kw) for kw in kws]
        + [SamplingParams(max_tokens=6, prompt_logprobs=True, **kw)
           for kw in kws])
    for i, p in enumerate(plain):
        assert both[i].token_ids == p.token_ids
        assert both[i + 3].token_ids[0] == p.token_ids[0]
        if not kws[i]:
            assert both[i + 3].token_ids == p.token_ids
        plp = np.asarray(both[i + 3].prompt_logprobs)
        assert plp.shape == (len(prompts[i]) - 1,)
        assert np.isfinite(plp).all() and (plp <= 0).all()


def test_stats_prefix_hit_rate_and_ttft_quantiles(models):
    cfg, ref, ref_params, port, _ = models
    prompts = _prompts(cfg.vocab_size)
    ref_llm = RefLLM(ref, ref_params, cache_dtype=jnp.float32, **ENGINE)
    ref_llm.generate(prompts, RefSP(max_tokens=4))
    llm = LLMEngine(port, device="cpu", cache_dtype=torch.float32, **ENGINE)
    llm.generate(prompts, SamplingParams(max_tokens=4))
    got, want = llm.last_stats, ref_llm.last_stats
    assert got.prefix_hit_tokens > 0
    assert got.prefix_hit_rate == want.prefix_hit_rate
    q = got.ttft_quantiles()
    lat = got.latency_quantiles("ttft")
    assert q == (lat["p50"], lat["p99"], lat["mean"])
    assert 0 < q[0] <= q[1]
