"""The port's continuous-batching ``LLMEngine`` against the reference's on
the CPU: identical greedy and sampled token streams for a request mix
whose run goes through chunked prefill, a prefix-cache hit, a forced
preemption (a small page pool) and a defrag.

Both engines get the same weights, cast to f32 on both sides, and f32 page
pools.  In bf16 the two frameworks' differing exp/sin/cos round an
occasional intermediate to the neighbouring bf16 value (see
test_torch_model.py), which may flip a near-tied argmax of a random-weight
model; in f32 the logits agree to ~1e-6, so any stream difference is a
difference in the engine, the sampler or the kernels' plain versions."""
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
from repro.runtime.speculative import SpeculativeConfig as RefSpecConfig
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.runtime.deployment import DeploymentSpec
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.speculative import SpeculativeConfig


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
    dict(),
    dict(temperature=0.9, top_k=8, top_p=0.95, seed=101, logprobs=True),
    dict(),
    dict(temperature=0.7, top_p=0.8, min_p=0.05, seed=5),
    dict(temperature=1.0, seed=9, repetition_penalty=1.3, logit_bias={3: 2.0}),
    dict(repetition_penalty=1.2),
]


@pytest.fixture(scope="module")
def models():
    cfg = reduced_config(get_config("llama3-8b"))
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = params_from_jax(jax.tree.map(np.asarray, params),
                           tconfigs.reduced_config(
                               tconfigs.get_config("llama3-8b")),
                           device="cpu").float()
    return cfg, ref, jax.tree.map(lambda a: a.astype(jnp.float32), params), port


def _prompts(vocab):
    rng = np.random.default_rng(0)
    base = rng.integers(0, vocab, (3, 20))
    # request 2 repeats request 0's leading blocks (a prefix hit once 0 is
    # indexed); request 4 shares 1's
    return [base[0], base[1], base[0][:18], base[2], base[1][:13],
            rng.integers(0, vocab, 9)]


def _drive(llm, prompts, sps, defrag_every, defrags=None):
    """Serve through the incremental interface with defrag every few
    steps; ``defrags`` (port only) records whether each defrag moved a
    page."""
    for p, sp in zip(prompts, sps):
        llm.add_request(p, sp)
    llm._eng.defrag_every = defrag_every
    if defrags is not None:
        cache = llm._eng.cache
        real = cache.defrag

        def spy():
            gather = real()
            defrags.append(gather is not None)
            return gather
        cache.defrag = spy
    done = {}
    while llm.has_unfinished():
        for o in llm.step():
            if o.finished:
                done[o.rid] = o
    return [done[i] for i in range(len(prompts))]


def test_streams_match_reference_through_prefix_preemption_defrag(models):
    cfg, ref, ref_params, port = models
    prompts = _prompts(cfg.vocab_size)
    ref_llm = RefLLM(ref, ref_params, cache_dtype=jnp.float32, **ENGINE)
    want = _drive(ref_llm, prompts,
                  [RefSP(max_tokens=12, **kw) for kw in SAMPLING], 3)

    llm = LLMEngine(port, device="cpu", cache_dtype=torch.float32, **ENGINE)
    defrags = []
    got = _drive(llm, prompts,
                 [SamplingParams(max_tokens=12, **kw) for kw in SAMPLING], 3,
                 defrags)

    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids, (g.rid, w.token_ids, g.token_ids)
        assert g.finish_reason == w.finish_reason == "length"
    np.testing.assert_allclose(got[1].logprobs, want[1].logprobs, atol=1e-5)
    stats = llm.stats()
    assert stats.preemptions > 0, "the pool no longer forces a preemption"
    assert stats.prefix_hit_tokens > 0, "no prefix-cache hit"
    assert stats.chunks > len(prompts), "no prompt took more than one chunk"
    assert any(defrags), "no defrag moved a page"
    llm._eng.cache.allocator.check()


def test_generate_matches_reference(models):
    cfg, ref, ref_params, port = models
    prompts = _prompts(cfg.vocab_size)[:4]
    sps = [dict(), dict(temperature=0.8, top_k=16, seed=3)] * 2
    want = RefLLM(ref, ref_params, cache_dtype=jnp.float32, **ENGINE).generate(
        prompts, [RefSP(max_tokens=6, **kw) for kw in sps])
    llm = LLMEngine(port, device="cpu", cache_dtype=torch.float32, **ENGINE)
    got = llm.generate(prompts, [SamplingParams(max_tokens=6, **kw)
                                 for kw in sps])
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert llm.last_stats.steps > 0


@pytest.mark.parametrize("gamma", [None, 3])
def test_stop_token_ids_match_reference(models, gamma):
    """Continuous ``stop_token_ids``, greedy and sampled, plain and under
    ``speculative=`` (self-draft, gamma 3, where a stop token may land
    inside an accepted window): each request's stop token is the fourth
    token of the reference's unstopped stream (an id that is never emitted
    rides along), and the finish reasons and streams equal the
    reference's."""
    cfg, ref, ref_params, port = models
    prompts = _prompts(cfg.vocab_size)[:4]
    kws = [dict(), dict(temperature=0.9, top_k=8, seed=7)] * 2
    ref_kw = dict(speculative=RefSpecConfig(gamma=gamma)) if gamma else {}
    kw = dict(speculative=SpeculativeConfig(gamma=gamma)) if gamma else {}
    free = RefLLM(ref, ref_params, cache_dtype=jnp.float32, **ref_kw,
                  **ENGINE).generate(prompts, [RefSP(max_tokens=10, **k)
                                               for k in kws])
    stops = [(int(o.token_ids[3]), cfg.vocab_size + 7) for o in free]
    want = RefLLM(ref, ref_params, cache_dtype=jnp.float32, **ref_kw,
                  **ENGINE).generate(prompts, [
                      RefSP(max_tokens=10, stop_token_ids=st, **k)
                      for k, st in zip(kws, stops)])
    got = LLMEngine(port, device="cpu", cache_dtype=torch.float32, **kw,
                    **ENGINE).generate(prompts, [
                        SamplingParams(max_tokens=10, stop_token_ids=st, **k)
                        for k, st in zip(kws, stops)])
    assert all(o.finish_reason == "stop" for o in want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert (g.token_ids, g.finish_reason) == (w.token_ids,
                                                   w.finish_reason), i
        assert g.token_ids[-1] == stops[i][0]


@pytest.mark.parametrize("kwargs,err,match", [
    # a spec's mesh is priced and served over the initialised world: in a
    # world of one process a 1x2 mesh names the world size
    pytest.param(dict(spec=DeploymentSpec(sku="h100", mesh="1x2")),
                 ValueError, "world size is 1", id="kwargs0-DeploymentSpec"),
    # serving needs a DeviceMesh over initialised ranks
    pytest.param(dict(mesh=object()), ValueError, "DeviceMesh",
                 id="kwargs1-Tensor parallelism"),
    pytest.param(dict(speculative=SpeculativeConfig(gamma=2),
                      spec=DeploymentSpec(sku="h100", mesh=(1, 2))),
                 ValueError, "world size is 1", id="kwargs2-DeploymentSpec"),
    pytest.param(dict(speculative=SpeculativeConfig(gamma=2), mesh=object()),
                 ValueError, "DeviceMesh", id="kwargs3-Tensor parallelism"),
    # disaggregation on a mesh serves too (test_torch_disagg_tp.py): its
    # phase engines need a DeviceMesh as well
    pytest.param(dict(disaggregate=True, mesh=object()), ValueError,
                 "DeviceMesh", id="kwargs4-Tensor parallelism"),
])
def test_unported_options_name_their_roadmap_item(models, kwargs, err, match):
    """Tensor-parallel serving is ported (``test_torch_tp.py`` serves on
    real ranks), and so is disaggregation across meshes
    (``test_torch_disagg_tp.py``): a mesh the world cannot hold or that is
    not a DeviceMesh raises ValueError, for a phase engine too."""
    port = models[3]
    with pytest.raises(err, match=match):
        LLMEngine(port, device="cpu", **{**ENGINE, **kwargs})


def test_disaggregated_serving_matches_reference(models):
    """``disaggregate=True`` builds the phase-split engine and serves the
    request mix (greedy and sampled) as the reference's disaggregated
    ``LLMEngine`` and the port's colocated one do; every request is handed
    off (its byte and page counters in test_torch_disagg.py)."""
    cfg, ref, ref_params, port = models
    prompts = _prompts(cfg.vocab_size)
    sps = [dict(), dict(temperature=0.8, top_k=16, seed=3)] * 3
    want = RefLLM(ref, ref_params, cache_dtype=jnp.float32, disaggregate=True,
                  **ENGINE).generate(prompts, [RefSP(max_tokens=8, **kw)
                                               for kw in sps])
    got = []
    for disaggregate in (True, False):
        llm = LLMEngine(port, device="cpu", cache_dtype=torch.float32,
                        disaggregate=disaggregate, **ENGINE)
        got.append(llm.generate(prompts, [SamplingParams(max_tokens=8, **kw)
                                          for kw in sps]))
        if disaggregate:
            assert llm.last_stats.handoffs >= len(prompts)
    for w, d, c in zip(want, *got):
        assert d.token_ids == w.token_ids == c.token_ids, d.rid


def test_prompt_scoring_and_devices(models):
    """Prompt scoring is served (its parity with the reference is in
    test_torch_prompt_scoring.py); a CUDA request without a card raises."""
    port = models[3]
    llm = LLMEngine(port, device="cpu", **ENGINE)
    (out,) = llm.generate([[1, 2, 3]], SamplingParams(max_tokens=2,
                                                      prompt_logprobs=True))
    assert len(out.prompt_logprobs) == 2
    assert all(v <= 0 for v in out.prompt_logprobs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LLMEngine(port, **ENGINE)
