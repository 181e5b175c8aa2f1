"""deepseek-v2-lite-16b (MLA + MoE) served by the port's ``LLMEngine`` on
the CPU against the reference's, at the reduced config as it is (2 layers:
an ``mla_dense`` segment and an ``mla_moe`` segment) and with 3 layers
(the ``mla_moe`` segment stacks 2 reps).

Both sides get the reference's weights cast to f32 and f32 pools and
caches: a last-bit difference in bf16 can flip a routing choice or a
near-tied argmax of a random-weight model (ROADMAP Queue 3), so streams
are held equal in f32.  Covered: continuous serving, greedy and sampled,
through chunked prefill, prefix-cache hits and a forced preemption, with
``prompt_logprobs`` (within 1e-5) and logprobs (1e-5); static serving
with prompt scores; continuous ``speculative=`` (gamma 3, self-draft) and
the legacy ``backend="speculative"``; MXFP4 weights (the projections
round-tripped through mxfp4, as the reference's own quantized-serve
fixture does) against the reference's own mxfp4 run (greedy; logits within
2^-7 of the largest), with 4 MXFP4 calls in the dense layer and 2 in each
MoE layer; the quantizable leaves against
the reference's pytree paths; ``DeploymentSpec`` for the full config
against the reference's at 1e-12; and the refusal of fp8/int8 caches.
"""
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
from repro.quant.linear import quantizable_leaf as ref_quantizable
from repro.quant.linear import quantize_params as jquantize
from repro.runtime import deployment as jdep
from repro.runtime.llm import LLMEngine as RefLLM
from repro.runtime.sampling import SamplingParams as RefSP
from repro.runtime.speculative import SpeculativeConfig as RefSpecConfig
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.models.model import Model
from repro_torch.parallel.plan import paged_kv_token_bytes
from repro_torch.quant import linear
from repro_torch.runtime import deployment as tdep
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.speculative import SpeculativeConfig

NAME = "deepseek-v2-lite-16b"
GAMMA = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(n_layers):
    cfg = dataclasses.replace(reduced_config(get_config(NAME)),
                              n_layers=n_layers)
    tcfg = dataclasses.replace(tconfigs.reduced_config(
        tconfigs.get_config(NAME)), n_layers=n_layers)
    return cfg, tcfg


def _f32(params):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.float32), params)


@pytest.fixture(scope="module", params=[2, 3], ids=["2L", "3L"])
def models(request):
    cfg, tcfg = _configs(request.param)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(request.param))
    port = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                           device="cpu").float()
    return cfg, ref, _f32(params), port


ENGINE = dict(backend="continuous", max_len=40, num_slots=3, page_size=4,
              prefill_chunk=8, num_pages=16)
SAMPLING = [
    dict(),
    dict(temperature=0.9, top_k=8, top_p=0.95, seed=101, logprobs=True),
    dict(prompt_logprobs=True),
    dict(temperature=1.0, seed=9, repetition_penalty=1.3, logit_bias={3: 2.0}),
    dict(),
]


def _prompts(vocab, n=5):
    rng = np.random.default_rng(0)
    base = rng.integers(0, vocab, (3, 18))
    # request 2 repeats request 0's leading pages (a prefix hit once 0 is
    # indexed); request 4 shares 1's
    return [base[0], base[1], base[0][:17], base[2], base[1][:13]][:n]


def _drive(llm, prompts, sps):
    for p, sp in zip(prompts, sps):
        llm.add_request(p, sp)
    done = {}
    while llm.has_unfinished():
        for o in llm.step():
            if o.finished:
                done[o.rid] = o
    return [done[i] for i in range(len(prompts))]


def test_continuous_streams_match_reference(models):
    """Greedy and sampled streams equal through chunked prefill, prefix
    hits and a forced preemption; prompt scores and logprobs within
    1e-5."""
    cfg, ref, params, port = models
    prompts = _prompts(cfg.vocab_size)
    want = _drive(RefLLM(ref, params, cache_dtype=jnp.float32, **ENGINE),
                  prompts, [RefSP(max_tokens=10, **kw) for kw in SAMPLING])
    llm = LLMEngine(port, device="cpu", cache_dtype=torch.float32, **ENGINE)
    got = _drive(llm, prompts,
                 [SamplingParams(max_tokens=10, **kw) for kw in SAMPLING])
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids, (g.rid, w.token_ids, g.token_ids)
        assert g.finish_reason == w.finish_reason == "length"
    np.testing.assert_allclose(got[1].logprobs, want[1].logprobs, rtol=0,
                               atol=1e-5)
    assert len(got[2].prompt_logprobs) == len(prompts[2]) - 1
    np.testing.assert_allclose(got[2].prompt_logprobs,
                               want[2].prompt_logprobs, rtol=0, atol=1e-5)
    stats = llm.stats()
    assert stats.preemptions > 0, "the pool no longer forces a preemption"
    assert stats.prefix_hit_tokens > 0, "no prefix-cache hit"
    assert stats.chunks > len(prompts), "no prompt took more than one chunk"
    llm._eng.cache.allocator.check()


def test_static_streams_match_reference(models):
    """``backend="static"``: token ids and prompt scores (1e-5) as the
    reference's, and greedy static == greedy continuous within the
    port."""
    cfg, ref, params, port = models
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, 12) for _ in range(3)]
    kws = [dict(prompt_logprobs=True), SAMPLING[1], dict()]
    want = RefLLM(ref, params, backend="static", max_len=32,
                  cache_dtype=jnp.float32).generate(
        prompts, [RefSP(max_tokens=8, **kw) for kw in kws])
    got = LLMEngine(port, backend="static", device="cpu", max_len=32,
                    cache_dtype=torch.float32).generate(
        prompts, [SamplingParams(max_tokens=8, **kw) for kw in kws])
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        assert g.finish_reason == w.finish_reason
    np.testing.assert_allclose(got[0].prompt_logprobs,
                               want[0].prompt_logprobs, rtol=0, atol=1e-5)
    cont = LLMEngine(port, device="cpu", cache_dtype=torch.float32,
                     **dict(ENGINE, num_pages=64)).generate(
        prompts, SamplingParams(max_tokens=8))
    assert cont[0].token_ids == got[0].token_ids
    assert cont[2].token_ids == got[2].token_ids


def test_speculative_streams_match_reference(models):
    """Continuous ``speculative=`` (gamma 3, self-draft) through a
    preemption: streams, windows and accepted counts as the reference's;
    greedy speculation emits the plain engine's stream."""
    cfg, ref, params, port = models
    prompts = _prompts(cfg.vocab_size, 4)
    kws = [dict(), dict(temperature=0.9, top_k=8, seed=100), dict(), dict()]
    eng = dict(ENGINE, prefill_chunk=5)
    ref_llm = RefLLM(ref, params, cache_dtype=jnp.float32,
                     speculative=RefSpecConfig(gamma=GAMMA), **eng)
    want = ref_llm.generate(prompts,
                            [RefSP(max_tokens=9, **kw) for kw in kws])
    llm = LLMEngine(port, device="cpu", cache_dtype=torch.float32,
                    speculative=SpeculativeConfig(gamma=GAMMA), **eng)
    got = llm.generate(prompts, [SamplingParams(max_tokens=9, **kw)
                                 for kw in kws])
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        assert g.metrics["spec_windows"] == w.metrics["spec_windows"]
    assert llm.last_stats.spec_windows == ref_llm.last_stats.spec_windows > 0
    assert llm.last_stats.spec_accepted == ref_llm.last_stats.spec_accepted
    assert llm.last_stats.preemptions > 0, "no preemption"
    plain = LLMEngine(port, device="cpu", cache_dtype=torch.float32,
                      **eng).generate(prompts, SamplingParams(max_tokens=9))
    for i in (0, 2, 3):
        assert got[i].token_ids == plain[i].token_ids


def test_legacy_speculative_matches_reference(models):
    cfg, ref, params, port = models
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 10))
    sps = [dict(max_tokens=10), dict(max_tokens=10, temperature=1.2, seed=7,
                                     top_p=0.95)]
    want = RefLLM(ref, params, backend="speculative", max_len=48,
                  gamma=GAMMA).generate(toks, [RefSP(**kw) for kw in sps])
    got = LLMEngine(port, backend="speculative", device="cpu", max_len=48,
                    gamma=GAMMA).generate(toks,
                                          [SamplingParams(**kw) for kw in sps])
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids
        assert g.metrics["windows"] == w.metrics["windows"]


# ---------------------------------------------------------------------------
# MXFP4 weights
# ---------------------------------------------------------------------------


def _port_name(path) -> str | None:
    """The port's parameter name of a reference layer leaf (None for the
    top-level leaves), at rep 0 of its segment."""
    keys = [getattr(e, "key", getattr(e, "idx", None)) for e in path]
    if keys[0] != "stacks":
        return None
    return ".".join(str(k) for k in keys[1:])      # seg.kind.<subtree...>


def test_quantizable_leaves_match_reference_paths():
    """The leaves ``quantize_params`` packs, named by the port's modules,
    are the reference's by its pytree paths: wq/wo of every MLA layer and
    the dense layer's MLP, never ``w_dkv``/``w_uk``/``w_uv``, the router,
    the experts or the shared experts."""
    cfg, tcfg = _configs(3)
    ref = build_model(cfg)
    abstract = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    want = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(abstract):
        name = _port_name(path)
        if name is not None and ref_quantizable(path, leaf, "mxfp4"):
            want.add(name)
    port = Model(tcfg, device="meta")
    got = set()
    seg_of = {0: "0.0", 1: "1.0", 2: "1.0"}      # layer -> segment.kind
    for name, p in port.named_parameters():
        if linear.quantizable_leaf(name, p, "mxfp4"):
            _, i, rest = name.split(".", 2)
            got.add(f"{seg_of[int(i)]}.{rest}")
    assert got == want == {"0.0.attn.wq", "0.0.attn.wo", "0.0.mlp.w_gate",
                           "0.0.mlp.w_up", "0.0.mlp.w_down", "1.0.attn.wq",
                           "1.0.attn.wo"}


@pytest.fixture(scope="module")
def mxfp4_served():
    """Reduced deepseek (3 layers) whose projections are round-tripped
    through mxfp4, so quantizing them again is idempotent; f32 on both
    sides (the mxfp4 matmul still rounds x to bf16, on both sides)."""
    cfg, tcfg = _configs(3)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(5))

    def rt(path, leaf):
        if ref_quantizable(path, leaf, "mxfp4"):
            p = jformats.quantize(leaf, "mxfp4")
            return jformats.dequantize(p, "mxfp4").astype(leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(rt, params)
    port = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                           device="cpu").float()
    return cfg, ref, _f32(params), port


def test_mxfp4_streams_match_reference(mxfp4_served, monkeypatch):
    """Greedy streams equal to the reference's own mxfp4 run, and
    ``forward`` logits of the quantized views within 2 bf16 ulps (2^-7)
    of the largest |logit|: the mxfp4 matmul rounds its f32 input to bf16
    on both sides, so a last-bit difference upstream moves a product by a
    bf16 ulp now and then (measured: 7e-4 of the largest |logit|), which
    can move a top-k boundary of a sampled draw; sampled mxfp4 streams
    are therefore not held equal."""
    cfg, ref, params, port = mxfp4_served
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    jl = np.asarray(ref.forward(jquantize(params, "mxfp4"),
                                {"tokens": jnp.asarray(toks)}))
    tl = linear.quantize_params(port, "mxfp4")(torch.from_numpy(toks))
    assert np.abs(tl.numpy() - jl).max() <= 2.0 ** -7 * np.abs(jl).max()
    prompts = _prompts(cfg.vocab_size, 4)
    kws = [dict()] * 4
    want = RefLLM(ref, params, cache_dtype=jnp.float32,
                  weight_format="mxfp4", **ENGINE).generate(
        prompts, [RefSP(max_tokens=8, **kw) for kw in kws])
    calls = []
    for fn in ("mxfp4_matmul", "mxfp4_matmul_group"):
        real = getattr(linear, fn)
        monkeypatch.setattr(linear, fn, lambda x, w, *a, _r=real, **kw: (
            calls.append(x.shape[:-1]), _r(x, w, *a, **kw))[1])
    llm = LLMEngine(port, device="cpu", cache_dtype=torch.float32,
                    weight_format="mxfp4", **ENGINE)
    got = llm.generate(prompts, [SamplingParams(max_tokens=8, **kw)
                                 for kw in kws])
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    # every decode step and prefill call: wq, wo, gate/up (one group) and
    # w_down in the dense layer, wq and wo in each MoE layer
    per_call = 4 + 2 * (cfg.n_layers - 1)
    stats = llm.last_stats
    assert len(calls) == per_call * (stats.steps + stats.prefill_calls)


# ---------------------------------------------------------------------------
# deployments and refusals
# ---------------------------------------------------------------------------


def _numbers(dep) -> dict:
    out = {}
    for f in dataclasses.fields(dep):
        v = getattr(dep, f.name)
        if f.name in ("spec", "mesh", "cache_dtype"):
            continue
        if f.name == "device":
            out.update({f"device.{k}": x
                        for k, x in dataclasses.asdict(v).items()})
            continue
        out[f.name] = v
    out["pool_bytes_per_device"] = dep.pool_bytes_per_device
    return out


@pytest.mark.parametrize("fmt", [None, "mxfp4"])
def test_full_size_deployment_matches_reference(fmt):
    """deepseek-v2-lite-16b on one H100 from a ``meta`` model (exact
    weight bytes from its parameters' shapes; the reference:
    ``jax.eval_shape`` of its init) and from the footprint estimate:
    every numeric field at 1e-12; fp8 and int8 KV raise on both sides."""
    ref = build_model(get_config(NAME))
    abstract = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    port = Model(tconfigs.get_config(NAME), device="meta")
    skw = dict(sku="h100", weight_format=fmt, max_len=2048)
    for jp, tp in ((None, None), (abstract, port)):
        want = jdep.DeploymentSpec(**skw).resolve(ref, params=jp)
        got = tdep.DeploymentSpec(**skw).resolve(port, params=tp)
        g, w = _numbers(got), _numbers(want)
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], float) or isinstance(g[k], float):
                assert g[k] == pytest.approx(w[k], rel=1e-12, abs=0), k
            else:
                assert g[k] == w[k], k
        assert got.describe() == want.describe()
    assert paged_kv_token_bytes(port, cache_dtype=torch.bfloat16) == \
        27 * 576 * 2
    for cache in ("fp8", "int8"):
        with pytest.raises(jdep.DeploymentError, match="MLA"):
            jdep.DeploymentSpec(cache_dtype=cache, **skw).resolve(ref)
        with pytest.raises(tdep.DeploymentError, match="MLA"):
            tdep.DeploymentSpec(cache_dtype=cache, **skw).resolve(port)


@pytest.mark.parametrize("cache", ["fp8", "int8"])
def test_quantized_cache_is_refused(cache):
    """An MLA model never serves over a quantized KV cache: the
    continuous engine's latent pools raise naming MLA, the static engine
    refuses every quantized dense cache."""
    _, tcfg = _configs(2)
    port = Model(tcfg, device="cpu").init(0)
    llm = LLMEngine(port, device="cpu", cache_dtype=cache, **ENGINE)
    with pytest.raises(NotImplementedError, match="MLA"):
        llm.generate([[1, 2, 3]], SamplingParams(max_tokens=2))
    with pytest.raises(NotImplementedError, match="quantized KV"):
        LLMEngine(port, backend="static", device="cpu", cache_dtype=cache)
