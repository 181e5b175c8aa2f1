"""The port's static serve path on the CPU against the reference's:
``Model.forward``, ``Model.prefill`` into the dense cache and a chain of
``Model.decode_step``; ``ServeEngine.generate``; ``LLMEngine(backend=
"static")`` with finish reasons and prompt scores; static == continuous
within the port; mxfp4 weights; and the refusals.

Weights come from the reference ``Model.init`` through
``bridge.params_from_jax`` (reduced llama3-8b, qwen3-14b with qk-norm,
qwen2.5-14b with qkv bias, phi3-mini-3.8b with full MHA, and
h2o-danube-1.8b, whose every layer has a window of 8 that a 9-token
prompt's ring cache wraps; non-trivial biases and qk-norm weights).
Tolerances: in f32 (weights, activations and cache) logits within 1e-5,
cache entries within 1e-5, and token streams identical, greedy and sampled
(logprobs within 1e-5) — XLA:CPU and PyTorch sum in other orders.  In bf16
the frameworks' exp/sin/cos round an occasional intermediate to the
neighbouring bf16 value, so logits agree within 4 bf16 ulps (2^-6) of the
largest logit magnitude, as in test_torch_model.py, and the argmax agrees
wherever the reference's top-2 gap exceeds twice that bound: bf16 logits
tie or sit one ulp apart now and then, and either side may then take
either token (both sides then continue from the reference's argmax).
"""
import dataclasses

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
from repro.quant.linear import quantizable_leaf
from repro.runtime.engine import ServeEngine as RefServeEngine
from repro.runtime.llm import LLMEngine as RefLLM
from repro.runtime.sampling import SamplingParams as RefSP
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.models import layers
from repro_torch.models.model import Model
from repro_torch.runtime.deployment import DeploymentSpec
from repro_torch.runtime.engine import ServeEngine
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


ARCHS = ["llama3-8b", "qwen3-14b", "qwen2.5-14b", "phi3-mini-3.8b",
         "h2o-danube-1.8b"]
SAMPLING = [dict(), dict(temperature=0.8, top_k=16, seed=3, logprobs=True),
            dict(temperature=1.0, seed=9, repetition_penalty=1.3,
                 logit_bias={3: 2.0}),
            dict(temperature=0.7, top_p=0.8, min_p=0.05, seed=5)]


def _reference(name, seed=0, window=None):
    """Reduced reference model + numpy params with non-trivial biases and
    qk-norm weights (the reference initialises them to 0 and 1)."""
    cfg = reduced_config(get_config(name))
    if window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    model = build_model(cfg)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    attn = params["stacks"][0][0]["attn"]
    for key in ("bq", "bk", "bv"):
        if key in attn:
            attn[key] = (rng.standard_normal(attn[key].shape) * 0.5).astype(
                ml_dtypes.bfloat16)
    for key in ("q_norm", "k_norm"):
        if key in attn:
            attn[key] = (1 + 0.3 * rng.standard_normal(attn[key].shape)
                         ).astype(np.float32)
    return cfg, model, params


def _port(params, cfg, f32: bool) -> Model:
    model = params_from_jax(params, cfg, device="cpu")
    return model.float() if f32 else model


def _f32(params):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.float32), params)


def _check_logits(jl, tl, f32: bool) -> np.ndarray:
    a = np.asarray(jnp.asarray(jl).astype(jnp.float32))
    b = tl.float().numpy()
    if f32:
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    else:
        tol = 2.0 ** -6 * np.abs(a).max()
        assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)
        top2 = np.sort(a, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol       # no near-tie
        np.testing.assert_array_equal(b.argmax(-1)[clear],
                                      a.argmax(-1)[clear])
    return a.argmax(-1).astype(np.int32)


def _check_cache(jcache, tcache, n_layers) -> None:
    """Reference cache (one scanned segment: leaves stacked over layers)
    against the port's per-layer dicts."""
    seg = jcache[0][0]
    for i in range(n_layers):
        for key in ("k", "v"):
            np.testing.assert_allclose(
                tcache[i][key].float().numpy(),
                np.asarray(seg[key][i].astype(jnp.float32)), rtol=0,
                atol=1e-5)
        np.testing.assert_array_equal(tcache[i]["slot_pos"].numpy(),
                                      np.asarray(seg["slot_pos"][i]))


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_then_decode_matches_reference(name, f32):
    """Prefill logits and the filled cache (k, v, slot_pos), then four
    decode steps' logits and the cache after them."""
    cfg, jmodel, params = _reference(name, seed=1)
    tmodel = _port(params, tconfigs.reduced_config(tconfigs.get_config(name)),
                   f32)
    jparams = _f32(params) if f32 else jax.tree.map(jnp.asarray, params)
    B, S, max_len = 3, 9, 16
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if f32 else (jnp.bfloat16,
                                                         torch.bfloat16)
    jcache = jmodel.init_cache(B, max_len, dtype=jdt)
    tcache = tmodel.init_cache(B, max_len, dtype=tdt)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                jcache)
    tl = tmodel.prefill(torch.from_numpy(tokens), tcache)
    tok = _check_logits(jl, tl, f32)
    if f32:
        _check_cache(jcache, tcache, cfg.n_layers)
    for pos in range(S, S + 4):
        jl, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache,
                                        jnp.int32(pos))
        tl = tmodel.decode_step(torch.from_numpy(tok), tcache, pos)
        tok = _check_logits(jl, tl, f32)
    if f32:
        _check_cache(jcache, tcache, cfg.n_layers)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name):
    """Full-sequence logits (prompt scoring) in f32 within 1e-5."""
    cfg, jmodel, params = _reference(name, seed=4)
    tmodel = _port(params, tconfigs.reduced_config(tconfigs.get_config(name)),
                   True)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 11)).astype(np.int32)
    jl = jmodel.forward(_f32(params), {"tokens": jnp.asarray(tokens)})
    tl = tmodel.forward(torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)


def test_sliding_window_ring_cache_matches_reference():
    """A windowed layer on the CPU (window 5 < a 9-token prompt: the ring
    branch of prefill, then decode steps that wrap the ring) — on CUDA the
    flash kernel's window and the dense kernel over the wrapped ring."""
    cfg, jmodel, params = _reference("llama3-8b", seed=6, window=5)
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("llama3-8b")),
        sliding_window=5)
    tmodel = _port(params, tcfg, True)
    jparams = _f32(params)
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jcache = jmodel.init_cache(2, 32, dtype=jnp.float32)
    tcache = tmodel.init_cache(2, 32, dtype=torch.float32)
    assert tcache[0]["k"].shape[1] == 5
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                jcache)
    tok = _check_logits(jl, tmodel.prefill(torch.from_numpy(tokens), tcache),
                        True)
    _check_cache(jcache, tcache, cfg.n_layers)
    for pos in range(9, 16):
        jl, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache,
                                        jnp.int32(pos))
        tok = _check_logits(jl, tmodel.decode_step(torch.from_numpy(tok),
                                                   tcache, pos), True)
    _check_cache(jcache, tcache, cfg.n_layers)


@pytest.fixture(scope="module")
def llama():
    """Reduced llama3-8b: reference model with f32 params, port in f32."""
    cfg, ref, params = _reference("llama3-8b", seed=0)
    port = _port(params, tconfigs.reduced_config(
        tconfigs.get_config("llama3-8b")), True)
    return cfg, ref, _f32(params), port


def test_serve_engine_generate_matches_reference(llama):
    """``ServeEngine.generate``: per-row greedy and sampled streams (with
    repetition penalty and logit bias) identical, logprobs within 1e-5."""
    cfg, ref, params, port = llama
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (4, 10))
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
    assert got.steps == want.steps == 9
    assert got.tokens.dtype == torch.int32


def test_llm_static_matches_reference(llama):
    """``LLMEngine(backend="static")``: token ids, finish reasons (a stop
    token and the budget), logprobs and prompt scores as the reference's."""
    cfg, ref, params, port = llama
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, 12) for _ in range(4)]
    kws = [dict(SAMPLING[0], prompt_logprobs=True), SAMPLING[1],
           dict(SAMPLING[2], max_tokens=5), SAMPLING[3]]
    # a stop token the reference's greedy stream emits early
    greedy = RefLLM(ref, params, backend="static", max_len=32,
                    cache_dtype=jnp.float32).generate(
        prompts[:1], RefSP(max_tokens=8))[0].token_ids
    kws[0]["stop_token_ids"] = (greedy[3],)
    want = RefLLM(ref, params, backend="static", max_len=32,
                  cache_dtype=jnp.float32).generate(
        prompts, [RefSP(**{"max_tokens": 8, **kw}) for kw in kws])
    got = LLMEngine(port, backend="static", device="cpu", max_len=32,
                    cache_dtype=torch.float32).generate(
        prompts, [SamplingParams(**{"max_tokens": 8, **kw}) for kw in kws])
    assert [o.finish_reason for o in want][:3] == ["stop", "length", "length"]
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids == g.new_token_ids
        assert g.finish_reason == w.finish_reason and g.finished
        assert (g.logprobs is None) == (w.logprobs is None)
        if w.logprobs is not None:
            np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-5)
        assert (g.prompt_logprobs is None) == (w.prompt_logprobs is None)
    assert len(got[0].prompt_logprobs) == 11
    np.testing.assert_allclose(got[0].prompt_logprobs,
                               want[0].prompt_logprobs, rtol=0, atol=1e-5)
    assert set(got[0].metrics) == {"ttft", "tpot"}


def test_static_equals_continuous_greedy():
    """Within the port on the CPU, static == continuous greedy, token for
    token (the contract of tests/test_kv_cache.py's continuous-vs-static
    test, on the same reduced qwen3-14b in bf16)."""
    cfg = tconfigs.reduced_config(tconfigs.get_config("qwen3-14b"))
    model = Model(cfg, device="cpu").init(0)
    B, S, G = 4, 12, 10
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    static = LLMEngine(model, backend="static", device="cpu", max_len=24)
    cont = LLMEngine(model, backend="continuous", device="cpu", max_len=24,
                     num_slots=B, page_size=8, num_pages=64)
    sp = SamplingParams(max_tokens=G)
    a = [o.token_ids for o in static.generate(list(toks), sp)]
    b = [o.token_ids for o in cont.generate(list(toks), sp)]
    assert a == b
    assert cont.last_stats.occupancy == 1.0


@pytest.fixture(scope="module")
def mxfp4_served():
    """Reduced qwen3-14b whose projections are round-tripped through mxfp4
    (the reference's ``served`` fixture), in f32 on both sides."""
    cfg = reduced_config(get_config("qwen3-14b"))
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(5))

    def rt(path, leaf):
        if quantizable_leaf(path, leaf, "mxfp4"):
            p = jformats.quantize(leaf, "mxfp4")
            return jformats.dequantize(p, "mxfp4").astype(leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(rt, params)
    port = _port(jax.tree.map(np.asarray, params), tconfigs.reduced_config(
        tconfigs.get_config("qwen3-14b")), True)
    return cfg, model, _f32(params), port


def test_mxfp4_static_greedy_matches_reference(mxfp4_served):
    cfg, ref, params, port = mxfp4_served
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, 14) for _ in range(3)]
    want = RefLLM(ref, params, backend="static", max_len=32,
                  cache_dtype=jnp.float32, weight_format="mxfp4").generate(
        prompts, RefSP(max_tokens=10))
    got = LLMEngine(port, backend="static", device="cpu", max_len=32,
                    cache_dtype=torch.float32,
                    weight_format="mxfp4").generate(
        prompts, SamplingParams(max_tokens=10))
    assert [o.token_ids for o in got] == [o.token_ids for o in want]


def test_refusals(llama):
    port = llama[3]
    with pytest.raises(NotImplementedError, match="paged pools"):
        LLMEngine(port, backend="static", device="cpu", cache_dtype="fp8")
    # a spec sizes the static engine, but its quantized cache stays refused
    with pytest.raises(NotImplementedError, match="paged pools"):
        LLMEngine(port, backend="static", device="cpu",
                  spec=DeploymentSpec(sku="h100", cache_dtype="fp8"))
    with pytest.raises(NotImplementedError, match="quantized KV"):
        port.init_cache(1, 8, dtype="int8")
    # CUDA tensors take the kernels, windowed layers included (the flash
    # kernel's window, the dense kernel over a wrapped ring); the CPU the
    # plain versions
    assert layers.kernel_path(torch.device("cuda"))
    assert not layers.kernel_path(torch.device("cpu"))
    llm = LLMEngine(port, backend="static", device="cpu", max_len=16)
    with pytest.raises(ValueError, match="one prompt length"):
        llm.generate([[1, 2, 3], [4, 5]], SamplingParams(max_tokens=2))
    with pytest.raises(ValueError, match="max_len"):
        llm.generate([[1, 2, 3]], SamplingParams(max_tokens=14))
    with pytest.raises(ValueError, match="continuous"):
        llm.add_request([1, 2, 3], SamplingParams(max_tokens=2))
    with pytest.raises(ValueError, match="continuous"):
        llm.generate([[1, 2]], SamplingParams(max_tokens=2),
                     arrival_times=[0.0])
    assert not llm.has_unfinished()
    # the static backend takes a mesh (a DeviceMesh or a "DxM" spec)
    with pytest.raises(ValueError, match="DeviceMesh"):
        LLMEngine(port, backend="static", device="cpu", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LLMEngine(port, backend="static")
