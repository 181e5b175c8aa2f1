"""Quantized serving end to end on the CPU: the port's ``LLMEngine`` with
``weight_format=`` and fp8/int8 ``cache_dtype`` against the reference's.

The model mirrors the reference's own ``served`` fixture
(``tests/test_quantized_serve.py``): reduced qwen3-14b whose projection
weights are round-tripped through mxfp4, so quantizing them again is
idempotent.  Both sides get those weights cast to f32 (f32 activations;
the mxfp4 matmul still rounds them to bf16, on both sides), as the dense
engine test does: in bf16 the two frameworks' exp/sin/cos round an
occasional intermediate differently.  Streams must be identical, greedy
and sampled, through chunked prefill, prefix-cache hits, a forced
preemption and defrag — so the fp8/int8 scale leaves are shown to move
with their pages; the engine's page copy (copy-on-write) and permutation
(defrag) are also checked leaf by leaf.  fp8 is compared with the
reference's own fp8 run: the reference's fp8 stream differs from its
dense one (ROADMAP Queue 3)."""
import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced_config
from repro.models.model import build_model
from repro.quant import formats as jformats
from repro.quant import kv as jkv
from repro.quant.linear import quantizable_leaf
from repro.runtime.llm import LLMEngine as RefLLM
from repro.runtime.sampling import SamplingParams as RefSP
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.quant import formats
from repro_torch.quant import kv, linear
from repro_torch.quant.kv import raw_view
from repro_torch.quant.linear import packed_leaves
from repro_torch.runtime.engine import ContinuousServeEngine
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
SAMPLING = [dict(), dict(temperature=0.9, top_k=8, top_p=0.95, seed=101),
            dict(), dict(), dict(temperature=0.7, min_p=0.05, seed=5), dict()]
CACHES = {"f32": (jnp.float32, torch.float32), "int8": ("int8", "int8"),
          "fp8": ("fp8", "fp8")}


@pytest.fixture(scope="module")
def served():
    cfg = reduced_config(get_config("qwen3-14b"))
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(5))

    def rt(path, leaf):
        if quantizable_leaf(path, leaf, "mxfp4"):
            p = jformats.quantize(leaf, "mxfp4")
            return jformats.dequantize(p, "mxfp4").astype(leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(rt, params)
    port_bf16 = params_from_jax(jax.tree.map(np.asarray, params),
                                tconfigs.reduced_config(
                                    tconfigs.get_config("qwen3-14b")),
                                device="cpu")
    port = params_from_jax(jax.tree.map(np.asarray, params),
                           port_bf16.cfg, device="cpu").float()
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return cfg, model, f32, port, port_bf16


def _prompts(vocab):
    rng = np.random.default_rng(0)
    base = rng.integers(0, vocab, (3, 20))
    # request 2 repeats request 0's leading pages (a prefix hit once 0 is
    # indexed); request 4 shares 1's
    return [base[0], base[1], base[0][:18], base[2], base[1][:13],
            rng.integers(0, vocab, 9)]


def _drive(llm, prompts, sps, defrags=None):
    """Serve through the incremental interface, defrag every 3 steps;
    ``defrags`` (port only) records whether each defrag moved a page."""
    for p, sp in zip(prompts, sps):
        llm.add_request(p, sp)
    llm._eng.defrag_every = 3
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
    return [done[i].token_ids for i in range(len(prompts))]


def _port_run(port, prompts, cache, weight_format="mxfp4", sampling=SAMPLING,
              max_tokens=10):
    llm = LLMEngine(port, device="cpu", cache_dtype=CACHES[cache][1],
                    weight_format=weight_format, **ENGINE)
    defrags = []
    toks = _drive(llm, prompts, [SamplingParams(max_tokens=max_tokens, **kw)
                                 for kw in sampling], defrags)
    return toks, llm, defrags


@pytest.mark.parametrize("cache", ["f32", "int8", "fp8"])
def test_mxfp4_streams_match_reference(served, cache):
    cfg, model, f32, port, _ = served
    prompts = _prompts(cfg.vocab_size)
    want = _drive(RefLLM(model, f32, cache_dtype=CACHES[cache][0],
                         weight_format="mxfp4", **ENGINE), prompts,
                  [RefSP(max_tokens=10, **kw) for kw in SAMPLING])
    got, llm, defrags = _port_run(port, prompts, cache)
    assert got == want
    stats = llm.stats()
    assert stats.preemptions > 0, "the pool no longer forces a preemption"
    assert stats.prefix_hit_tokens > 0, "no prefix-cache hit"
    assert any(defrags), "no defrag moved a page"
    llm._eng.cache.allocator.check()
    packed = list(packed_leaves(llm._eng.model))
    assert len(packed) == 7 * cfg.n_layers
    assert not list(packed_leaves(port))          # the caller's model as it was
    pool = llm._eng._pools[0]
    if cache == "f32":
        assert set(pool) == {"k", "v"} and pool["k"].dtype == torch.float32
    else:
        assert set(pool) == {"k", "v", "k_scale", "v_scale"}
        assert pool["k"].dtype == (torch.int8 if cache == "int8"
                                   else torch.float8_e4m3fn)
        assert pool["k_scale"].shape == pool["k"].shape[:3]


def test_mxfp4_matches_dense_port(served):
    """Weights already on the mxfp4 grid, in bf16 as the reference's own
    test has them: the packed engine and the dense engine (f32 pools)
    compute the same products and give the same greedy streams.  (With f32
    activations they would not: the mxfp4 op rounds x to bf16 first.)"""
    cfg, _, _, _, port_bf16 = served
    prompts = _prompts(cfg.vocab_size)
    greedy = [dict()] * len(prompts)
    dense, _, _ = _port_run(port_bf16, prompts, "f32", None, greedy)
    packed, _, _ = _port_run(port_bf16, prompts, "f32", "mxfp4", greedy)
    assert packed == dense


@pytest.mark.parametrize("fmt", ["mxfp8", "bfp", "nxfp4"])
def test_other_weight_formats_match_reference(served, fmt):
    """The other formats serve through dequantize-then-matmul, as in the
    reference: identical greedy streams."""
    cfg, model, f32, port, _ = served
    prompts = _prompts(cfg.vocab_size)[:4]
    greedy = [dict()] * len(prompts)
    want = _drive(RefLLM(model, f32, cache_dtype=jnp.float32,
                         weight_format=fmt, **ENGINE), prompts,
                  [RefSP(max_tokens=8, **kw) for kw in greedy])
    got, llm, _ = _port_run(port, prompts, "f32", fmt, greedy, max_tokens=8)
    assert got == want
    assert all(type(w) is formats.format_spec(fmt).packed_cls
               for _, w in packed_leaves(llm._eng.model))


def test_copy_and_permute_move_scale_leaves(served):
    """A copy-on-write of a shared page (``cache.cow`` then the engine's
    ``_copy_page``, as ``step`` does) and a defrag permutation
    (``_permute_pools``) move every leaf of a quantized pool, scales
    included, bit for bit, and leave the donor page as it was."""
    port = served[3]
    eng = ContinuousServeEngine(port, device="cpu", num_slots=2, page_size=4,
                                num_pages=8, max_len=12, cache_dtype="fp8")
    eng.reset()
    pool = eng._pools[1]
    gen = torch.Generator().manual_seed(0)
    for leaf in pool.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    prompt = np.arange(9, dtype=np.int32)          # 2 full blocks + 1
    cache = eng.cache
    cache.admit(0, len(prompt), tokens=prompt)
    cache.index_prompt(0, prompt)
    cache.admit(1, len(prompt), tokens=prompt)     # shares blocks 0 and 1
    before = {k: raw_view(v).clone() for k, v in pool.items()}
    donor, fresh = cache.cow(1, 0)
    eng._copy_page(fresh, donor)
    for key, leaf in pool.items():
        assert torch.equal(raw_view(leaf)[fresh], before[key][donor]), key
        assert torch.equal(raw_view(leaf)[donor], before[key][donor]), key
    gather = torch.randperm(8, generator=gen)
    snap = {k: raw_view(v).clone() for k, v in pool.items()}
    eng._permute_pools(gather.numpy())
    for key, leaf in pool.items():
        assert torch.equal(raw_view(leaf), snap[key][gather]), key


def test_unknown_cache_dtype_rejected(served):
    port = served[3]
    with pytest.raises(ValueError, match="cache_dtype"):
        ContinuousServeEngine(port, device="cpu", num_slots=2, page_size=4,
                              num_pages=8, max_len=16, cache_dtype="fp4")
    with pytest.raises(ValueError, match="cache_dtype"):
        LLMEngine(port, device="cpu", cache_dtype="int4", **{
            k: v for k, v in ENGINE.items() if k != "backend"})
    with pytest.raises(ValueError, match="cache_dtype"):
        port.init_paged_cache(4, 2, dtype="fp16")
    with pytest.raises(KeyError, match="format"):
        LLMEngine(port, device="cpu", weight_format="fp4", **ENGINE)


def test_projections_that_read_one_x_share_a_launch(served, monkeypatch):
    """Each quantized model call groups q/k/v and gate/up: per layer one
    group op of three weights and one of two (one kernel launch each on a
    card) beside the o and down projections -- four launches a layer."""
    cfg, _, _, port, _ = served
    calls = []
    group, one = linear.mxfp4_matmul_group, linear.mxfp4_matmul

    def spy_group(x, ws, **kw):
        calls.append(len(ws))
        return group(x, ws, **kw)

    def spy_one(x, w, **kw):
        calls.append(1)
        return one(x, w, **kw)

    monkeypatch.setattr(linear, "mxfp4_matmul_group", spy_group)
    monkeypatch.setattr(linear, "mxfp4_matmul", spy_one)
    _port_run(port, _prompts(cfg.vocab_size)[:2], "f32",
              sampling=[dict(), dict()], max_tokens=3)
    n_layers = port.cfg.n_layers
    assert calls and set(calls) == {1, 2, 3}
    assert calls.count(3) == calls.count(2) == calls.count(1) // 2
    assert calls.count(3) % n_layers == 0


@pytest.mark.parametrize("cache", ["fp8", "int8"])
def test_kv_quantize_divisor_made_once(cache):
    """``kv_quantize`` builds its qmax divisor (and the 1.0 of all-zero
    vectors) once per format and device, and still gives the reference's
    bits on every call."""
    rng = np.random.default_rng(3)
    cpu = torch.device("cpu")
    consts = kv._constants(cache, cpu)
    for _ in range(2):
        x = (rng.standard_normal((4, 3, 2, 16)) * 5.0).astype(np.float32)
        x[0, 1] = 0.0
        codes, scales = kv.kv_quantize(torch.from_numpy(x), cache)
        assert kv._constants(cache, cpu) is consts
        jcodes, jscales = jkv.kv_quantize(jnp.asarray(x), cache)
        np.testing.assert_array_equal(raw_view(codes).numpy().view(np.uint8),
                                      np.asarray(jcodes).view(np.uint8))
        np.testing.assert_array_equal(scales.numpy().view(np.uint32),
                                      np.asarray(jscales).view(np.uint32))
