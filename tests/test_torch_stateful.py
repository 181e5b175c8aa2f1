"""Stateful layouts on the CPU against the reference: mamba2-370m (per-slot
SSM state only) and hymba-1.5b (full-context KV pages, ring pages and SSM
state in one slot) through the continuous and static engines, the prefix
cache, ``DeploymentSpec`` and the simulator.

Models: reduced mamba2 (2 layers) and the reference's 3-layer hymba
fixture (global, windowed, global), with the reference ``Model.init``'s
weights through ``bridge.params_from_jax``.  Streams are held token for
token against the reference engines in f32, greedy and sampled, through
a forced preemption storm (``_drive(preempt_every=3)``) and a tight full
pool with defrag; state-pool and ring invariants are checked after every
iteration.  Budgets are held field by field at 1e-12, the engine's
allocated pools against ``pool_bytes_per_device``, and the simulator's
programs and latencies at 1e-12.  Inputs come from seeded numpy
generators.  Logprobs and prompt scores: within 1e-4 (an f32 model's conv
state rounds to the bf16 pool in both engines, so a last-bit difference
upstream can move a rounding by one bf16 ulp)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced_config
from repro.models.model import Model as RefModel, build_model
from repro.runtime import deployment as jdep
from repro.runtime.engine import ContinuousServeEngine as RefEngine
from repro.runtime.engine import ServeEngine as RefServeEngine
from repro.runtime.llm import LLMEngine as RefLLM
from repro.runtime.sampling import SamplingParams as RefSP
from repro.runtime.scheduler import Request as RefRequest
from repro.sim import compiler as jcomp
from repro.sim import gpu_model as jgpu
from repro.sim import scaling as jscal
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.models.model import Model
from repro_torch.runtime import deployment as tdep
from repro_torch.runtime.engine import ContinuousServeEngine, ServeEngine
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.speculative import SpeculativeConfig
from repro_torch.runtime.state_cache import (
    model_cache_layout, ring_blocks_cap, state_bytes_per_slot,
)
from repro_torch.sim import compiler as tcomp
from repro_torch.sim import gpu_model as tgpu
from repro_torch.sim import scaling as tscal

MAMBA = "mamba2-370m"
HYMBA = "hymba-1.5b"
SAMPLING = [dict(), dict(temperature=0.9, top_k=8, seed=101, logprobs=True),
            dict(repetition_penalty=1.2),
            dict(temperature=0.7, top_p=0.8, min_p=0.05, seed=5)]
LP_TOL = 1e-4
# continuous prompt scores against ``Model.forward``'s: the continuous
# engine rounds an f32 model's conv tail to the bf16 pool at every chunk
# boundary, the forward pass never does (4.1e-4 of the score's magnitude
# seen on the fixtures): a relative tolerance
FORWARD_RTOL = 1e-3
REL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name: str):
    """Reduced configs; hymba as the reference's 3-layer fixture
    (``tests/test_state_cache.py``), whose middle layer is windowed."""
    jcfg = reduced_config(get_config(name))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(name))
    if name == HYMBA:
        jcfg = dataclasses.replace(jcfg, n_layers=3, global_attn_every=3)
        tcfg = dataclasses.replace(tcfg, n_layers=3, global_attn_every=3)
    return jcfg, tcfg


def _build(name: str, f32: bool = True):
    jcfg, tcfg = _configs(name)
    ref = build_model(jcfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    port = params_from_jax(params, tcfg, device="cpu")
    if f32:
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
        port = port.float()
    return jcfg, ref, params, port


@pytest.fixture(scope="module", params=[MAMBA, HYMBA],
                ids=["mamba2", "hymba"])
def pair(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def hymba():
    return _build(HYMBA)


def test_layout_classification():
    """The port's plans classify as the reference's (``test_model_cache_
    layout_classification``): mamba2 state only, hymba full + ring +
    state, danube ring only, qwen3 full only."""
    def lay(name, **kw):
        cfg = tconfigs.reduced_config(tconfigs.get_config(name))
        return model_cache_layout(Model(dataclasses.replace(cfg, **kw),
                                        device="meta").plan)
    ssm = lay(MAMBA)
    assert (ssm.has_full, ssm.has_ring, ssm.has_state) == (False, False, True)
    assert ssm.stateful and ssm.ring_window is None
    hyb = lay(HYMBA, n_layers=3, global_attn_every=3)
    assert (hyb.has_full, hyb.has_ring, hyb.has_state) == (True, True, True)
    assert hyb.ring_window == 8 and hyb.ring_layers() == 1
    ring = lay("h2o-danube-1.8b")
    assert (ring.has_full, ring.has_ring, ring.has_state) == (False, True,
                                                              False)
    assert not lay("qwen3-14b").stateful


# ---------------------------------------------------------------------------
# continuous streams
# ---------------------------------------------------------------------------

ENGINE = dict(max_len=48, num_slots=3, page_size=4, prefill_chunk=5,
              num_pages=40)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, n) for n in (20, 13, 9, 17, 30)]


def _drive(llm, prompts, sps, preempt_every=0, defrag_every=0):
    """Serve through the incremental interface (the engine's
    ``defrag_every`` set once the session exists).  ``preempt_every``:
    every that many iterations, preempt the decoding request with the
    lowest rid not yet preempted.  After every iteration the allocators'
    invariants hold (the ring space's too); returns the finished outputs
    and, per iteration, the slots that prefilled and decoded."""
    for p, sp in zip(prompts, sps):
        llm.add_request(p, sp)
    eng = llm._eng
    eng.defrag_every = defrag_every
    done, mix, it, hit = {}, [], 0, set()
    while llm.has_unfinished():
        it += 1
        if preempt_every and it % preempt_every == 0:
            dec = sorted((r for r in eng._sched.decoding()
                          if r.rid not in hit), key=lambda r: r.rid)
            if dec:
                hit.add(dec[0].rid)
                eng._sched.preempt(dec[0])
        mix.append((len(eng._sched.prefilling()), len(eng._sched.decoding())))
        for o in llm.step():
            if o.finished:
                done[o.rid] = o
        eng.cache.allocator.check()
        if eng.cache.ring is not None:
            eng.cache.ring.check()
    return [done[i] for i in range(len(prompts))], mix


@pytest.mark.parametrize("preempt_every", [0, 3], ids=["plain", "storm"])
def test_continuous_streams_match_reference(pair, preempt_every):
    """f32 greedy and sampled streams of ``LLMEngine(backend="continuous")``
    equal the reference engine's (chunk 5, page 4, 3 slots for 5
    requests, hymba's prompts past its window), with and without a
    forced preemption storm (restarts begin at position 0, where the
    step zeroes the slot's state rows); some iterations mix prefilling
    and decoding slots (``state_ok``); every page returns at the end."""
    cfg, ref, params, port = pair
    prompts = _prompts(cfg.vocab_size)
    sps = SAMPLING + [dict(temperature=1.0, seed=9, logit_bias={3: 2.0})]
    want, _ = _drive(RefLLM(ref, params, cache_dtype=jnp.float32,
                            backend="continuous", **ENGINE), prompts,
                     [RefSP(max_tokens=14, **kw) for kw in sps],
                     preempt_every)
    llm = LLMEngine(port, device="cpu", cache_dtype=torch.float32,
                    backend="continuous", **ENGINE)
    got, mix = _drive(llm, prompts,
                      [SamplingParams(max_tokens=14, **kw) for kw in sps],
                      preempt_every)
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids, (g.rid, w.token_ids, g.token_ids)
        assert g.finish_reason == w.finish_reason
    np.testing.assert_allclose(got[1].logprobs, want[1].logprobs, rtol=0,
                               atol=LP_TOL)
    assert any(p and d for p, d in mix), "no iteration mixed the two"
    eng = llm._eng
    # hymba's full pages that stay live belong to the prefix index only
    assert eng.cache.allocator.num_live == len(eng.cache._prefix_pages)
    if eng.cache.ring is not None:
        assert eng.cache.ring.allocator.num_live == 0
    stats = llm.stats()
    assert (stats.preemptions > 0) == bool(preempt_every)
    assert len(eng._states) == cfg.n_layers and all(
        set(s) == {"conv", "ssm"} and s["ssm"].shape[0] == ENGINE["num_slots"]
        for s in eng._states)


def test_hybrid_tight_pool_preemption_and_defrag(hymba):
    """The reference's ``test_hybrid_continuous_matches_static_preemption_
    defrag`` setting (2 slots, 14 full pages, page 4, chunk = the SSD
    chunk, defrag every 3 steps): pool pressure preempts, and the port's
    greedy streams equal the reference engine's and the port's static
    engine's; both allocators' invariants hold afterwards."""
    cfg, ref, params, port = hymba
    lens = [6, 9, 5, 8, 7]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (16, 32, 16, 32, 16)]
    kw = dict(num_slots=2, page_size=4, num_pages=14, max_len=44,
              prefill_chunk=cfg.ssm_chunk)

    def reqs(cls):
        return [cls(rid=i, prompt=prompts[i], max_new_tokens=lens[i],
                    arrival_time=0.0) for i in range(5)]
    want = RefEngine(ref, params, cache_dtype=jnp.float32, **kw).run(
        reqs(RefRequest), defrag_every=3)
    eng = ContinuousServeEngine(port, device="cpu", cache_dtype=torch.float32,
                                **kw)
    got = eng.run(reqs(Request), defrag_every=3)
    static = ServeEngine(port, device="cpu", max_len=48,
                         cache_dtype=torch.float32)
    for i in range(5):
        np.testing.assert_array_equal(got.results[i], want.results[i])
        s = static.generate({"tokens": prompts[i][None]},
                            max_new_tokens=lens[i])
        np.testing.assert_array_equal(got.results[i], s.tokens[0].numpy())
    assert got.preemptions > 0 and got.preemptions == want.preemptions
    a = eng.cache.allocator
    a.check()
    assert a.num_free + a.num_live == a.num_pages - 1
    eng.cache.ring.check()
    ra = eng.cache.ring.allocator
    assert ra.num_free + ra.num_live == ra.num_pages - 1


def test_mamba2_bf16_continuous_equals_static_through_preemption():
    """The reference's ``test_mamba2_continuous_matches_static_forced_
    preemption`` on the port, bf16: 3 requests over 2 slots, chunk-aligned
    prompts, one request preempted mid-decode; the continuous streams equal
    the port's static engine's and the reference's continuous engine's."""
    cfg, ref, params, port = _build(MAMBA, f32=False)
    G = [8, 6, 7]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (16, 32, 16)]
    static = ServeEngine(port, device="cpu", max_len=48)
    refs = [static.generate({"tokens": p[None]}, max_new_tokens=g
                            ).tokens[0].tolist() for p, g in zip(prompts, G)]

    def run(eng, cls):
        for i in range(3):
            eng.add_request(cls(rid=i, prompt=prompts[i], max_new_tokens=G[i],
                                arrival_time=0.01 * i))
        outs, preempted, steps = {}, False, 0
        while eng.has_unfinished():
            for o in eng.step():
                if o.finished:
                    outs[o.rid] = o.token_ids
            steps += 1
            if steps == 4 and not preempted:
                eng._sched.preempt(eng._sched.decoding()[-1])
                preempted = True
            assert steps < 500
        assert sum(r.preemptions for r in eng._requests) > 0
        return outs

    kw = dict(num_slots=2, page_size=4, num_pages=13, max_len=48,
              prefill_chunk=cfg.ssm_chunk)
    got = run(ContinuousServeEngine(port, device="cpu", **kw), Request)
    want = run(RefEngine(ref, params, **kw), RefRequest)
    for i in range(3):
        assert list(got[i]) == refs[i] == list(want[i])


# ---------------------------------------------------------------------------
# static streams and prompt scores
# ---------------------------------------------------------------------------


def test_static_streams_match_reference(pair):
    """``ServeEngine.generate`` and ``LLMEngine(backend="static")``: greedy
    and sampled streams identical, logprobs and prompt scores within 1e-5
    (prompts past hymba's window)."""
    cfg, ref, params, port = pair
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


def test_prompt_logprobs_match_reference_and_forward(pair):
    """Continuous prompt scores (chunked, state threaded across chunks)
    equal the reference's within ``LP_TOL`` and the static backend's
    ``Model.forward`` scores within ``FORWARD_RTOL``; the first tokens are
    the reference's."""
    cfg, ref, params, port = pair
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
                                   rtol=0, atol=LP_TOL)
        (s,) = static.generate([p], sp)
        np.testing.assert_allclose(g.prompt_logprobs, s.prompt_logprobs,
                                   rtol=FORWARD_RTOL, atol=LP_TOL)


# ---------------------------------------------------------------------------
# the prefix cache
# ---------------------------------------------------------------------------


def test_prefix_cache_off_for_mamba2():
    """No full-KV space: the prefix index is forced off, no hits, and three
    copies of one prompt give one stream (the reference's
    ``test_prefix_cache_disabled_for_pure_ring_and_state``)."""
    cfg, ref, params, port = _build(MAMBA)
    kw = dict(num_slots=2, page_size=4, num_pages=9, max_len=32,
              enable_prefix_cache=True, cache_dtype=torch.float32)
    eng = ContinuousServeEngine(port, device="cpu", **kw)
    assert eng.enable_prefix_cache is False
    prompt = np.arange(1, 13, dtype=np.int32) % cfg.vocab_size
    stats = eng.run([Request(rid=i, prompt=prompt.copy(), max_new_tokens=4,
                             arrival_time=0.05 * i) for i in range(3)])
    assert stats.prefix_hit_tokens == 0
    assert len({tuple(stats.results[i]) for i in range(3)}) == 1


def test_hybrid_prefix_shares_pages_but_recomputes(hymba):
    """hymba's full-space attention pages are shared for capacity
    (``recompute_shared``), but admission reports 0 shared tokens, so the
    whole prompt replays, rebuilding SSM state and ring pages; streams
    equal the reference's and the static engine's."""
    cfg, ref, params, port = hymba
    prompt = (np.arange(1, 33, dtype=np.int32) * 7) % cfg.vocab_size
    kw = dict(num_slots=2, page_size=4, num_pages=40, max_len=48,
              prefill_chunk=cfg.ssm_chunk, enable_prefix_cache=True)

    def reqs(cls):
        return [cls(rid=i, prompt=prompt.copy(), max_new_tokens=5,
                    arrival_time=0.05 * i) for i in range(3)]
    eng = ContinuousServeEngine(port, device="cpu", cache_dtype=torch.float32,
                                **kw)
    assert eng.enable_prefix_cache is True
    stats = eng.run(reqs(Request))
    want = RefEngine(ref, params, cache_dtype=jnp.float32, **kw).run(
        reqs(RefRequest))
    static = ServeEngine(port, device="cpu", max_len=48,
                         cache_dtype=torch.float32).generate(
        {"tokens": prompt[None]}, max_new_tokens=5).tokens[0].numpy()
    assert eng.cache.recompute_shared
    for i in range(3):
        np.testing.assert_array_equal(stats.results[i], want.results[i])
        np.testing.assert_array_equal(stats.results[i], static)
    # how many tokens hit depends on arrival timing, which differs between
    # the engines: both must share pages, neither may skip compute
    assert eng.cache.hit_tokens > 0 and want.prefix_hit_tokens > 0
    assert stats.prefill_tokens == stats.prompt_tokens
    assert all(r["shared_tokens"] == 0 for r in stats.per_request.values())


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_stateful_refusals_match_reference(hymba):
    """As the reference, for the state-carrying archs: ``speculative=``,
    a disaggregated ``phase``, a quantized ``cache_dtype`` and ``mesh=``
    raise in the continuous engine, ``backend="speculative"`` in the
    facade, each with the reference's reason; a spec raises
    ``DeploymentError`` for a draft, a phase or a quantized cache, as the
    reference's ``resolve`` does."""
    cfg, ref, params, port = hymba
    m = Model(_configs(MAMBA)[1], device="cpu")
    for model in (port, m):
        for kw, match in (
                (dict(speculative=SpeculativeConfig(gamma=2)),
                 "speculative decoding is unsupported"),
                (dict(phase="prefill"), "disaggregated serving is unsupported"),
                (dict(cache_dtype="fp8"), "SSM state pools stay bf16/f32"),
                (dict(cache_dtype="int8"), "quantized state"),
                (dict(mesh="1x2"), "needs sharded state pools")):
            with pytest.raises(NotImplementedError, match=match):
                ContinuousServeEngine(model, device="cpu", **ENGINE, **kw)
        with pytest.raises(ValueError, match="requires rewindable caches"):
            LLMEngine(model, backend="speculative", device="cpu", max_len=32)
    with pytest.raises(NotImplementedError, match="SSM state pools stay"):
        RefEngine(ref, params, **ENGINE, cache_dtype="fp8")
    with pytest.raises(ValueError, match="requires rewindable caches"):
        RefLLM(ref, params, backend="speculative", max_len=32)
    spec = dict(sku="rpu-cu", max_len=64, page_size=4)
    dense = Model(tconfigs.reduced_config(tconfigs.get_config("qwen3-14b")),
                  device="meta")
    jdense = RefModel(reduced_config(get_config("qwen3-14b")))
    jhy = RefModel(_configs(HYMBA)[0])
    for fn, jfn, match in (
            (lambda s: s.resolve(port, draft=dense),
             lambda s: s.resolve(jhy, draft=jdense), "speculative.*hymba"),
            (lambda s: s.resolve(port, phase="prefill"),
             lambda s: s.resolve(jhy, phase="prefill"), "phase.*hymba")):
        with pytest.raises(jdep.DeploymentError, match=match):
            jfn(jdep.DeploymentSpec(**spec))
        with pytest.raises(tdep.DeploymentError, match=match):
            fn(tdep.DeploymentSpec(**spec))
    with pytest.raises(tdep.DeploymentError, match="cache_dtype.*hymba"):
        tdep.DeploymentSpec(cache_dtype="fp8", **spec).resolve(port)


# ---------------------------------------------------------------------------
# DeploymentSpec and the simulator
# ---------------------------------------------------------------------------


def _numbers(dep) -> dict:
    out = {}
    for f in dataclasses.fields(dep):
        if f.name in ("spec", "mesh", "cache_dtype"):
            continue
        v = getattr(dep, f.name)
        if f.name == "device":
            out.update({f"device.{k}": x
                        for k, x in dataclasses.asdict(v).items()})
            continue
        out[f.name] = v
    out["pool_bytes_per_device"] = dep.pool_bytes_per_device
    return out


def _assert_same(got, want):
    g, w = _numbers(got), _numbers(want)
    assert g.keys() == w.keys()
    for k in w:
        if isinstance(w[k], float) or isinstance(g[k], float):
            assert g[k] == pytest.approx(w[k], rel=REL, abs=0), k
        else:
            assert g[k] == w[k], k
    assert got.describe() == want.describe()


@pytest.mark.parametrize("cache", [None, "f32"])
def test_allocated_pools_equal_the_budget(pair, cache):
    """The reference's ``test_resolve_prices_exactly_what_the_pools_
    allocate`` on the port: the budget equals the reference's field for
    field, and the engine sized by the spec allocates exactly
    ``pool_bytes_per_device`` (full and ring pages, scratch pages
    excluded, plus the state pools: ``num_slots`` x
    ``state_bytes_per_slot``, no scratch row)."""
    cfg, ref, params, port = pair
    jc, tc = {None: (None, None), "f32": (jnp.float32, torch.float32)}[cache]
    skw = dict(sku="rpu-cu", max_len=64, page_size=4, max_slots=4,
               prefill_chunk=16)
    want = jdep.DeploymentSpec(cache_dtype=jc, **skw).resolve(ref,
                                                             params=params)
    eng = ContinuousServeEngine(port, device="cpu",
                                spec=tdep.DeploymentSpec(cache_dtype=tc,
                                                         **skw))
    eng.reset()
    dep = eng.deployment
    _assert_same(dep, want)
    assert dep.state_bytes_per_slot == state_bytes_per_slot(port.cfg) > 0
    states = sum(a.nbytes for s in eng._states for a in s.values())
    assert states == dep.num_slots * dep.state_bytes_per_slot
    pages = sum(a.nbytes for p in eng._pools for a in p.values())
    full_tok = dep.kv_token_bytes - dep.ring_token_bytes
    scratch = (full_tok * dep.page_size
               + (dep.ring_token_bytes * dep.page_size
                  if dep.num_ring_pages else 0))
    assert dep.pool_bytes_per_device == pages + states - scratch
    assert eng.ring_pages == dep.num_ring_pages
    assert "stateful" in dep.describe()


@pytest.mark.parametrize("name", [MAMBA, HYMBA])
def test_full_size_pricing_matches_reference(name):
    """The full configs priced from a ``meta`` model on an H100 and on the
    paper's RPU compute unit, by the footprint estimate and exactly from
    the parameters' shapes, bf16 and mxfp4 weights, at 1e-12 (or both
    raise where the weights leave no room, as hymba's on the RPU unit);
    the state bytes a slot are the reckoned ones (mamba2: 48 x (1 MiB SSD
    + 13.8 KB conv tail); hymba: 32 x (204.8 KB + 19.4 KB))."""
    ref = build_model(get_config(name))
    abstract = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    port = Model(tconfigs.get_config(name), device="meta")
    for sku, fmt in (("h100", None), ("h100", "mxfp4"), ("rpu-cu", None)):
        skw = dict(sku=sku, weight_format=fmt, max_len=4096)
        for jp, tp in ((None, None), (abstract, port)):
            try:
                want = jdep.DeploymentSpec(**skw).resolve(ref, params=jp)
            except jdep.DeploymentError:       # hymba on one RPU unit
                with pytest.raises(tdep.DeploymentError):
                    tdep.DeploymentSpec(**skw).resolve(port, params=tp)
                continue
            _assert_same(tdep.DeploymentSpec(**skw).resolve(port, params=tp),
                         want)
    per = {MAMBA: 48 * (32 * 64 * 128 * 4 + 3 * (2048 + 256) * 2),
           HYMBA: 32 * (50 * 64 * 16 * 4 + 3 * (3200 + 32) * 2)}[name]
    assert state_bytes_per_slot(port.cfg) == per


@pytest.mark.parametrize("name", [MAMBA, HYMBA])
def test_simulator_matches_reference(name):
    """``compile_decode_step``, ``gpu_decode_latency``,
    ``min_cus_for_model`` and ``iso_tdp_comparison`` on the full configs
    at 1e-12 (every phase's bytes and flops, every latency field)."""
    t, j = tconfigs.get_config(name), get_config(name)

    def same(got, want, where):
        if dataclasses.is_dataclass(want):
            for f in dataclasses.fields(want):
                same(getattr(got, f.name), getattr(want, f.name),
                     f"{where}.{f.name}")
        elif isinstance(want, dict):
            assert got.keys() == want.keys(), where
            for k in want:
                same(got[k], want[k], f"{where}[{k!r}]")
        elif isinstance(want, (list, tuple)):
            assert len(got) == len(want), where
            for i, (g, w) in enumerate(zip(got, want)):
                same(g, w, f"{where}[{i}]")
        elif isinstance(want, float) or isinstance(got, float):
            assert got == pytest.approx(want, rel=REL, abs=0), where
        else:
            assert got == want, where
    for kw in (dict(), dict(n_cus=16, batch=8, seq_len=2048)):
        same(tcomp.compile_decode_step(t, tcomp.CompileOptions(**kw)),
             jcomp.compile_decode_step(j, jcomp.CompileOptions(**kw)),
             f"{name} {kw}")
    for batch, seq in ((1, 8192), (8, 700)):
        same(tgpu.gpu_decode_latency(t, tgpu.GPUSystemConfig(), batch=batch,
                                     seq_len=seq),
             jgpu.gpu_decode_latency(j, jgpu.GPUSystemConfig(), batch=batch,
                                     seq_len=seq), name)
    assert tscal.min_cus_for_model(t) == jscal.min_cus_for_model(j)
    same(tscal.iso_tdp_comparison(t), jscal.iso_tdp_comparison(j), name)


def test_ring_residency_bounded_for_hybrid(hymba):
    """hymba's windowed layer keeps at most ``ring_blocks_cap`` live ring
    blocks a decoding slot over a 30-token stream (window 8, page 4),
    step for step the reference's, while its global layers hold the full
    context."""
    cfg, ref, params, port = hymba
    prompt = np.arange(1, 13, dtype=np.int32) % cfg.vocab_size
    kw = dict(num_slots=2, page_size=4, num_pages=30, max_len=48,
              prefill_chunk=5)

    def run(eng, cls):
        eng.add_request(cls(rid=0, prompt=prompt, max_new_tokens=30))
        seen = []
        while eng.has_unfinished():
            eng.step()
            eng.cache.ring.check()
            seen.append(tuple(eng.cache.ring.live_blocks(r.slot)
                              for r in eng._sched.decoding()))
        return seen
    want = run(RefEngine(ref, params, cache_dtype=jnp.float32, **kw),
               RefRequest)
    got = run(ContinuousServeEngine(port, device="cpu",
                                    cache_dtype=torch.float32, **kw), Request)
    assert got == want
    assert max(max(s, default=0) for s in got) <= ring_blocks_cap(8, 4)
