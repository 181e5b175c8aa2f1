"""Disaggregated serving in the port (``DisaggServeEngine``, ``KVHandoff``,
``ContinuousServeEngine(phase=)``) against the reference's on the CPU, and
the fleet layer's disaggregated simulator and planner against the
reference's.

Greedy byte identity is the load-bearing property, as in
``tests/test_disagg.py``: the port's disaggregated streams equal its
colocated ones and the reference ``DisaggServeEngine``'s, through prefix
sharing, fp8 KV, ``speculative=`` and decode-side preemption (which drains
back to the prefill engine for a re-prefill restart), and the four handoff
counters equal the reference's.  Models: reduced llama3-8b and reduced
deepseek-v2-lite-16b (latent pools), the reference's weights in f32 on
both sides, f32 pools (fp8 codes with f32 scales for the fp8 case): in
f32 the logits agree to ~1e-6, so a stream difference is one of the
engines.  Phase budgets and the fleet's floats are held at 1e-12
(relative), counts exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced_config
from repro.fleet import DisaggFleetSimulator as RefDisaggSim
from repro.fleet import FleetSimulator as RefFleetSim
from repro.fleet import PrefixAffinityRouter as RefRouter
from repro.fleet import ReplicaSpec as RefReplicaSpec
from repro.launch.fleet import gate_table as ref_gate_table
from repro.launch.fleet import gate_workload as ref_gate_workload
from repro.models.model import build_model
from repro.runtime import deployment as jdep
from repro.runtime.engine import ContinuousServeEngine as RefEngine
from repro.runtime.engine import DisaggServeEngine as RefDisagg
from repro.runtime.sampling import SamplingParams as RefSP
from repro.runtime.scheduler import Request as RefRequest
from repro.runtime.speculative import SpeculativeConfig as RefSpecConfig
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.fleet import (DisaggFleetSimulator, FleetSimulator,
                               PrefixAffinityRouter, ReplicaSpec)
from repro_torch.launch.fleet import gate_table, gate_workload
from repro_torch.models.model import Model
from repro_torch.runtime import deployment as tdep
from repro_torch.runtime.engine import (ContinuousServeEngine,
                                        DisaggServeEngine, KVHandoff)
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.speculative import SpeculativeConfig

REL = 1e-12
COUNTERS = ("handoffs", "handoff_pages", "handoff_bytes",
            "handoff_shared_tokens")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(name, n_layers=None, seed=0):
    cfg = reduced_config(get_config(name))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(name))
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(seed))
    port = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                           device="cpu").float()
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.float32),
                          params)
    return cfg, ref, params, port


@pytest.fixture(scope="module")
def llama():
    return _build("llama3-8b")


@pytest.fixture(scope="module")
def deepseek():
    return _build("deepseek-v2-lite-16b", seed=2)


def _mk_requests(vocab, n, seed, *, max_new=8, port=True):
    """Ragged greedy requests; even rids share a 12-token prefix, so the
    handoff meets decode-side prefix admission (``tests/test_disagg.py``'s
    mix)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 12).astype(np.int32)
    req, sp = (Request, SamplingParams) if port else (RefRequest, RefSP)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(6, 20))).astype(
            np.int32)
        prompt = np.concatenate([shared, tail]) if i % 2 == 0 else tail
        out.append(req(rid=i, prompt=prompt, max_new_tokens=max_new,
                       sampling=sp(max_tokens=max_new)))
    return out


BASE = dict(num_slots=4, page_size=4, num_pages=48, max_len=64,
            prefill_chunk=8, enable_prefix_cache=True)
CASES = {
    "prefix_sharing": dict(seed=3, max_new=8, kw={}),
    "fp8_kv": dict(seed=3, max_new=8, kw=dict(cache_dtype="fp8")),
    "speculative": dict(seed=3, max_new=8, kw=dict(speculative=3)),
    # page pressure evicts decoding requests; a victim restarts on the
    # prefill engine and is handed off again
    "preemption": dict(seed=9, max_new=24, kw=dict(num_pages=16,
                                                   max_len=56)),
}


def _engine_kw(kw, port):
    kw = {**BASE, **kw}
    gamma = kw.pop("speculative", None)
    if gamma is not None:
        kw["speculative"] = (SpeculativeConfig(gamma=gamma) if port
                             else RefSpecConfig(gamma=gamma))
    cache = kw.pop("cache_dtype", None)
    kw["cache_dtype"] = cache or (torch.float32 if port else jnp.float32)
    return kw


def _identical(pair, seed, max_new, kw):
    """The same workload through the port colocated and disaggregated and
    through the reference disaggregated: every stream equal; the port's
    handoff counters equal the reference's.  Returns the port's stats."""
    cfg, ref, params, port = pair
    tkw, jkw = _engine_kw(kw, True), _engine_kw(kw, False)
    co = ContinuousServeEngine(port, device="cpu", **tkw).run(
        _mk_requests(cfg.vocab_size, 8, seed, max_new=max_new))
    dis = DisaggServeEngine(port, device="cpu", **tkw).run(
        _mk_requests(cfg.vocab_size, 8, seed, max_new=max_new))
    want = RefDisagg(ref, params, **jkw).run(
        _mk_requests(cfg.vocab_size, 8, seed, max_new=max_new, port=False))
    assert set(co.outputs) == set(dis.outputs) == set(want.outputs)
    for rid in sorted(want.outputs):
        w = list(want.outputs[rid].token_ids)
        assert list(co.outputs[rid].token_ids) == w, rid
        assert list(dis.outputs[rid].token_ids) == w, rid
    for name in COUNTERS:
        assert getattr(dis, name) == getattr(want, name), name
    assert (dis.preemptions, dis.steps) == (want.preemptions, want.steps)
    assert dis.handoffs >= 8                     # every request transferred
    return dis


@pytest.mark.parametrize("case", list(CASES))
def test_byte_identity_matches_colocated_and_reference(llama, case):
    c = CASES[case]
    s = _identical(llama, c["seed"], c["max_new"], c["kw"])
    assert s.handoff_bytes > 0 and s.handoff_pages > 0
    if case == "prefix_sharing":
        assert s.handoff_shared_tokens > 0       # decode-side prefix hits
    if case == "speculative":
        assert s.spec_windows > 0
    if case == "preemption":
        assert s.preemptions > 0, "settings no longer force preemption"
        assert s.handoffs > 8                    # re-handoffs after restarts


def test_byte_identity_mla_latent_pools(deepseek):
    """Reduced deepseek-v2-lite: the latent ``c_kv`` / ``k_rope`` pools
    travel; each page's bytes are the latent rank plus the rope dims of
    every layer."""
    cfg = deepseek[0]
    s = _identical(deepseek, 5, 8, {})
    page = BASE["page_size"] * (cfg.kv_lora_rank + cfg.rope_head_dim) * 4
    assert s.handoff_bytes == s.handoff_pages * page * cfg.n_layers


def test_handoff_bytes_are_every_leaf_of_every_page(llama):
    """fp8 pools move their codes and their f32 scale leaves; the bytes of
    a transfer are the pages' rows of every leaf and nothing else."""
    cfg, _, _, port = llama
    kw = _engine_kw(dict(cache_dtype="fp8"), True)
    dis = DisaggServeEngine(port, device="cpu", **kw)
    s = dis.run(_mk_requests(cfg.vocab_size, 4, 11))
    kvh, hd, page = cfg.n_kv_heads, cfg.hd, BASE["page_size"]
    per_page = cfg.n_layers * 2 * page * kvh * (hd + 4)   # codes + scales
    assert s.handoff_bytes == s.handoff_pages * per_page
    staged, nbytes = dis.prefill.extract_pages([1, 2])
    assert staged.dtype == torch.uint8 and staged.shape == (2, per_page)
    assert nbytes == 2 * per_page


def test_install_pages_round_trips_every_leaf(llama):
    """Pages gathered from one engine and scattered into another's other
    page ids land bit for bit in every leaf (codes and scales)."""
    _, _, _, port = llama
    kw = _engine_kw(dict(cache_dtype="fp8"), True)
    a = ContinuousServeEngine(port, device="cpu", phase="prefill", **kw)
    b = ContinuousServeEngine(port, device="cpu", phase="decode", **kw)
    a.reset()
    b.reset()
    gen = torch.Generator().manual_seed(0)
    for raw in a._pool_leaves():
        raw.copy_(torch.randint(0, 255, raw.shape, generator=gen,
                                dtype=torch.uint8).view(raw.dtype)
                  if raw.dtype == torch.uint8 else
                  torch.randn(raw.shape, generator=gen).to(raw.dtype))
    before = [raw[1].clone() for raw in b._pool_leaves()]
    staged, _ = a.extract_pages([3, 5, 7])
    b.install_pages(staged, [10, 2, 4])
    for ra, rb, old in zip(a._pool_leaves(), b._pool_leaves(), before):
        for s, d in ((3, 10), (5, 2), (7, 4)):
            assert torch.equal(ra[s].view(torch.uint8),
                               rb[d].view(torch.uint8))
        assert torch.equal(rb[1], old)             # an untouched page


def test_disagg_incremental_api_and_run_guard(llama):
    cfg, _, _, port = llama
    dis = DisaggServeEngine(port, device="cpu", **_engine_kw({}, True))
    reqs = _mk_requests(cfg.vocab_size, 3, 7)
    for r in reqs:
        dis.add_request(r)
    dis.step()
    assert dis.has_unfinished()
    with pytest.raises(RuntimeError, match="unfinished"):
        dis.run(_mk_requests(cfg.vocab_size, 2, 8))
    steps = 0
    while dis.has_unfinished():
        dis.step()
        steps += 1
        assert steps < 200
    assert all(len(r.tokens) >= r.max_new_tokens for r in reqs)
    assert dis.stats().handoffs == 3


def test_phase_engines_guard_their_entry_points(llama):
    """A decode-phase engine refuses ``add_request`` (it admits only
    through the handoff), a phase-split engine refuses ``run()``, an
    unknown phase raises; the reference's words."""
    _, ref, params, port = llama
    tkw, jkw = _engine_kw({}, True), _engine_kw({}, False)
    dec = ContinuousServeEngine(port, device="cpu", phase="decode", **tkw)
    jdec = RefEngine(ref, params, phase="decode", **jkw)
    req = _mk_requests(64, 1, 0)[0]
    for eng, r in ((dec, req), (jdec, _mk_requests(64, 1, 0, port=False)[0])):
        with pytest.raises(RuntimeError, match="only accepts requests "
                                               "through the KV handoff"):
            eng.add_request(r)
    pre = ContinuousServeEngine(port, device="cpu", phase="prefill", **tkw)
    with pytest.raises(RuntimeError, match="DisaggServeEngine.run"):
        pre.run([req])
    with pytest.raises(ValueError, match="expected 'colocated'"):
        ContinuousServeEngine(port, device="cpu", phase="verify", **tkw)


def test_handoff_geometry_mismatch_raises(llama):
    _, _, _, port = llama
    kw = dict(num_slots=2, num_pages=16, max_len=32)
    a = ContinuousServeEngine(port, device="cpu", page_size=4, **kw)
    b = ContinuousServeEngine(port, device="cpu", page_size=8, **kw)
    with pytest.raises(ValueError, match="page_size"):
        KVHandoff(a, b)
    c = ContinuousServeEngine(port, device="cpu", page_size=4,
                              speculative=SpeculativeConfig(gamma=3), **kw)
    with pytest.raises(ValueError, match="speculative"):
        KVHandoff(a, c)
    d = ContinuousServeEngine(port, device="cpu", page_size=4,
                              cache_dtype="fp8", **kw)
    with pytest.raises(ValueError, match="cache_dtype"):
        KVHandoff(a, d)


def test_llm_engine_disaggregate_matches_reference(llama):
    """``LLMEngine(disaggregate=True)``, greedy and sampled, with a smaller
    prefill side (``prefill_slots`` / ``prefill_pages``): the reference's
    streams and counters."""
    from repro.runtime.llm import LLMEngine as RefLLM
    cfg, ref, params, port = llama
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 9, 14, 17)]
    prompts[2][:8] = prompts[0][:8]
    kws = [dict(), dict(temperature=0.8, top_k=16, seed=3)] * 2
    eng = dict(backend="continuous", max_len=48, num_slots=3, page_size=4,
               prefill_chunk=8, num_pages=30, disaggregate=True,
               prefill_slots=2, prefill_pages=20)
    want = RefLLM(ref, params, cache_dtype=jnp.float32, **eng).generate(
        prompts, [RefSP(max_tokens=7, **k) for k in kws])
    llm = LLMEngine(port, device="cpu", cache_dtype=torch.float32, **eng)
    got = llm.generate(prompts, [SamplingParams(max_tokens=7, **k)
                                 for k in kws])
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert isinstance(llm._eng, DisaggServeEngine)
    assert (llm._eng.prefill.num_slots, llm._eng.prefill.num_pages) == (2, 20)
    assert llm.last_stats.handoffs == 4 and llm.last_stats.steps > 0


@pytest.mark.parametrize("name", ["mamba2-370m", "hymba-1.5b"])
def test_stateful_models_refuse_phase_split(name):
    """mamba2 / hymba refuse ``phase=`` (and ``disaggregate=True``) with
    the reference's message, word for word."""
    cfg = reduced_config(get_config(name))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(name))
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = Model(tcfg, device="cpu")
    kw = dict(num_slots=2, page_size=4, num_pages=40, max_len=32)
    with pytest.raises(NotImplementedError) as want:
        RefEngine(ref, params, phase="prefill", **kw)
    with pytest.raises(NotImplementedError) as got:
        ContinuousServeEngine(port, device="cpu", phase="prefill", **kw)
    assert str(got.value) == str(want.value)
    assert "disaggregated serving is unsupported" in str(got.value)
    with pytest.raises(NotImplementedError) as got:
        LLMEngine(port, device="cpu", disaggregate=True, **kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# phase-aware deployment budgets
# ---------------------------------------------------------------------------


def _numbers(dep) -> dict:
    out = {}
    for f in dataclasses.fields(dep):
        if f.name in ("spec", "mesh", "cache_dtype", "device"):
            continue
        out[f.name] = getattr(dep, f.name)
    out["pool_bytes_per_device"] = dep.pool_bytes_per_device
    return out


@pytest.mark.parametrize("sku", ["h100", "h200", "rpu-cu"])
def test_phase_budgets_match_reference(sku):
    """``resolve(phase=)`` of the full qwen3-14b, every numeric field at
    1e-12 (counts exactly), or the reference's ``DeploymentError`` word for
    word where one RPU unit cannot hold the weights; and the properties
    ``tests/test_disagg.py`` checks: prefill sizes fewer slots and pages
    than decode, its compute-roofline ceiling beats decode's on prompt
    work, its chunk is derived and page-aligned."""
    ref = build_model(get_config("qwen3-14b"))
    port = Model(tconfigs.get_config("qwen3-14b"), device="meta")
    kw = dict(sku=sku, max_len=2048, weight_format="mxfp4", max_slots=32)
    got = {}
    for phase in ("colocated", "prefill", "decode"):
        try:
            want = jdep.DeploymentSpec(cache_dtype="fp8", **kw).resolve(
                ref, phase=phase)
        except jdep.DeploymentError as e:
            with pytest.raises(tdep.DeploymentError) as err:
                tdep.DeploymentSpec(cache_dtype="fp8", **kw).resolve(
                    port, phase=phase)
            assert str(err.value) == str(e)
            continue
        got[phase] = tdep.DeploymentSpec(cache_dtype="fp8", **kw).resolve(
            port, phase=phase)
        g, w = _numbers(got[phase]), _numbers(want)
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], float):
                assert g[k] == pytest.approx(w[k], rel=REL, abs=0), k
            else:
                assert g[k] == w[k], k
        assert got[phase].describe() == want.describe()
    if not got:
        return
    rp, rd = got["prefill"], got["decode"]
    assert rp.num_slots < rd.num_slots and rp.num_pages < rd.num_pages
    assert rp.tokens_per_s_ceiling > rd.tokens_per_s_ceiling
    assert rp.prefill_chunk_derived and rp.prefill_chunk % rp.page_size == 0
    with pytest.raises(ValueError, match="phase"):
        tdep.DeploymentSpec(**kw).resolve(port, phase="verify")


# ---------------------------------------------------------------------------
# the fleet's disaggregated simulator
# ---------------------------------------------------------------------------


def _flat(d: dict, pre: str = "") -> dict:
    """A summary's nested dicts as one flat dict of ``a.b`` keys."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


def _served(fs):
    return [(s.req.rid, s.first_tok_t, s.finish_t, s.emitted)
            for s in fs.served]


def test_disagg_fleet_simulator_conservation_matches_reference():
    """Every request is served or shed, every served chain is handed off
    once, and the run equals the reference's event for event (times at
    1e-12) and its summary."""
    trace, ref_trace = (gate_workload(400, 7, "mmpp", 120.0),
                        ref_gate_workload(400, 7, "mmpp", 120.0))
    runs = []
    for sim, spec, router, tab, tr in (
            (DisaggFleetSimulator, ReplicaSpec, PrefixAffinityRouter,
             gate_table, trace),
            (RefDisaggSim, RefReplicaSpec, RefRouter, ref_gate_table,
             ref_trace)):
        p = spec(latency=tab(), num_slots=4, max_queue=16, page_size=16,
                 prefix_blocks=24)
        d = spec(latency=tab(), num_slots=8, max_queue=16, page_size=16,
                 prefix_blocks=24)
        runs.append(sim(p, 2, d, 2, router(), kv_token_bytes=128.0).run(tr))
    fs, want = runs
    assert len(fs.served) + len(fs.shed) == 400
    assert fs.handoffs == len(fs.served) and fs.handoff_bytes > 0
    assert fs.handoff_shared_tokens > 0
    assert all(sr.emitted == sr.req.output_len for sr in fs.served)
    assert (fs.handoffs, fs.handoff_bytes, fs.handoff_shared_tokens) == (
        want.handoffs, want.handoff_bytes, want.handoff_shared_tokens)
    got_ev, want_ev = _served(fs), _served(want)
    assert [e[0] for e in got_ev] == [e[0] for e in want_ev]
    np.testing.assert_allclose(np.array([e[1:] for e in got_ev], float),
                               np.array([e[1:] for e in want_ev], float),
                               rtol=REL, atol=0)
    assert _flat(fs.summary()) == pytest.approx(_flat(want.summary()),
                                                rel=REL)


def test_disagg_simulator_decode_never_reruns_prefill():
    """Decode-class replicas admit transferred chains with no prefill left,
    so TPOT never pays the chunk-interleave tax the colocated fleet pays
    on the same table; both as the reference's."""
    trace = gate_workload(300, 3, "mmpp", 40.0)
    table = dataclasses.replace(gate_table(), prefill_chunk_s=0.01)
    spec = ReplicaSpec(latency=table, num_slots=8, max_queue=16,
                       page_size=16, prefix_blocks=24)
    co = FleetSimulator(spec, 4, PrefixAffinityRouter()).run(trace)
    dis = DisaggFleetSimulator(spec, 2, spec, 2, PrefixAffinityRouter(),
                               kv_token_bytes=128.0).run(trace)
    assert dis.tpot_quantiles()["p95"] <= co.tpot_quantiles()["p95"]
    assert len(dis.served) >= len(co.served) * 0.9
    rtable = dataclasses.replace(ref_gate_table(), prefill_chunk_s=0.01)
    rspec = RefReplicaSpec(latency=rtable, num_slots=8, max_queue=16,
                           page_size=16, prefix_blocks=24)
    rtrace = ref_gate_workload(300, 3, "mmpp", 40.0)
    rco = RefFleetSim(rspec, 4, RefRouter()).run(rtrace)
    rdis = RefDisaggSim(rspec, 2, rspec, 2, RefRouter(),
                        kv_token_bytes=128.0).run(rtrace)
    assert co.tpot_quantiles() == pytest.approx(rco.tpot_quantiles(),
                                                rel=REL)
    assert dis.tpot_quantiles() == pytest.approx(rdis.tpot_quantiles(),
                                                 rel=REL)
