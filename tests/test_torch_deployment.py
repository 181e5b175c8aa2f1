"""The port's deployment planner against the JAX reference on the CPU.

``core/hardware.py`` and ``core/hbmco.py`` are copies, so their constants
and derived numbers must be the reference's; ``compute_footprint``,
``paged_kv_token_bytes`` and every numeric field of ``ResolvedDeployment``
are arithmetic, so they are held to the reference's numbers (integers
exactly, floats to 1e-12 relative), across SKUs, HBM-CO stacks, weight
formats, cache dtypes, a draft and the three phases, with and without
exact weights.  Then the engines: ``spec=`` gives the reference engine's
geometry, the pools the port allocates are the bytes the budget prices,
and f32 streams under ``spec=`` equal the reference's through a
capacity-pressure preemption storm and under a ``max_decode_slots`` cap
(the reference's own ``tests/test_deployment.py`` scenarios)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced_config
from repro.core import hardware as jhw
from repro.core import hbmco as jhbm
from repro.models.footprint import compute_footprint as j_footprint
from repro.models.model import build_model
from repro.parallel.plan import paged_kv_token_bytes as j_token_bytes
from repro.parallel.plan import paged_kv_token_bytes_split as j_token_split
from repro.quant import formats as jformats
from repro.quant.linear import quantizable_leaf
from repro.runtime import deployment as jdep
from repro.runtime.engine import ContinuousServeEngine as RefEngine
from repro.runtime.llm import LLMEngine as RefLLM
from repro.runtime.sampling import SamplingParams as RefSP
from repro.runtime.scheduler import Request as RefRequest
from repro.runtime.speculative import SpeculativeConfig as RefSpecConfig
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import hardware as thw
from repro_torch.core import hbmco as thbm
from repro_torch.models.footprint import compute_footprint
from repro_torch.models.model import Model
from repro_torch.parallel.plan import (
    paged_kv_token_bytes, paged_kv_token_bytes_split,
)
from repro_torch.runtime import deployment as tdep
from repro_torch.runtime.engine import ContinuousServeEngine
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.speculative import SpeculativeConfig
from repro_torch.runtime.spec_pair import truncated_draft

CACHE = {None: (None, None), "f32": (jnp.float32, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16), "fp8": ("fp8", "fp8"),
         "int8": ("int8", "int8")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Copied constants
# ---------------------------------------------------------------------------


def _described(obj) -> dict:
    """A dataclass's fields and every property's value."""
    out = dataclasses.asdict(obj)
    for name in dir(type(obj)):
        if isinstance(getattr(type(obj), name, None), property):
            out[name] = getattr(obj, name)
    return out


def test_hardware_and_hbmco_match_reference():
    for name in ("TPU_V5E", "H100", "H200", "RPU_DEFAULT"):
        assert _described(getattr(thw, name)) == \
            _described(getattr(jhw, name)), name
    for name in ("US", "MS", "GB", "GIB"):
        assert getattr(thw, name) == getattr(jhw, name)
    assert thw.RPU_DEFAULT.cu_tdp_w(1.45) == jhw.RPU_DEFAULT.cu_tdp_w(1.45)
    for name in ("ACT_PJ_PER_BIT", "DM_PJ_PER_BIT_MM", "TSV_PJ_PER_BIT_LAYER",
                 "IO_PJ_PER_BIT", "DM_BASE_MM", "DM_K_MM",
                 "DRAM_DENSITY_GBIT_PER_MM2", "ARRAY_AREA_FRACTION",
                 "PCH_BW_GBS", "BW_PER_SHORELINE_GBS_MM"):
        assert getattr(thbm, name) == getattr(jhbm, name), name
    for name in ("hbm3e-like", "hbmco-768MB", "co-r1c1b1m24", "co-r2c4b2m3"):
        assert _described(thbm.hbmco_by_name(name)) == \
            _described(jhbm.hbmco_by_name(name)), name
    with pytest.raises(ValueError):
        thbm.hbmco_by_name("hbm9-unobtainium")
    space_t = thbm.enumerate_design_space()
    space_j = jhbm.enumerate_design_space()
    assert [_described(c) for c in space_t] == [_described(c)
                                                for c in space_j]
    front_t = thbm.pareto_frontier(space_t)
    assert [c.name for c in front_t] == \
        [c.name for c in jhbm.pareto_frontier(space_j)]
    for need in (1e8, 3e9, 1e12):
        a, b = thbm.select_sku(need), jhbm.select_sku(need)
        assert (a and a.name) == (b and b.name)


@pytest.mark.parametrize("name", ["llama3-8b", "llama3-70b", "llama3-405b",
                                  "qwen3-14b", "qwen2.5-14b",
                                  "llama4-scout-109b-a17b",
                                  "llama4-maverick-400b-a17b",
                                  "phi3-mini-3.8b", "h2o-danube-1.8b",
                                  "mamba2-370m", "hymba-1.5b"])
def test_footprint_matches_reference(name):
    got = compute_footprint(tconfigs.get_config(name))
    want = j_footprint(get_config(name))
    for f in ("total_params", "active_params", "kv_per_token", "state_elems"):
        assert getattr(got, f) == getattr(want, f), f
    for kw in ({}, dict(bits_per_weight=16.0, kv_bytes=2)):
        assert got.capacity_bytes(8, 4096, **kw) == \
            want.capacity_bytes(8, 4096, **kw)
        assert got.streamed_bytes_per_token(8, 4096, **kw) == \
            want.streamed_bytes_per_token(8, 4096, **kw)
    assert got.decode_flops_per_token(8, 4096) == \
        want.decode_flops_per_token(8, 4096)


def test_non_dense_footprint_names_its_roadmap_item():
    """Stateful families (ssm, hybrid) are priced as the reference prices
    them since their plans are ported, as is a GQA + MoE config (the
    ``attn_moe`` kind)."""
    base = tconfigs.get_config("llama3-8b")
    for family in ("ssm", "hybrid"):
        got = compute_footprint(dataclasses.replace(base, family=family))
        want = j_footprint(dataclasses.replace(get_config("llama3-8b"),
                                               family=family))
        for f in ("total_params", "active_params", "kv_per_token",
                  "state_elems"):
            assert getattr(got, f) == getattr(want, f), (family, f)
    moe = dataclasses.replace(base, moe=True, n_experts=4,
                              n_experts_per_token=2, moe_d_ff=64)
    assert compute_footprint(moe).total_params == \
        j_footprint(dataclasses.replace(get_config("llama3-8b"), moe=True,
                                        n_experts=4, n_experts_per_token=2,
                                        moe_d_ff=64)).total_params


@pytest.mark.parametrize("cache", [None, "f32", "bf16", "fp8", "int8"])
def test_paged_kv_token_bytes_match_reference(cache):
    jc, tc = CACHE[cache]
    for name in ("llama3-8b", "qwen3-14b"):
        ref = build_model(reduced_config(get_config(name)))
        port = Model(tconfigs.reduced_config(tconfigs.get_config(name)),
                     device="meta")
        assert paged_kv_token_bytes(port, cache_dtype=tc) == \
            j_token_bytes(ref, cache_dtype=jc)
        assert paged_kv_token_bytes_split(port, cache_dtype=tc,
                                          dtype_bytes=2) == \
            j_token_split(ref, cache_dtype=jc, dtype_bytes=2)
    # tensor-parallel pricing (every config and degree against the
    # reference: test_torch_parallel.py): sharded KV leaves divide by tp
    assert paged_kv_token_bytes(port, tp=2, cache_dtype=tc) * 2 == \
        paged_kv_token_bytes(port, cache_dtype=tc)


# ---------------------------------------------------------------------------
# ResolvedDeployment, field by field
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


def _assert_same(got, want):
    g, w = _numbers(got), _numbers(want)
    assert g.keys() == w.keys()
    for k in w:
        if isinstance(w[k], float) or isinstance(g[k], float):
            assert g[k] == pytest.approx(w[k], rel=1e-12, abs=0), k
        else:
            assert g[k] == w[k], k
    assert got.as_dict().keys() == want.as_dict().keys()
    assert got.describe() == want.describe()


@pytest.fixture(scope="module")
def small():
    """Reduced qwen3-14b, the reference's own deployment fixture, with a
    1-layer draft made of the target's first layer (shared tensors on the
    port's side, the stacked leaves' first slice on the reference's)."""
    cfg = reduced_config(get_config("qwen3-14b"))
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = params_from_jax(jax.tree.map(np.asarray, params),
                           tconfigs.reduced_config(
                               tconfigs.get_config("qwen3-14b")),
                           device="cpu")
    dref = build_model(dataclasses.replace(cfg, name=cfg.name + "-draft",
                                           n_layers=1))
    dparams = dict(params)
    dparams["stacks"] = jax.tree.map(lambda a: a[0], params["stacks"])
    return dict(ref=ref, params=params, dref=dref, dparams=dparams,
                port=port, dport=truncated_draft(port, 1))


RESOLVE_CASES = {
    "rpu-cu": dict(spec=dict(sku="rpu-cu")),
    "rpu-cu-hbm3e-mxfp4-f32": dict(spec=dict(
        sku="rpu-cu", hbmco="hbm3e-like", weight_format="mxfp4",
        cache="f32")),
    "h100": dict(spec=dict(sku="h100")),
    "h100-mxfp4-fp8": dict(spec=dict(sku="h100", weight_format="mxfp4",
                                     cache="fp8")),
    "h200-mxfp4-int8-estimate": dict(exact=False, spec=dict(
        sku="h200", weight_format="mxfp4", cache="int8")),
    "tpu-v5e-f32": dict(spec=dict(sku="tpu-v5e", cache="f32",
                                  prefill_chunk=24)),
    "h100-hbmco-int8": dict(spec=dict(sku="h100", hbmco="co-r2c1b1m24",
                                      cache="int8", overcommit=2.0,
                                      mean_context=7)),
    "rpu-cu-draft-f32": dict(draft=True, spec=dict(sku="rpu-cu",
                                                   cache="f32")),
    "h100-draft-mxfp4-fp8": dict(draft=True, alpha=0.85, gamma=4, spec=dict(
        sku="h100", weight_format="mxfp4", cache="fp8")),
    "h100-draft-estimate": dict(draft=True, exact=False, alpha=1.0,
                                spec=dict(sku="h100")),
    "h100-prefill-mxfp4": dict(phase="prefill", spec=dict(
        sku="h100", weight_format="mxfp4")),
    "rpu-cu-decode-int8": dict(phase="decode", spec=dict(
        sku="rpu-cu", cache="int8")),
    "tpu-v5e-prefill-draft": dict(phase="prefill", draft=True, spec=dict(
        sku="tpu-v5e", weight_format="nxfp4")),
}


@pytest.mark.parametrize("case", list(RESOLVE_CASES))
def test_resolved_deployment_matches_reference(small, case):
    c = RESOLVE_CASES[case]
    skw = dict(max_len=64, page_size=8, max_slots=4, **c["spec"])
    jc, tc = CACHE[skw.pop("cache", None)]
    exact = c.get("exact", True)
    kw = dict(phase=c.get("phase", "colocated"))
    jkw, tkw = dict(kw), dict(kw)
    if c.get("draft"):
        for d in (jkw, tkw):
            d.update(gamma=c.get("gamma", 8),
                     spec_accept_rate=c.get("alpha", 0.7))
        jkw.update(draft=small["dref"],
                   draft_params=small["dparams"] if exact else None)
        tkw.update(draft=small["dport"],
                   draft_params=small["dport"] if exact else None)
    want = jdep.DeploymentSpec(cache_dtype=jc, **skw).resolve(
        small["ref"], params=small["params"] if exact else None, **jkw)
    got = tdep.DeploymentSpec(cache_dtype=tc, **skw).resolve(
        small["port"], params=small["port"] if exact else None, **tkw)
    _assert_same(got, want)


@pytest.mark.parametrize("name", ["llama3-8b", "llama3-70b",
                                  "phi3-mini-3.8b", "h2o-danube-1.8b",
                                  "mamba2-370m", "hymba-1.5b"])
def test_full_size_pricing_matches_reference_without_weights(name):
    """Full-width configs priced from a ``meta``-device model: by the
    footprint estimate, and exactly from its parameters' shapes (the
    reference: ``jax.eval_shape`` of its init); nothing is allocated."""
    ref = build_model(get_config(name))
    abstract = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    port = Model(tconfigs.get_config(name), device="meta")
    for sku, fmt, cache in (("h100", None, None), ("h100", "mxfp4", "fp8"),
                            ("h200", "mxfp4", "fp8")):
        jc, tc = CACHE[cache]
        skw = dict(sku=sku, weight_format=fmt, max_len=2048)
        for jp, tp in ((None, None), (abstract, port)):
            try:
                want = jdep.DeploymentSpec(cache_dtype=jc, **skw).resolve(
                    ref, params=jp)
            except jdep.DeploymentError:
                with pytest.raises(tdep.DeploymentError):
                    tdep.DeploymentSpec(cache_dtype=tc, **skw).resolve(
                        port, params=tp)
                continue
            _assert_same(tdep.DeploymentSpec(cache_dtype=tc, **skw).resolve(
                port, params=tp), want)


def test_deployment_errors_match_reference(small):
    ref, port = small["ref"], small["port"]
    tiny = dict(name="co-tiny", ranks=1, channels_per_layer=1,
                banks_per_group=1, bank_mb=0.001)          # 32 KB stack
    with pytest.raises(jdep.DeploymentError, match="cannot back one"):
        jdep.DeploymentSpec(sku="rpu-cu", hbmco=jhbm.HBMCOConfig(**tiny),
                            stacks_per_device=1, cache_dtype=jnp.float32,
                            max_len=64).resolve(ref, params=small["params"])
    with pytest.raises(tdep.DeploymentError, match="cannot back one"):
        tdep.DeploymentSpec(sku="rpu-cu", hbmco=thbm.HBMCOConfig(**tiny),
                            stacks_per_device=1, cache_dtype=torch.float32,
                            max_len=64).resolve(port, params=port)
    with pytest.raises(ValueError, match="weight_format"):
        tdep.DeploymentSpec(weight_format="int3")
    with pytest.raises(ValueError, match="unknown sku"):
        tdep.DeploymentSpec(sku="b200").device_budget()
    with pytest.raises(ValueError, match="cache_dtype"):
        tdep.DeploymentSpec(cache_dtype="fp4")
    for bad in (dict(max_len=0), dict(max_slots=0), dict(overcommit=0.0),
                dict(workspace_fraction=1.0)):
        with pytest.raises(ValueError):
            tdep.DeploymentSpec(**bad)
    with pytest.raises(ValueError, match="phase"):
        tdep.DeploymentSpec().resolve(port, phase="both")
    # 405B does not fit one H100 even at 4.25 bits a weight
    big = Model(tconfigs.get_config("llama3-405b"), device="meta")
    jbig = build_model(get_config("llama3-405b"))
    for mod, m in ((jdep, jbig), (tdep, big)):
        with pytest.raises(mod.DeploymentError, match="cannot back one"):
            mod.DeploymentSpec(sku="h100", weight_format="mxfp4",
                               cache_dtype="fp8").resolve(m)
    # a sliding-window model prices ring pages; a draft or a phase split
    # is refused for it, as in the reference
    wcfg = dataclasses.replace(reduced_config(get_config("llama3-8b")),
                               sliding_window=8)
    jw = build_model(wcfg)
    tw = Model(dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config("llama3-8b")),
        sliding_window=8), device="meta")
    for mod, m, d in ((jdep, jw, small["dref"]), (tdep, tw, small["dport"])):
        spec = mod.DeploymentSpec(sku="rpu-cu", max_len=64, page_size=4)
        with pytest.raises(mod.DeploymentError, match="speculative"):
            spec.resolve(m, draft=d)
        with pytest.raises(mod.DeploymentError, match="phase"):
            spec.resolve(m, phase="prefill")
    _assert_same(tdep.DeploymentSpec(sku="rpu-cu", max_len=64, page_size=4,
                                     prefill_chunk=16).resolve(tw),
                 jdep.DeploymentSpec(sku="rpu-cu", max_len=64, page_size=4,
                                     prefill_chunk=16).resolve(jw))
    # a mesh in the spec or the call prices as its dims (no ranks, no
    # process group); one that is not DxM is refused
    with pytest.raises(ValueError, match="DxM"):
        tdep.DeploymentSpec(mesh="1by2").resolve(port)
    with pytest.raises(ValueError):
        tdep.DeploymentSpec().resolve(port, mesh=(1, 2, 3))
    assert tdep.DeploymentSpec(mesh="1x2").resolve(port, device="cpu").tp \
        == tdep.DeploymentSpec().resolve(port, mesh=(1, 2)).tp == 2


# ---------------------------------------------------------------------------
# Spec-driven engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """Reduced qwen3-14b with its projection weights round-tripped through
    mxfp4 (so both frameworks' quantizers give the same codes), in f32 on
    both sides, as the quantized engine tests do."""
    cfg = reduced_config(get_config("qwen3-14b"))
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))

    def rt(path, leaf):
        if quantizable_leaf(path, leaf, "mxfp4"):
            p = jformats.quantize(leaf, "mxfp4")
            return jformats.dequantize(p, "mxfp4").astype(leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(rt, params)
    port = params_from_jax(jax.tree.map(np.asarray, params),
                           tconfigs.reduced_config(
                               tconfigs.get_config("qwen3-14b")),
                           device="cpu").float()
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    base = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                                         cfg.vocab_size))
    prompts = base[np.array([0, 1, 0, 1, 0, 1])]   # 2 distinct: prefix hits
    return dict(cfg=cfg, ref=ref, params=f32, port=port, prompts=prompts)


MIX = [dict() if i % 2 == 0 else
       dict(temperature=0.9, top_k=8, top_p=0.95, seed=100 + i)
       for i in range(6)]
SPEC = dict(sku="rpu-cu", hbmco="hbmco-768MB", weight_format="mxfp4",
            max_len=21, page_size=4, prefill_chunk=5, max_slots=3)


def _specs(**kw):
    return (jdep.DeploymentSpec(cache_dtype=jnp.float32, **{**SPEC, **kw}),
            tdep.DeploymentSpec(cache_dtype=torch.float32, **{**SPEC, **kw}))


def _drive(eng, request_cls, sp_cls, prompts, check=False):
    """Serve the mix through the incremental interface; returns (streams,
    peak concurrent requests)."""
    for i in range(6):
        eng.add_request(request_cls(rid=i, prompt=prompts[i],
                                    max_new_tokens=8,
                                    sampling=sp_cls(**MIX[i])))
    peak = 0
    while eng.has_unfinished():
        eng.step()
        peak = max(peak, len(eng._sched.running))
        if check:
            eng.cache.allocator.check()
    return [list(r.tokens[:8]) for r in eng._requests], peak


def test_engine_geometry_from_spec_matches_reference(served):
    """``spec=`` sizes the port's engines as it sizes the reference's:
    slots, pages, chunk and the admission hint, also with the draft priced
    in (self-draft), and the static backend's max_len and cache dtype."""
    ref, port, params = served["ref"], served["port"], served["params"]
    attrs = ("num_slots", "num_pages", "prefill_chunk", "max_decode_slots",
             "page_size", "max_len")
    for kw in (dict(), dict(prefill_chunk=None, max_slots=8)):
        jspec, tspec = _specs(**kw)
        for rsc, tsc in ((None, None), (RefSpecConfig(gamma=3),
                                        SpeculativeConfig(gamma=3))):
            want = RefEngine(ref, params, spec=jspec, speculative=rsc)
            got = ContinuousServeEngine(port, device="cpu", spec=tspec,
                                        speculative=tsc)
            assert {a: getattr(got, a) for a in attrs} == \
                {a: getattr(want, a) for a in attrs}
            _assert_same(got.deployment, want.deployment)
            assert got.cache_dtype == torch.float32
            assert got.weight_format == "mxfp4"
    # explicit kwargs override single values
    eng = ContinuousServeEngine(port, device="cpu", spec=tspec, num_slots=2,
                                max_decode_slots=1)
    assert (eng.num_slots, eng.max_decode_slots) == (2, 1)
    assert eng.num_pages == eng.deployment.num_pages
    llm = LLMEngine(port, device="cpu", spec=tspec)
    assert llm.deployment is llm._eng.deployment
    assert llm.kv_token_bytes_per_device() == llm.deployment.kv_token_bytes
    static = LLMEngine(port, backend="static", device="cpu",
                       spec=tdep.DeploymentSpec(sku="tpu-v5e", max_len=21,
                                                cache_dtype=torch.float32))
    assert static.max_len == 21 and static._eng.cache_dtype == torch.float32
    assert static.deployment.device.name == "tpu_v5e"
    legacy = LLMEngine(port, backend="speculative", device="cpu", gamma=3,
                       spec=tdep.DeploymentSpec(sku="h100", max_len=40))
    wlegacy = RefLLM(ref, params, backend="speculative", gamma=3,
                     spec=jdep.DeploymentSpec(sku="h100", max_len=40))
    assert legacy.max_len == 40
    _assert_same(legacy.deployment, wlegacy.deployment)
    with pytest.raises(ValueError, match="DeploymentSpec"):
        ContinuousServeEngine(port, device="cpu", num_slots=2)


@pytest.mark.parametrize("cache,draft", [
    ("f32", None), ("bf16", "self"), ("fp8", None), ("int8", "truncated")])
def test_allocated_pools_equal_the_budget(served, cache, draft):
    """The bytes of the torch pools the engine allocates, scratch page
    excluded, are ``pool_bytes_per_device``: with a draft, both pool
    sets."""
    port = served["port"]
    sc = {None: None, "self": SpeculativeConfig(gamma=2),
          "truncated": SpeculativeConfig(draft_model=truncated_draft(port, 1),
                                         gamma=2)}[draft]
    spec = tdep.DeploymentSpec(**{**SPEC, "weight_format": None},
                               cache_dtype=CACHE[cache][1])
    eng = ContinuousServeEngine(port, device="cpu", spec=spec, speculative=sc)
    eng.reset()
    dep = eng.deployment
    total = sum(leaf.nbytes for leaf in eng._pool_leaves())
    assert total - dep.kv_token_bytes * dep.page_size == \
        dep.pool_bytes_per_device
    if draft is None:
        assert eng.kv_token_bytes_per_device() == dep.kv_token_bytes


def test_spec_streams_match_reference_through_storm_and_decode_cap(served):
    """f32 greedy and sampled streams under ``spec=`` equal the reference
    engine's: with the spec's own geometry; under a spec whose pool is so
    small that requests are preempted and restarted (allocator invariants
    checked every iteration); and with ``max_decode_slots=2`` capping the
    requests that hold a slot at once."""
    ref, port, params = served["ref"], served["port"], served["params"]
    prompts = served["prompts"]
    jspec, tspec = _specs()
    want, wpeak = _drive(RefEngine(ref, params, spec=jspec), RefRequest,
                         RefSP, prompts)
    got, peak = _drive(ContinuousServeEngine(port, device="cpu", spec=tspec),
                       Request, SamplingParams, prompts)
    assert got == want and peak == wpeak > 2

    # capacity = weights + ~7.6 pages: far less than 3 slots x 6 blocks
    page_bytes = paged_kv_token_bytes(port, dtype_bytes=4) * 4
    from repro_torch.quant.linear import serve_weight_bytes
    cap = serve_weight_bytes(port, "mxfp4") + 7.6 * page_bytes
    hbm = dict(name="co-storm", ranks=1, channels_per_layer=1,
               banks_per_group=1, bank_mb=cap / (32 * 2 ** 20))
    storm = dict(stacks_per_device=1, overcommit=4.0, mean_context=1,
                 workspace_fraction=0.0)
    jstorm = dataclasses.replace(jspec, hbmco=jhbm.HBMCOConfig(**hbm),
                                 **storm)
    tstorm = dataclasses.replace(tspec, hbmco=thbm.HBMCOConfig(**hbm),
                                 **storm)
    weng = RefEngine(ref, params, spec=jstorm)
    teng = ContinuousServeEngine(port, device="cpu", spec=tstorm)
    assert (teng.num_pages, teng.num_slots) == (weng.num_pages, 3)
    assert teng.num_pages <= 9, "the pool is no longer under pressure"
    storm_want, _ = _drive(weng, RefRequest, RefSP, prompts)
    storm_got, _ = _drive(teng, Request, SamplingParams, prompts, check=True)
    assert sum(r.preemptions for r in teng._requests) > 0, \
        "no preemption pressure exercised"
    assert storm_got == storm_want == want

    weng = RefEngine(ref, params, num_slots=3, page_size=4,
                     num_pages=40, max_len=21, prefill_chunk=5,
                     cache_dtype=jnp.float32, max_decode_slots=2,
                     weight_format="mxfp4")
    teng = ContinuousServeEngine(port, device="cpu", num_slots=3, page_size=4,
                                 num_pages=40, max_len=21, prefill_chunk=5,
                                 cache_dtype=torch.float32,
                                 max_decode_slots=2, weight_format="mxfp4")
    capped_want, _ = _drive(weng, RefRequest, RefSP, prompts)
    capped, cpeak = _drive(teng, Request, SamplingParams, prompts)
    assert cpeak <= 2 and capped == capped_want == want


def test_ring_pools_equal_the_budget():
    """h2o-danube (every layer a window): the engine sized by ``spec=``
    allocates exactly ``pool_bytes_per_device``, all of it ring pool (its
    scratch page excluded), and the budget is the reference's, field for
    field (``num_ring_pages`` among them)."""
    name = "h2o-danube-1.8b"
    ref = build_model(reduced_config(get_config(name)))
    params = ref.init(jax.random.PRNGKey(0))
    port = params_from_jax(jax.tree.map(np.asarray, params),
                           tconfigs.reduced_config(tconfigs.get_config(name)),
                           device="cpu")
    for cache in ("f32", "fp8"):
        jc, tc = CACHE[cache]
        skw = dict(sku="rpu-cu", max_len=64, page_size=4, prefill_chunk=16)
        want = jdep.DeploymentSpec(cache_dtype=jc, **skw).resolve(
            ref, params=params)
        eng = ContinuousServeEngine(
            port, device="cpu", spec=tdep.DeploymentSpec(cache_dtype=tc,
                                                         **skw))
        eng.reset()
        dep = eng.deployment
        _assert_same(dep, want)
        assert dep.num_ring_pages > 0 and eng.ring_pages == dep.num_ring_pages
        assert dep.kv_token_bytes == dep.ring_token_bytes
        total = sum(leaf.nbytes for pool in eng._pools
                    for leaf in pool.values())
        assert total - dep.ring_token_bytes * dep.page_size == \
            dep.pool_bytes_per_device
