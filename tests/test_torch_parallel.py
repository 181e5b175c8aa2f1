"""The port's tensor-parallel serve plan against the JAX reference, in one
process (the multi-rank runs are ``test_torch_tp.py``).

``parallel/plan.py``'s ``PagedServePlan`` on bridged weights: the local and
pool configs, the KV-head replication of ``prepare_params`` (bit for bit),
which parameter and pool leaves shard along which dim (the reference's
``tests/test_parallel.py`` cases: plain, fp8 pools and mxfp4-packed
weights, KV-head replication, MLA pools replicated, the validation
messages), ``local_model``'s slices, and the pricing
(``paged_kv_token_bytes(tp=, kv_repl=)``, ``psum_bytes_per_step``) for
every registered config and every TP degree in {2, 4, 8} the plan
accepts; then ``DeploymentSpec`` on a mesh, number for number.  A port
``MeshShape`` stands for the reference's abstract mesh (and, for the
deployment, a JAX ``Mesh`` of the one CPU device repeated: the reference
resolves only real meshes)."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.models  # noqa: F401  (import order: models before kernels)
import jax
import jax.numpy as jnp

from repro.configs import get_config, reduced_config
from repro.models.model import build_model
from repro.parallel import plan as jplan
from repro.parallel.compat import make_abstract_mesh
from repro.quant.linear import quantize_params as j_quantize
from repro.runtime import deployment as jdep
from repro_torch import configs as tconfigs
from repro_torch.bridge import _layer_locations, params_from_jax
from repro_torch.launch.mesh import MeshShape, parse_mesh
from repro_torch.models.model import Model
from repro_torch.parallel import hints
from repro_torch.parallel import plan as tplan
from repro_torch.quant.linear import qdot, quantize_params
from repro_torch.runtime import deployment as tdep

TP_DEGREES = (2, 4, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(tp: int, data: int = 1):
    return (make_abstract_mesh((data, tp), ("data", "model")),
            MeshShape((data, tp)))


def _cfgs(arch: str, **kw):
    return (dataclasses.replace(reduced_config(get_config(arch)), **kw),
            dataclasses.replace(tconfigs.reduced_config(
                tconfigs.get_config(arch)), **kw))


def _bridged(name: str, seed: int = 0, **kw):
    jcfg, tcfg = _cfgs(name, **kw)
    ref = build_model(jcfg)
    params = ref.init(jax.random.PRNGKey(seed))
    port = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                           device="cpu")
    return jcfg, tcfg, ref, params, port


def _ref_spec(params, name: str, locs, specs):
    """The reference's PartitionSpec of the leaf behind port parameter
    ``name`` and whether its segment is stacked (a leading reps dim)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return specs[name], False
    si, ki, _, stacked = locs[int(parts[1])]
    node = specs["stacks"][si][ki]
    for key in parts[2:]:
        node = node[key]
    return node, stacked


def _port_dim(spec, stacked: bool, ndim: int):
    """A reference spec as the port's shard dim of the unstacked leaf."""
    entries = [spec[i] if i < len(spec) else None
               for i in range(ndim + stacked)]
    dims = [i for i, e in enumerate(entries) if e == "model"]
    assert len(dims) <= 1, spec
    return dims[0] - stacked if dims else None


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw,tp", [
    ("qwen3-14b", dict(n_heads=8, n_kv_heads=4), 4),
    ("qwen3-14b", dict(n_heads=8, n_kv_heads=2), 8),
    ("qwen3-14b", {}, 4),
    ("llama3-8b", {}, 2),
    ("deepseek-v2-lite-16b", {}, 4),
    ("h2o-danube-1.8b", {}, 2),
    ("llama4-scout-109b-a17b", {}, 2),
])
def test_local_and_pool_config_match_reference(name, kw, tp):
    jcfg, tcfg = _cfgs(name, **kw)
    jm, tm = _meshes(tp)
    jp = jplan.make_paged_serve_plan(jcfg, jm)
    tp_ = tplan.make_paged_serve_plan(tcfg, tm)
    assert (tp_.tp, tp_.kv_repl, tp_.reduce) == (jp.tp, jp.kv_repl,
                                                 jp.reduce) == (
        tp, jp.kv_repl, "gather")
    for fn in ("local_config", "pool_config"):
        assert dataclasses.asdict(getattr(tp_, fn)(tcfg)) == \
            dataclasses.asdict(getattr(jp, fn)(jcfg)), fn


def test_prepare_params_match_reference_bitwise():
    """KV-head replication on bridged weights: 2 KV heads on an 8-way axis
    (kv_repl 4), qkv biases on (qwen2.5's)."""
    jcfg, tcfg, _, params, port = _bridged("qwen2.5-14b", n_heads=8,
                                           n_kv_heads=2)
    jm, tm = _meshes(8)
    jp = jplan.make_paged_serve_plan(jcfg, jm)
    tp_ = tplan.make_paged_serve_plan(tcfg, tm)
    assert tp_.kv_repl == jp.kv_repl == 4
    want = params_from_jax(
        jax.tree.map(np.asarray, jp.prepare_params(params, jcfg)),
        tp_.pool_config(tcfg), device="cpu")
    got = tp_.prepare_params(dict(port.named_parameters()), tcfg)
    assert got.keys() == dict(want.named_parameters()).keys()
    widened = 0
    for name, w in want.named_parameters():
        assert torch.equal(got[name], w), name
        widened += name.split(".")[-1] in ("wk", "wv", "bk", "bv")
    assert widened == 4 * tcfg.n_layers
    one = tplan.make_paged_serve_plan(tcfg, MeshShape((1, 2)))
    assert one.prepare_params(got, tcfg) is got          # kv_repl == 1


# ---------------------------------------------------------------------------
# which leaves shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduce", ["gather", "psum"])
@pytest.mark.parametrize("fmt", [None, "mxfp4"])
def test_param_specs_match_reference(reduce, fmt):
    """Plain and mxfp4-packed weights: every parameter (every packed
    weight's codes and scales) shards the dim the reference's spec does."""
    jcfg, tcfg, ref, params, port = _bridged("qwen3-14b", n_heads=8,
                                             n_kv_heads=4)
    jm, tm = _meshes(4, data=2)
    jp = jplan.make_paged_serve_plan(jcfg, jm, reduce=reduce)
    tp_ = tplan.make_paged_serve_plan(tcfg, tm, reduce=reduce)
    if fmt is not None:
        params, port = j_quantize(params, fmt), quantize_params(port, fmt)
    specs = jp.param_specs(params)
    locs = _layer_locations(port)
    shapes = {n: tuple(p.shape) for n, p in port.named_parameters()}
    from repro_torch.quant.linear import packed_leaves
    packed = dict(packed_leaves(port))
    shapes.update({n: tuple(w.shape) for n, w in packed.items()})
    # the dim ``local_model`` slices (and the deployment prices) a leaf by
    got = {name: tp_.param_shard_dim(name, len(shape))
           for name, shape in shapes.items()}
    sharded = 0
    for name, dim in got.items():
        spec, stacked = _ref_spec(params, name, locs, specs)
        if name in packed:      # packed children inherit the weight's spec
            assert spec.codes == spec.scales, name
            spec = spec.codes
        assert dim == _port_dim(spec, stacked, len(shapes[name])), name
        sharded += dim is not None
    # q/k/v, gate/up (and wo/down in psum mode) of each layer
    assert sharded == tcfg.n_layers * (5 + 2 * (reduce == "psum"))


@pytest.mark.parametrize("name,cache", [("qwen3-14b", None),
                                        ("qwen3-14b", "fp8"),
                                        ("deepseek-v2-lite-16b", None)])
def test_pool_specs_match_reference(name, cache):
    """The pools each rank's local model allocates (the engine's call on
    it): GQA pools shard the KV-head axis (fp8 pools' scale leaves too);
    MLA latent pools replicate.  Each leaf is the full pool's with the
    dim the reference's partition spec shards divided by 4."""
    jcfg, tcfg = _cfgs(name, **({} if "deepseek" in name
                                else dict(n_heads=8, n_kv_heads=4)))
    jm, tm = _meshes(4, data=2)
    jp = jplan.make_paged_serve_plan(jcfg, jm)
    tp_ = tplan.make_paged_serve_plan(tcfg, tm)
    jmodel, tmodel = build_model(jcfg), Model(tcfg, device="meta")
    specs = jp.pool_specs(jmodel, cache_dtype=cache)
    full = tmodel.init_paged_cache(9, 4, cache)
    locs = _layer_locations(tmodel)
    want = []
    for i, layer in enumerate(full):
        si, ki, _, stacked = locs[i]
        spec = specs[si][ki]
        assert layer.keys() == spec.keys()
        want.append({})
        for key, leaf in layer.items():
            dim = (_port_dim(spec[key], stacked, leaf.ndim)
                   if len(spec[key]) else None)
            want[-1][key] = tuple(n // 4 if d == dim else n
                                  for d, n in enumerate(leaf.shape))
    n_sharded = sum(w != tuple(f.shape) for lw, lf in zip(want, full)
                    for w, f in zip(lw.values(), lf.values()))
    assert n_sharded == (0 if "deepseek" in name
                         else tcfg.n_layers * (4 if cache else 2))
    for rank in range(4):
        local = tp_.local_model(tmodel, rank=rank)
        got = local.init_paged_cache(9, 4, cache)
        assert [{k: tuple(v.shape) for k, v in layer.items()}
                for layer in got] == want, rank


def test_validation_matches_reference():
    jm, tm = _meshes(4, data=2)
    cases = [dict(), dict(n_heads=12, n_kv_heads=3), dict(d_ff=130),
             dict(n_heads=6, n_kv_heads=2)]
    for kw in cases:
        jcfg, tcfg = _cfgs("qwen3-14b", **kw)
        try:
            want = jplan.make_paged_serve_plan(jcfg, jm)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tplan.make_paged_serve_plan(tcfg, tm)
            assert str(got.value) == str(e)
            continue
        assert tplan.make_paged_serve_plan(tcfg, tm).kv_repl == want.kv_repl
    for name in ("mamba2-370m", "hymba-1.5b"):
        jcfg, tcfg = _cfgs(name)
        with pytest.raises(NotImplementedError) as e:
            jplan.make_paged_serve_plan(jcfg, jm)
        with pytest.raises(NotImplementedError, match="SSM") as got:
            tplan.make_paged_serve_plan(tcfg, tm)
        assert str(got.value) == str(e.value)
    jcfg, tcfg = _cfgs("qwen3-14b")
    with pytest.raises(ValueError, match="axis"):
        tplan.make_paged_serve_plan(tcfg, MeshShape((8,), ("data",)))
    with pytest.raises(ValueError, match="reduce"):
        tplan.make_paged_serve_plan(tcfg, tm, reduce="ring")
    # the reference's on_cpu() rule: gather on a CPU mesh, psum on CUDA
    assert tplan.make_paged_serve_plan(tcfg, tm).reduce == "gather"
    assert tplan.make_paged_serve_plan(
        tcfg, MeshShape((2, 4), device_type="cuda")).reduce == "psum"


# ---------------------------------------------------------------------------
# the rank's local model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduce", ["gather", "psum"])
def test_local_model_holds_the_ranks_slices(reduce):
    """Each rank's local model holds its slice of every sharded leaf (of
    the kv_repl-widened wk/wv), shares the replicated ones with the full
    model, and has the local geometry."""
    _, tcfg, _, _, port = _bridged("qwen3-14b", n_heads=8, n_kv_heads=2)
    tp_ = tplan.make_paged_serve_plan(tcfg, MeshShape((1, 4)), reduce=reduce)
    full = tp_.prepare_params(dict(port.named_parameters()), tcfg)
    for rank in range(4):
        local = tp_.local_model(port, rank=rank)
        assert local.cfg == tp_.local_config(tcfg)
        assert local.device == port.device
        for name, p in local.named_parameters():
            dim = tp_.param_shard_dim(name, p.ndim)
            if dim is None:
                assert p is port.get_parameter(name), name
                continue
            n = full[name].shape[dim] // 4
            assert torch.equal(p, full[name].narrow(dim, rank * n, n)), name
            assert p.data_ptr() != full[name].data_ptr()
        # rank r's one KV head is KV group r // kv_repl's
        wk = local.layers[0].attn.wk.reshape(tcfg.d_model, 1, tcfg.hd)
        group = port.layers[0].attn.wk.reshape(tcfg.d_model, 2, tcfg.hd)
        assert torch.equal(wk[:, 0], group[:, rank // 2])
    assert tplan.make_paged_serve_plan(tcfg, MeshShape((4, 1))).local_model(
        port) is port
    with pytest.raises(ValueError, match="unquantized"):
        tp_.local_model(quantize_params(port, "mxfp4"), rank=0)


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------


def _all_plans():
    """(name, tp, reduce) for every registered config and TP degree the
    reference's plan accepts."""
    out = []
    for name in tconfigs._ARCH_MODULES:
        cfg = get_config(name)
        for tp in TP_DEGREES:
            try:
                jplan.make_paged_serve_plan(cfg, _meshes(tp)[0])
            except (ValueError, NotImplementedError):
                continue
            out.append((name, tp))
    return out


@pytest.mark.parametrize("name,tp", _all_plans())
def test_pricing_matches_reference(name, tp):
    jcfg, tcfg = get_config(name), tconfigs.get_config(name)
    jm, tm = _meshes(tp)
    jmodel, tmodel = build_model(jcfg), Model(tcfg, device="meta")
    for reduce in ("gather", "psum"):
        jp = jplan.make_paged_serve_plan(jcfg, jm, reduce=reduce)
        tp_ = tplan.make_paged_serve_plan(tcfg, tm, reduce=reduce)
        assert tp_.kv_repl == jp.kv_repl
        for slots in (1, 8):
            assert tp_.psum_bytes_per_step(tmodel, slots) == \
                jp.psum_bytes_per_step(jmodel, slots)
            assert tp_.psum_bytes_per_step(tmodel, slots, dtype_bytes=2) == \
                jp.psum_bytes_per_step(jmodel, slots, dtype_bytes=2)
    kw = dict(tp=tp, kv_repl=jp.kv_repl)
    for tc, jc in ((None, None), (torch.bfloat16, jnp.bfloat16),
                   *((("fp8", "fp8"),) if not jcfg.mla else ())):
        assert tplan.paged_kv_token_bytes(tmodel, cache_dtype=tc, **kw) == \
            jplan.paged_kv_token_bytes(jmodel, cache_dtype=jc, **kw)
        assert tplan.paged_kv_token_bytes_split(
            tmodel, cache_dtype=tc, dtype_bytes=2, **kw) == \
            jplan.paged_kv_token_bytes_split(jmodel, cache_dtype=jc,
                                             dtype_bytes=2, **kw)


def test_pricing_covers_the_configs():
    """Every config whose widths divide some TP degree is priced above;
    the stateful ones are refused by the plan (in both packages)."""
    priced = {name for name, _ in _all_plans()}
    assert {"llama3-8b", "llama3-70b", "qwen3-14b", "deepseek-v2-lite-16b",
            "h2o-danube-1.8b", "llama4-scout-109b-a17b"} <= priced
    assert not priced & {"mamba2-370m", "hymba-1.5b"}


def _fake_jax_mesh(tp: int):
    """A JAX Mesh of the one CPU device repeated: the reference's resolve
    reads only its shape."""
    dev = jax.devices()[0]
    return jax.sharding.Mesh(np.array([dev] * tp, dtype=object).reshape(
        1, tp), ("data", "model"))


@pytest.mark.parametrize("tp,kw,fmt,cache", [
    (4, dict(n_heads=8, n_kv_heads=4), None, None),
    (4, dict(n_heads=8, n_kv_heads=2), "mxfp4", "fp8"),
    (2, dict(n_heads=8, n_kv_heads=4), None, "int8"),
])
def test_deployment_on_a_mesh_matches_reference(tp, kw, fmt, cache):
    """Every numeric field of ``ResolvedDeployment`` on a TP mesh, exact
    weights, a draft: the reference's, integers exactly, floats at 1e-12
    (``describe()`` names the degree and the replication too)."""
    jcfg, tcfg, _, params, port = _bridged("qwen3-14b", **kw)
    jd, td = _cfgs("qwen3-14b", name="qwen3-draft", n_layers=1, **kw)
    for reduce in ("gather", "psum"):
        spec = dict(sku="h100", max_len=64, page_size=4, tp_reduce=reduce,
                    weight_format=fmt, cache_dtype=cache)
        want = jdep.DeploymentSpec(mesh=_fake_jax_mesh(tp), **spec).resolve(
            build_model(jcfg), params=params, draft=build_model(jd),
            draft_params=None)
        got = tdep.DeploymentSpec(mesh=MeshShape((1, tp)), **spec).resolve(
            port, params=port, draft=Model(td, device="meta"),
            draft_params=None)
        assert (got.tp, got.kv_repl) == (want.tp, want.kv_repl)
        for f in dataclasses.fields(want):
            if f.name in ("spec", "mesh", "cache_dtype", "device"):
                continue
            g, w = getattr(got, f.name), getattr(want, f.name)
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=1e-12, abs=0), f.name
            else:
                assert g == w, f.name
        assert got.pool_bytes_per_device == want.pool_bytes_per_device
        assert got.describe() == want.describe()
        assert f"tp={tp}" in got.describe()


# ---------------------------------------------------------------------------
# meshes and marks in one process
# ---------------------------------------------------------------------------


def test_parse_mesh_needs_the_ranks():
    with pytest.raises(ValueError, match="world size is 1.*torchrun"):
        parse_mesh("1x2")
    with pytest.raises(ValueError, match="DxM"):
        parse_mesh("2by2")
    # pricing a "DxM" spec needs no ranks and makes no process group: it
    # is a MeshShape of the serving device's type, which decides "auto"
    meta = Model(tconfigs.reduced_config(tconfigs.get_config("qwen3-14b")),
                 device="meta")
    cpu = tdep.DeploymentSpec(mesh="1x2").resolve(meta, params=meta,
                                                  device="cpu")
    card = tdep.DeploymentSpec().resolve(meta, params=meta, mesh=(1, 2))
    assert (cpu.tp, card.tp) == (2, 2)
    assert cpu.mesh == MeshShape((1, 2), device_type="cpu")
    assert card.mesh == MeshShape((1, 2), device_type="cuda")
    assert cpu.weight_bytes_per_device > card.weight_bytes_per_device
    assert not dist.is_initialized()
    assert MeshShape((2, 4)).size() == 8 and MeshShape((2, 4)).size(1) == 4


def test_marks_are_plain_outside_a_region():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 64, generator=g)
    w = torch.randn(64, 32, generator=g)
    assert torch.equal(hints.tp_row_dot(x, w), qdot(x, w))
    assert hints.tp_psum(x) is x
    with pytest.raises(ValueError, match="mode"):
        with hints.manual_tp_axis(None, mode="ring"):
            pass


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo world (this process), torn down after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_serves_with_tp_one(one_rank):
    """A 1x1 mesh on a one-rank gloo group: a plan of tp 1, the full model
    served through the TP region (its collectives are identities), streams
    equal to the engine without a mesh."""
    from repro_torch.runtime.llm import LLMEngine
    from repro_torch.runtime.sampling import SamplingParams
    _, tcfg, _, _, port = _bridged("qwen3-14b")
    port = port.float()
    mesh = parse_mesh("1x1", "cpu")
    kw = dict(backend="continuous", device="cpu", max_len=32, num_slots=2,
              page_size=4, num_pages=24, prefill_chunk=8)
    prompts = [np.arange(1, 10), np.arange(20, 31)]
    sps = [SamplingParams(max_tokens=6),
           SamplingParams(max_tokens=6, temperature=0.8, seed=3)]
    want = LLMEngine(port, **kw).generate(prompts, sps)
    llm = LLMEngine(port, mesh=mesh, **kw)
    assert llm.serve_plan.tp == 1 and llm.model is port
    got = llm.generate(prompts, sps)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    comm = llm._eng._tp
    assert comm.counts["all_gather"] > 0 and comm.counts["host_copies"] == 0
    # one clock broadcast a step: admission reads rank 0's clock
    assert comm.counts["broadcast"] >= llm.last_stats.steps > 0
