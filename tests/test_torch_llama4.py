"""llama4-scout-109b-a17b and llama4-maverick-400b-a17b (the ``attn_moe``
kind: GQA attention, top-1 MoE with one shared expert) in the port against
the reference, at the reduced configs: scout at 2 layers (one ``attn_moe``
segment of 2 reps), maverick at 4 (one two-kind segment, ``("attn_dense",
"attn_moe")`` x 2, stacked) and, for the bridge, at 2 (one rep, unstacked).

Weights come from the reference's ``Model.init`` through
``bridge.params_from_jax``.  Covered: the configs and segment plans (full
and reduced); the bridge round trip; chunked paged prefill + paged decode
steps, static prefill + decode steps and ``forward`` logits (f32 within
1e-5; bf16 within 4 bf16 ulps (2^-6) of the largest |logit|, as in
``test_torch_model.py``, at one plan period, and at the reduced depth as
accurate as the reference's against f32 logits on the same expert ids);
``moe_dense``'s batched products against the einsum form, bit for bit;
the capacity path forced on a skewed router, so
that assignments are dropped, as the reference's kept set; f32 greedy and
sampled streams of ``LLMEngine`` equal to the reference's for continuous
(prefix hits, a forced preemption, prompt scores), static, continuous
``speculative=`` and the legacy speculative backend; MXFP4 streams with the
experts unquantized on both sides; ``DeploymentSpec`` at 1e-12 on ``meta``
models (the full configs: the reference's refusal on one H100); and
duplicate scratch-page writes into a GQA pool of an MoE model, fp8 scale
leaves included, applied in any order, leaving the pool as the CPU's
in-order writes do.

f32 where streams must be equal: a last-bit difference in bf16 can flip a
top-1 routing choice or a near-tied argmax (ROADMAP Queue 3).
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
from repro.models.model import build_plan as jplan
from repro.quant import formats as jformats
from repro.quant.linear import quantizable_leaf as ref_quantizable
from repro.runtime import deployment as jdep
from repro.runtime.llm import LLMEngine as RefLLM
from repro.runtime.sampling import SamplingParams as RefSP
from repro.runtime.speculative import SpeculativeConfig as RefSpecConfig
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.models import attention_backends as tab
from repro_torch.models import moe as tmoe
from repro_torch.models.model import Model
from repro_torch.models.model import build_plan as tplan
from repro_torch.quant import linear
from repro_torch.runtime import deployment as tdep
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.speculative import SpeculativeConfig

SCOUT = "llama4-scout-109b-a17b"
MAVERICK = "llama4-maverick-400b-a17b"
NAMES = [SCOUT, MAVERICK]
PERIOD = {SCOUT: 1, MAVERICK: 2}          # layers of one plan period
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -6
GAMMA = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's intra-op thread pool would only spin on the
    cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name, n_layers=None):
    cfg = reduced_config(get_config(name))
    tcfg = tconfigs.reduced_config(tconfigs.get_config(name))
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    return cfg, tcfg


def _f32(params):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.float32), params)


def _segments(plan):
    return [(s.kinds, s.reps, s.window) for s in plan]


@pytest.mark.parametrize("name", NAMES)
def test_configs_and_plans_match_reference(name):
    """The full and reduced configs field for field, and their segment
    plans: scout one ``attn_moe`` segment, maverick one two-kind segment
    repeated ``n_layers // 2`` times."""
    full, tfull = get_config(name), tconfigs.get_config(name)
    assert tfull.__dict__ == full.__dict__
    red, tred = reduced_config(full), tconfigs.reduced_config(tfull)
    assert tred.__dict__ == red.__dict__
    assert (tred.n_layers, tred.n_experts, tred.n_experts_per_token) == (
        (2, 4, 1) if name == SCOUT else (4, 4, 1))
    for cfg, tcfg in ((full, tfull), (red, tred)):
        assert _segments(tplan(tcfg)) == _segments(jplan(cfg))
    kinds = ("attn_moe",) if name == SCOUT else ("attn_dense", "attn_moe")
    assert _segments(tplan(tfull)) == [(kinds, 48 // len(kinds), None)]


@pytest.mark.parametrize("name,n_layers", [(SCOUT, None), (MAVERICK, None),
                                           (MAVERICK, 2)],
                         ids=["scout", "maverick-stacked",
                              "maverick-one-rep"])
def test_bridge_round_trip_bit_identical(name, n_layers):
    """Every reference leaf lands in the port (the router, the shared
    expert and, in maverick, the dense layers' MLP of the two-kind
    segment) and comes back bit for bit."""
    cfg, tcfg = _configs(name, n_layers)
    params = jax.tree.map(np.asarray,
                          build_model(cfg).init(jax.random.PRNGKey(0)))
    model = params_from_jax(params, tcfg, device="cpu")
    assert [blk.kind for blk in model.layers] == [
        k for seg in tplan(tcfg) for _ in range(seg.reps) for k in seg.kinds]
    assert all(hasattr(blk.moe, "shared") for blk in model.layers
               if blk.is_moe)
    back = params_to_numpy(model)
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _logits_case(ref, jparams, model, cfg, jd, td, check):
    """Chunked paged prefill + 3 paged decode steps, static prefill + 2
    decode steps and ``forward``, caches of ``jd`` (reference) and ``td``
    (port); ``check(jax logits, torch logits)`` returns the reference's
    argmax, which feeds the next step."""
    rng = np.random.default_rng(2)
    b, nb, page = 3, 6, 4
    pages = 1 + b * nb
    table = rng.permutation(np.arange(1, pages)).reshape(b, nb).astype(
        np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (b, 8)).astype(np.int32)
    start = np.zeros(b, np.int32)
    valid = np.array([8, 5, 7], np.int32)
    jpools = ref.init_paged_cache(pages, page, dtype=jd)
    tpools = model.init_paged_cache(pages, page, td)
    jl, jpools = ref.prefill_chunk_paged(
        jparams, jnp.asarray(tokens), jpools, jnp.asarray(table),
        jnp.asarray(start), jnp.asarray(valid))
    tok = check(jl, model.prefill_chunk_paged(
        torch.from_numpy(tokens), tpools, torch.from_numpy(table),
        torch.from_numpy(start), torch.from_numpy(valid)))
    pos = valid.copy()
    for _ in range(3):
        jl, jpools = ref.decode_step_paged(jparams, jnp.asarray(tok), jpools,
                                           jnp.asarray(table),
                                           jnp.asarray(pos))
        tok = check(jl, model.decode_step_paged(
            torch.from_numpy(tok), tpools, torch.from_numpy(table),
            torch.from_numpy(pos)))
        pos = pos + 1
    jcache = ref.init_cache(2, 12, dtype=jd)
    tcache = model.init_cache(2, 12, td)
    prompt = tokens[:2, :6]
    jl, jcache = ref.prefill(jparams, {"tokens": jnp.asarray(prompt)}, jcache)
    tok = check(jl, model.prefill(torch.from_numpy(prompt), tcache))
    for cur in (6, 7):
        jl, jcache = ref.decode_step(jparams, jnp.asarray(tok), jcache, cur)
        tok = check(jl, model.decode_step(torch.from_numpy(tok), tcache, cur))
    check(ref.forward(jparams, {"tokens": jnp.asarray(tokens)}),
          model(torch.from_numpy(tokens)))


def _force_reference_routes(monkeypatch):
    """Every MoE routing of the port takes, in call order, the expert ids
    the reference's routing chose on the same call (recorded by a host
    callback), weighted by the port's own router softmax and renormalised
    as ``_routing`` does.  Where the port's own top-k differs, each forced
    expert's router logit must lie within ``BF16_TOL`` of the token's
    largest |router logit| of its own k-th choice's: a near tie.  Returns
    the queue of recorded routings not yet replayed."""
    import repro.models.moe as jmoe

    ref_real, real, todo = jmoe._routing, tmoe._routing, []

    def ref_routing(x2d, router, k):
        w, ids = ref_real(x2d, router, k)
        jax.debug.callback(lambda i: todo.append(np.array(i)), ids,
                           ordered=True)
        return w, ids

    def routing(x2d, router, k):
        jax.effects_barrier()
        ids = torch.from_numpy(todo.pop(0)).long()
        assert ids.shape == (x2d.shape[0], k)
        logits = x2d.float() @ router.float()
        _, own = real(x2d, router, k)
        gap = logits.gather(-1, own).amin(-1) - logits.gather(-1, ids).amin(-1)
        assert (gap <= BF16_TOL * logits.abs().amax(-1)).all()
        w = torch.softmax(logits, dim=-1).gather(-1, ids)
        return w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9), ids

    monkeypatch.setattr(jmoe, "_routing", ref_routing)
    monkeypatch.setattr(tmoe, "_routing", routing)
    return todo


@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16_one_period"])
@pytest.mark.parametrize("name", NAMES)
def test_model_logits_match_reference(name, mode, monkeypatch):
    """Paged, static and ``forward`` logits of the port's ``Model`` on the
    reference's weights.  ``f32``, at the reduced depth: within 1e-5 and
    the same argmax.  ``bf16_one_period`` (scout 1 layer, maverick
    ``attn_dense`` + ``attn_moe``): within 4 bf16 ulps (2^-6) of the
    largest |logit| and the same argmax, except where the reference's top
    two logits lie within that tolerance of each other.  ``bf16``, at the
    reduced depth: as accurate as the reference, to 4 bf16 ulps.  Two bf16
    runs part by more than 4 ulps there from rounding alone (at maverick's
    4 layers the reference's own bf16 logits lie 1.24x that bound from
    the f32 ones, and the port's 1.275x from the reference's, with no
    routing choice apart), so the port's bf16 logits are held against the
    f32 ones of the port on the reference's bf16 expert ids
    (``_force_reference_routes``): no farther from them than the
    reference's bf16 logits, plus 4 ulps.  Each next step is fed the
    reference's argmax."""
    cfg, tcfg = _configs(name, PERIOD[name] if mode == "bf16_one_period"
                         else None)
    ref = build_model(cfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(1)))
    model = params_from_jax(params, tcfg, device="cpu")
    if mode == "f32":
        jparams, model = _f32(params), model.float()
        jd, td = jnp.float32, torch.float32
    else:
        jparams = jax.tree.map(jnp.asarray, params)
        jd, td = jnp.bfloat16, torch.bfloat16
    calls = []

    def record(jl, tl):
        calls.append((np.asarray(jl.astype(jnp.float32)), tl.float().numpy()))
        return calls[-1][0].argmax(-1).astype(np.int32)

    _logits_case(ref, jparams, model, cfg, jd, td, record)
    if mode == "bf16":
        truth = []
        todo = _force_reference_routes(monkeypatch)

        def record_truth(jl, tl):
            truth.append(tl.float().numpy())
            return np.asarray(jl.astype(jnp.float32)).argmax(-1).astype(
                np.int32)

        _logits_case(ref, jparams,
                     params_from_jax(params, tcfg, device="cpu").float(),
                     cfg, jd, torch.float32, record_truth)
        jax.effects_barrier()
        assert not todo                     # every routing was replayed
        for (a, b), t in zip(calls, truth, strict=True):
            lim = np.abs(a - t).max() + BF16_TOL * np.abs(a).max()
            assert np.abs(b - t).max() <= lim, (np.abs(b - t).max(), lim)
        return
    for a, b in calls:
        tol = F32_TOL if mode == "f32" else BF16_TOL * np.abs(a).max()
        assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)
        top2 = np.sort(a, axis=-1)[..., -2:]
        near = (top2[..., 1] - top2[..., 0]) <= (0 if mode == "f32" else tol)
        np.testing.assert_array_equal(
            np.where(near, a.argmax(-1), b.argmax(-1)), a.argmax(-1))


@pytest.mark.parametrize("name", NAMES)
def test_moe_dense_matches_the_einsum_form(name):
    """``moe_dense`` batches the expert products with x broadcast over E
    (``torch.matmul``, ``bmm``); the reference's ``einsum`` form, written
    in torch, gives the same bf16 output bit for bit on the reduced
    config's weights."""
    cfg, tcfg = _configs(name)
    params = jax.tree.map(np.asarray, build_model(cfg).init(
        jax.random.PRNGKey(1)))
    model = params_from_jax(params, tcfg, device="cpu")
    p = next(b.moe for b in model.layers if b.is_moe)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 8, tcfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    x2d = x.reshape(-1, tcfg.d_model)
    w, ids = tmoe._routing(x2d, p.router, tcfg.n_experts_per_token)
    g = torch.einsum("td,edf->tef", x2d, p.w_gate)
    u = torch.einsum("td,edf->tef", x2d, p.w_up)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    y_all = torch.einsum("tef,efd->ted", h, p.w_down)
    comb = torch.einsum("tk,tke->te", w, torch.nn.functional.one_hot(
        ids, tcfg.n_experts).float())
    want = torch.einsum("te,ted->td", comb.to(x.dtype), y_all)
    got = tmoe.moe_dense(x, p, tcfg).reshape(-1, tcfg.d_model)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(torch.int16).numpy())


@pytest.mark.parametrize("name", NAMES)
def test_forced_capacity_matches_reference_kept_set(name):
    """``moe_impl="capacity"`` on both sides, f32, with every router
    skewed towards expert 0 so that its capacity overflows: the logits
    agree (the same assignments kept and dropped), and they differ from
    the dense path's (drops happened)."""
    cfg, tcfg = _configs(name)
    params = jax.tree.map(np.asarray,
                          build_model(cfg).init(jax.random.PRNGKey(3)))
    for seg in params["stacks"]:
        for kind in seg:
            if "moe" in kind:
                kind["moe"]["router"] = kind["moe"]["router"].copy()
                kind["moe"]["router"][..., 0] += 0.2
    ref = build_model(cfg, moe_impl="capacity")
    jparams = _f32(params)
    port = params_from_jax(params, tcfg, device="cpu").float()
    dense = params_from_jax(params, tcfg, device="cpu").float()
    for blk in port.layers:
        if blk.is_moe:
            blk.moe.impl = "capacity"
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 12))
    jl = np.asarray(ref.forward(jparams, {"tokens": jnp.asarray(toks)}))
    tl = port(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=F32_TOL)
    assert np.abs(dense(torch.from_numpy(toks)).numpy() - tl).max() > 1e-3


# ---------------------------------------------------------------------------
# engines: f32 streams against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=NAMES, ids=["scout", "maverick"])
def models(request):
    cfg, tcfg = _configs(request.param)
    ref = build_model(cfg)
    params = ref.init(jax.random.PRNGKey(5))
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
# MXFP4 weights (the experts, the shared expert and the router stay bf16)
# ---------------------------------------------------------------------------


def _port_name(path) -> str | None:
    keys = [getattr(e, "key", getattr(e, "idx", None)) for e in path]
    if keys[0] != "stacks":
        return None
    return ".".join(str(k) for k in keys[1:])      # seg.kind.<subtree...>


@pytest.mark.parametrize("name", NAMES)
def test_quantizable_leaves_match_reference_paths(name):
    """The leaves ``quantize_params`` packs are the reference's: the
    attention projections of every layer and the dense layers' MLP, never
    the router, the experts or the shared expert."""
    cfg, tcfg = _configs(name)
    abstract = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    want = {n for path, leaf in jax.tree_util.tree_leaves_with_path(abstract)
            if (n := _port_name(path)) is not None
            and ref_quantizable(path, leaf, "mxfp4")}
    port = Model(tcfg, device="meta")
    kinds = [k for seg in port.plan for _ in range(seg.reps)
             for k in seg.kinds]
    per = len(port.plan[0].kinds)
    got = set()
    for n, p in port.named_parameters():
        if linear.quantizable_leaf(n, p, "mxfp4"):
            _, i, rest = n.split(".", 2)
            got.add(f"0.{int(i) % per}.{rest}")
    assert got == want
    attn = {f"attn.{w}" for w in ("wq", "wk", "wv", "wo")}
    mlp = {f"mlp.{w}" for w in ("w_gate", "w_up", "w_down")}
    assert got == {f"0.{i}.{leaf}" for i, kind in enumerate(kinds[:per])
                   for leaf in (attn if kind == "attn_moe" else attn | mlp)}


@pytest.fixture(scope="module", params=NAMES, ids=["scout", "maverick"])
def mxfp4_served(request):
    """Reduced models whose quantizable projections are round-tripped
    through mxfp4 (quantizing them again is idempotent); f32 on both
    sides (the mxfp4 matmul still rounds x to bf16, on both sides)."""
    cfg, tcfg = _configs(request.param)
    params = build_model(cfg).init(jax.random.PRNGKey(6))

    def rt(path, leaf):
        if ref_quantizable(path, leaf, "mxfp4"):
            p = jformats.quantize(leaf, "mxfp4")
            return jformats.dequantize(p, "mxfp4").astype(leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(rt, params)
    port = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                           device="cpu").float()
    return cfg, build_model(cfg), _f32(params), port


def test_mxfp4_streams_match_reference(mxfp4_served, monkeypatch):
    """Greedy continuous streams equal to the reference's own mxfp4 run,
    with 2 MXFP4 calls (q/k/v grouped, wo) per MoE layer and 4 per dense
    layer at every decode step and prefill call."""
    cfg, ref, params, port = mxfp4_served
    prompts = _prompts(cfg.vocab_size, 4)
    want = RefLLM(ref, params, cache_dtype=jnp.float32,
                  weight_format="mxfp4", **ENGINE).generate(
        prompts, [RefSP(max_tokens=8)] * 4)
    calls = []
    for fn in ("mxfp4_matmul", "mxfp4_matmul_group"):
        real = getattr(linear, fn)
        monkeypatch.setattr(linear, fn, lambda x, w, *a, _r=real, **kw: (
            calls.append(x.shape[:-1]), _r(x, w, *a, **kw))[1])
    llm = LLMEngine(port, device="cpu", cache_dtype=torch.float32,
                    weight_format="mxfp4", **ENGINE)
    got = llm.generate(prompts, [SamplingParams(max_tokens=8)] * 4)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    per_call = sum(2 if blk.is_moe else 4 for blk in port.layers)
    stats = llm.last_stats
    assert len(calls) == per_call * (stats.steps + stats.prefill_calls)


# ---------------------------------------------------------------------------
# deployments
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


@pytest.mark.parametrize("fmt,cache", [(None, None), ("mxfp4", "fp8")])
@pytest.mark.parametrize("name,n_layers", [(SCOUT, 8), (MAVERICK, 2),
                                           (SCOUT, None), (MAVERICK, None)],
                         ids=["scout-8L", "maverick-1rep", "scout",
                              "maverick"])
def test_deployment_matches_reference(name, n_layers, fmt, cache):
    """On one H100, from ``meta`` models (exact weight bytes from their
    shapes; the reference: ``jax.eval_shape`` of its init) and from the
    footprint estimate.  Every numeric field at 1e-12 wherever the
    reference resolves (the depths that ``chip_smoke.py`` serves; full
    scout under MXFP4 + fp8 from the footprint estimate, which prices the
    experts at 4.25 bits too); elsewhere both raise the reference's
    ``DeploymentError`` with its message: the full configs from exact
    weights, also under MXFP4 (the experts stay bf16: 196.6 GB of
    scout's weights)."""
    cfg, tcfg = get_config(name), tconfigs.get_config(name)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    ref = build_model(cfg)
    abstract = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    port = Model(tcfg, device="meta")
    skw = dict(sku="h100", weight_format=fmt, cache_dtype=cache,
               max_len=2048)
    for jp, tp in ((None, None), (abstract, port)):
        try:
            want = jdep.DeploymentSpec(**skw).resolve(ref, params=jp)
        except jdep.DeploymentError as e:
            assert n_layers is None, e
            with pytest.raises(tdep.DeploymentError) as got:
                tdep.DeploymentSpec(**skw).resolve(port, params=tp)
            assert str(got.value) == str(e)
            continue
        # the footprint estimate prices every weight, experts too, at the
        # format's bits: full scout under MXFP4 fits there
        assert n_layers is not None or tp is None, "fits one H100"
        got = tdep.DeploymentSpec(**skw).resolve(port, params=tp)
        g, w = _numbers(got), _numbers(want)
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], float) or isinstance(g[k], float):
                assert g[k] == pytest.approx(w[k], rel=1e-12, abs=0), k
            else:
                assert g[k] == w[k], k
        assert got.describe() == want.describe()


# ---------------------------------------------------------------------------
# duplicate scratch-page writes into the GQA pools of an MoE model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, "fp8"],
                         ids=["f32", "fp8"])
def test_duplicate_scratch_writes_leave_the_pool_as_the_cpu_does(
        dtype, monkeypatch):
    """Idle and padding rows all write the scratch page.  In an MoE model
    (here reduced scout) every attention module is ``coupled`` and
    ``_scatter_kv`` gives each write the value of the last writer of its
    place, every leaf (codes and, on an fp8 pool, the ``k_scale``/
    ``v_scale`` leaves) alike, so writes applied in any order leave the
    pool as the CPU's in-order writes do; uncoupled, the same reversed
    order would leave other values there."""
    _, tcfg = _configs(SCOUT)
    model = Model(tcfg, device="meta")
    assert all(blk.attn.coupled for blk in model.layers)
    assert not any(blk.attn.coupled for blk in Model(
        dataclasses.replace(tcfg, moe=False), device="meta").layers)
    rng = np.random.default_rng(8)
    n = 12
    phys = torch.tensor([0, 3, 0, 0, 5, 0, 2, 0, 3, 0, 0, 4])
    off = torch.tensor([0, 1, 0, 2, 0, 0, 3, 2, 1, 0, 2, 1])
    shape = (n, tcfg.n_kv_heads, tcfg.hd)
    k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def pool():
        return tab.init_attn_page_pool(tcfg, 6, 4, dtype, device="cpu")

    want = pool()
    tab._scatter_kv(want, k, v, (phys, off), True)        # in order

    def put_reversed(leaf, slots, vals):
        # one write at a time, last first: an order a device may take
        for i in reversed(range(slots[0].shape[0])):
            tab.kvq.raw_view(leaf)[slots[0][i], slots[1][i]] = \
                tab.kvq.raw_view(vals[i:i + 1].to(leaf.dtype))[0]

    monkeypatch.setattr(tab, "_put", put_reversed)
    got, plain = pool(), pool()
    tab._scatter_kv(got, k, v, (phys, off), True)
    tab._scatter_kv(plain, k, v, (phys, off), False)
    assert set(got) == ({"k", "v"} if dtype == torch.float32
                        else {"k", "v", "k_scale", "v_scale"})
    for leaf in want:
        np.testing.assert_array_equal(
            tab.kvq.raw_view(got[leaf]).numpy(),
            tab.kvq.raw_view(want[leaf]).numpy(), err_msg=leaf)
    assert not torch.equal(tab.kvq.raw_view(plain["k"]),
                           tab.kvq.raw_view(want["k"]))
