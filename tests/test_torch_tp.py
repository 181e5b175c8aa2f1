"""Tensor-parallel paged serving on real ranks: four CPU processes joined by
a gloo group, laid out as a (1, 4) and then a (2, 2) ``DeviceMesh``.

The reference's ``tests/test_distributed.py`` scenarios at reduced size.
qwen3 reduced (8 heads, 4 KV heads), f32, gather mode: a greedy and
sampled mix with prefix hits, and a tight pool with forced preemptions,
byte-identical to the reference's single-device ``ContinuousServeEngine``
on the same bridged weights, each rank's pools holding 1/tp of the KV
heads; the same with 2 KV heads on 4 ranks (``kv_repl`` 2, one head a
rank), also against the reference; psum mode completing every request,
its prefill and first decode logits against the reference's in f32 (and
with mxfp4-packed weights, whose row shards psum dequantizes, against the
port's single-device mxfp4 model), and its bf16 reduction cast once,
after the f32 sum; then deepseek reduced (MLA + MoE), danube reduced (ring pages), MXFP4 +
fp8 pools and speculation with a separate draft, each equal to the port's
single-device engine (which the other test files hold to the reference).
The ring matmuls run on the 4-way and the 2-way model groups against
``x @ w`` at rtol = atol = 1e-4 (the reference's tolerance), and a run
whose arrivals straddle steps on ranks whose clocks disagree admits every
request on the same step everywhere.  The launcher runs under
``torch.distributed.run`` on two ranks.

One spawn of four ranks runs every scenario (``_rank_main``); the parent
computes the references and the tests read the ranks' results.  Each
process group has a 60 s timeout and the spawn is joined with one, so a
rank that diverges fails the run instead of hanging it."""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs as tconfigs
from repro_torch.launch.mesh import init_world, parse_mesh
from repro_torch.models.model import Model
from repro_torch.parallel.collective_matmul import (
    ring_allgather_matmul, ring_matmul_reducescatter, tp_linear_overlapped,
)
from repro_torch.runtime.deployment import DeploymentSpec
from repro_torch.runtime.engine import ContinuousServeEngine
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.speculative import SpeculativeConfig

WORLD = 4
JOIN_TIMEOUT_S = 240
RING_TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference scenario's engine (tests/test_distributed.py)
ENGINE = dict(num_slots=3, page_size=4, num_pages=64, max_len=21,
              prefill_chunk=5)
TIGHT_PAGES = 12
PROBE_PAGES = 1 + 3 * 5       # the probe's three rows, 5 pages each
# psum's logits against one device in f32: the sums' order differs (each
# rank's partial, then the all-reduce), so f32 rounding, far inside this
# share of the largest |logit|
PSUM_REL_TOL = 1e-5
SPEC_ENGINE = dict(num_slots=3, page_size=4, num_pages=32, max_len=24,
                   prefill_chunk=5)


def _sampling(n: int) -> list:
    return [SamplingParams() if i % 2 == 0 else
            SamplingParams(temperature=0.9, top_k=8, top_p=0.95,
                           seed=100 + i) for i in range(n)]


def _requests(prompts, sps, max_new=8, gap=0.02) -> list:
    return [Request(rid=i, prompt=np.asarray(p, np.int32),
                    max_new_tokens=max_new, sampling=sp,
                    arrival_time=gap * i)
            for i, (p, sp) in enumerate(zip(prompts, sps))]


def _model(job: dict, key: str) -> Model:
    """The port model of ``job[key]``: its config and f32 weights."""
    cfg, state = job[key]
    model = Model(cfg, device="cpu").float()
    model.load_state_dict(state)
    return model


def _results(stats) -> dict:
    return {rid: np.asarray(t).tolist() for rid, t in stats.results.items()}


def _pool_shapes(eng) -> list:
    """Every leaf shape of the rank's pools, layer by layer."""
    return [{k: tuple(v.shape) for k, v in pool.items()}
            for pool in eng._pools]


def _pool_heads(eng) -> set:
    """KV-head counts of the rank's GQA pools (k leaves)."""
    return {pool["k"].shape[2] for pool in eng._pools if "k" in pool}


def _probe_logits(eng, probe) -> list:
    """The logits ``eng``'s model gives for ``probe`` in its TP region:
    one ragged prefill chunk into fresh f32 pools, then one decode step."""
    tokens, table, start, valid, nxt = (torch.from_numpy(a) for a in probe)
    pools = eng.model.init_paged_cache(PROBE_PAGES, ENGINE["page_size"],
                                       torch.float32)
    with eng._tp_region():
        first = eng.model.prefill_chunk_paged(tokens, pools, table, start,
                                              valid)
        step = eng.model.decode_step_paged(nxt, pools, table, valid)
    return [first.float().numpy(), step.float().numpy()]


def _psum_bf16_rounding(group, seed: int) -> dict:
    """``tp_row_dot`` + ``tp_psum`` of bf16 K-shards cast to bf16 once, as
    the model's residual add casts, against the whole f32 product cast
    once: the share of elements that differ, and the largest difference in
    bf16 ulps of the element."""
    from repro_torch.parallel.hints import manual_tp_axis, tp_psum, tp_row_dot
    p, r = dist.get_world_size(group), dist.get_rank(group)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(16, 64 * p, generator=g).to(torch.bfloat16)
    w = torch.randn(64 * p, 256, generator=g).to(torch.bfloat16)
    kp = 64
    with manual_tp_axis(group, "psum"):
        got = tp_psum(tp_row_dot(x[:, r * kp:(r + 1) * kp],
                                 w[r * kp:(r + 1) * kp])).to(torch.bfloat16)
    want = (x.float() @ w.float()).to(torch.bfloat16)
    diff = (got.float() - want.float()).abs()
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs())) - 7)
    return {"differ": float((diff > 0).float().mean()),
            "ulps": float((diff / ulp).max())}


def _serve(job, key, mesh, prompts, sps, *, engine=ENGINE, **kw):
    eng = ContinuousServeEngine(_model(job, key), device="cpu", mesh=mesh,
                                **{**engine, **kw})
    st = eng.run(_requests(prompts, sps))
    return eng, st


def _ring_errors(group, seed: int) -> dict:
    """Both ring matmuls on ``group`` against the dense product."""
    p, r = dist.get_world_size(group), dist.get_rank(group)
    g = torch.Generator().manual_seed(seed)
    k, m, n = 8 * p, 16, 8 * p
    x = torch.randn(m, k, generator=g)
    w = torch.randn(k, n, generator=g)
    want = x.double() @ w.double()
    kp, nl = k // p, n // p
    ag = ring_allgather_matmul(x[:, r * kp:(r + 1) * kp],
                               w[:, r * nl:(r + 1) * nl], group)
    rs = ring_matmul_reducescatter(x[:, r * kp:(r + 1) * kp],
                                   w[r * kp:(r + 1) * kp], group)
    cols = want[:, r * nl:(r + 1) * nl]
    return {"ag": float(((ag.double() - cols).abs()
                         / (RING_TOL + RING_TOL * cols.abs())).max()),
            "rs": float(((rs.double() - cols).abs()
                         / (RING_TOL + RING_TOL * cols.abs())).max())}


def _straddle(job, mesh, rank: int) -> dict:
    """Arrivals 0.15 s apart, served by ranks whose clocks read 0.4 s
    apart (each rank's session origin shifted by its rank): without rank
    0's reading every rank would admit on a step of its own."""
    eng = ContinuousServeEngine(_model(job, "qwen"), device="cpu", mesh=mesh,
                                **ENGINE)
    eng.reset()
    eng._t0 -= 0.4 * rank
    prompts, sps = job["prompts"][:4], job["sps"][:4]
    for req in _requests(prompts, sps, gap=0.15):
        eng.add_request(req)
    admitted_at = {}
    steps = 0
    while eng.has_unfinished():
        eng.step()
        steps += 1
        for req in eng._requests:
            if req.admit_time is not None and req.rid not in admitted_at:
                admitted_at[req.rid] = steps
        time.sleep(0.002)
    st = eng.stats()
    return {"results": _results(st), "admitted_at": admitted_at,
            "admit_times": {r.rid: r.admit_time for r in eng._requests},
            "steps": steps}


def _rank_main(rank: int, world: int, rdzv: str, job_path: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    init_world("cpu", rank=rank, world_size=world, init_method=rdzv)
    job = torch.load(job_path, weights_only=False)
    prompts, sps = job["prompts"], job["sps"]
    out = {}
    mesh = parse_mesh("1x4", "cpu")
    group = mesh.get_group("model")
    # -- qwen3 reduced, gather: roomy (prefix hits) and tight (preemptions)
    eng, st = _serve(job, "qwen", mesh, prompts, sps)
    out["qwen"] = {"results": _results(st), "hits": st.prefix_hit_tokens,
                   "heads": _pool_heads(eng), "pools": _pool_shapes(eng),
                   "kv_bytes": eng.kv_token_bytes_per_device(),
                   "reduce": eng.serve_plan.reduce,
                   "counts": dict(eng._tp.counts)}
    _, st = _serve(job, "qwen", mesh, prompts, sps, num_pages=TIGHT_PAGES)
    out["qwen_tight"] = {"results": _results(st), "preempt": st.preemptions}
    # -- 2 KV heads on 4 ranks: one replicated head a rank
    eng, st = _serve(job, "qwen_kv2", mesh, prompts, sps)
    out["qwen_kv2"] = {"results": _results(st), "heads": _pool_heads(eng),
                       "pools": _pool_shapes(eng),
                       "kv_repl": eng.serve_plan.kv_repl,
                       "kv_bytes": eng.kv_token_bytes_per_device()}
    # -- a spec's "DxM" mesh: the engine builds it on its own device type
    eng = ContinuousServeEngine(
        _model(job, "qwen"), device="cpu", num_slots=3, num_pages=64,
        prefill_chunk=5, spec=DeploymentSpec(sku="h100", mesh="1x4",
                                             max_len=21, page_size=4))
    out["spec_mesh"] = {"type": eng.serve_plan.mesh.device_type,
                        "reduce": eng.serve_plan.reduce,
                        "tp": (eng.serve_plan.tp, eng.deployment.tp),
                        "same": eng.deployment.mesh is eng.serve_plan.mesh}
    # -- psum mode: row-sharded closing weights, one f32 all-reduce a block
    eng, st = _serve(job, "qwen", mesh, prompts, sps, tp_reduce="psum")
    out["qwen_psum"] = {
        "results": _results(st),
        "reasons": [o.finish_reason for o in st.outputs.values()],
        "counts": dict(eng._tp.counts),
        "logits": _probe_logits(eng, job["probe"])}
    eng, st = _serve(job, "qwen", mesh, prompts, sps, tp_reduce="psum",
                     weight_format="mxfp4")
    out["psum_mxfp4"] = {
        "reasons": [o.finish_reason for o in st.outputs.values()],
        "logits": _probe_logits(eng, job["probe"])}
    out["psum_bf16"] = _psum_bf16_rounding(group, seed=13)
    # -- MLA + MoE, ring pages, MXFP4 + fp8, a separate draft
    eng, st = _serve(job, "deepseek", mesh, prompts, sps)
    out["deepseek"] = {"results": _results(st), "pools": _pool_shapes(eng)}
    _, st = _serve(job, "danube", mesh, job["long_prompts"], sps,
                   engine=dict(ENGINE, max_len=40))
    out["danube"] = {"results": _results(st)}
    eng, st = _serve(job, "qwen", mesh, prompts, sps, weight_format="mxfp4",
                     cache_dtype="fp8")
    out["mxfp4_fp8"] = {"results": _results(st), "heads": _pool_heads(eng),
                        "pools": _pool_shapes(eng)}
    spec = SpeculativeConfig(draft_model=_model(job, "draft"), gamma=3)
    eng, st = _serve(job, "qwen", mesh, prompts[:3], job["spec_sps"],
                     engine=SPEC_ENGINE, speculative=spec)
    out["spec"] = {"results": _results(st), "windows": st.spec_windows,
                   "draft_heads": {p["k"].shape[2]
                                   for p in eng._draft_pools},
                   "draft_tp": eng._draft_plan.tp}
    # -- ranks whose clocks disagree
    out["straddle"] = _straddle(job, mesh, rank)
    # -- the ring matmuls on the 4-way group
    out["ring4"] = _ring_errors(group, seed=11)
    x = torch.randn(8, 64, generator=torch.Generator().manual_seed(5))
    w = torch.randn(64, 32, generator=torch.Generator().manual_seed(6))
    lin = tp_linear_overlapped(x[:, rank * 16:(rank + 1) * 16],
                               w[:, rank * 8:(rank + 1) * 8], mesh)
    out["linear_ag"] = float((lin - (x @ w)[:, rank * 8:(rank + 1) * 8])
                             .abs().max())
    # -- a (2, 2) mesh: 2-way model groups, replicated over data
    mesh22 = parse_mesh("2x2", "cpu")
    _, st = _serve(job, "qwen", mesh22, prompts, sps)
    out["qwen22"] = {"results": _results(st)}
    _, st = _serve(job, "qwen", mesh22, prompts, sps, num_pages=TIGHT_PAGES)
    out["qwen22_tight"] = {"results": _results(st),
                           "preempt": st.preemptions}
    out["ring2"] = _ring_errors(mesh22.get_group("model"), seed=12)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: inputs, references, one spawn
# ---------------------------------------------------------------------------


def _bridge(arch: str, seed: int = 0, **kw):
    """(reference model, its f32 params, the port's (cfg, f32 state dict))
    of a reduced config from the reference's init."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduced_config
    from repro.models.model import build_model
    from repro_torch.bridge import params_from_jax
    jcfg = dataclasses.replace(reduced_config(get_config(arch)), **kw)
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config(arch)), **kw)
    ref = build_model(jcfg)
    params = ref.init(jax.random.PRNGKey(seed))
    port = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                           device="cpu").float()
    return ref, jax.tree.map(lambda a: a.astype(jnp.float32), params), (
        tcfg, port.state_dict())


def _reference_run(ref, params, prompts, sps, num_pages) -> dict:
    from repro.runtime.engine import ContinuousServeEngine as RefEngine
    from repro.runtime.sampling import SamplingParams as RefSP
    from repro.runtime.scheduler import Request as RefRequest
    eng = RefEngine(ref, params, **{**ENGINE, "num_pages": num_pages})
    reqs = [RefRequest(rid=i, prompt=np.asarray(p, np.int32),
                       max_new_tokens=8, arrival_time=0.02 * i,
                       sampling=RefSP(**{f.name: getattr(sp, f.name)
                                         for f in dataclasses.fields(sp)}))
            for i, (p, sp) in enumerate(zip(prompts, sps))]
    return {rid: np.asarray(t).tolist()
            for rid, t in eng.run(reqs).results.items()}


def _reference_probe(ref, params, probe) -> list:
    """The reference model's logits for ``probe`` (``_probe_logits``'s
    calls) over f32 pools."""
    import jax.numpy as jnp
    tokens, table, start, valid, nxt = (jnp.asarray(a) for a in probe)
    pools = ref.init_paged_cache(PROBE_PAGES, ENGINE["page_size"],
                                 dtype=jnp.float32)
    first, pools = ref.prefill_chunk_paged(params, tokens, pools, table,
                                           start, valid)
    step, _ = ref.decode_step_paged(params, nxt, pools, table, valid)
    return [np.asarray(first, np.float32), np.asarray(step, np.float32)]


def _reference_pool_dims(arch: str, kw: dict, cache, cfg) -> list:
    """Per layer of the port model of ``cfg``: pool leaf -> the dim the
    reference's 4-way plan shards (its ``PagedServePlan.pool_specs`` on an
    abstract mesh; a stacked segment's leading reps dim dropped), or
    None."""
    from repro.configs import get_config, reduced_config
    from repro.models.model import build_model
    from repro.parallel import plan as jplan
    from repro.parallel.compat import make_abstract_mesh
    from repro_torch.bridge import _layer_locations
    jcfg = dataclasses.replace(reduced_config(get_config(arch)), **kw)
    jp = jplan.make_paged_serve_plan(
        jcfg, make_abstract_mesh((1, WORLD), ("data", "model")))
    specs = jp.pool_specs(build_model(jcfg), cache_dtype=cache)
    out = []
    for si, ki, _, stacked in _layer_locations(Model(cfg, device="meta")):
        out.append({k: next((i - stacked for i, e in enumerate(v)
                             if e == "model"), None)
                    for k, v in specs[si][ki].items()})
    return out


def _port_run(job, key, prompts, sps, *, engine=ENGINE, **kw) -> dict:
    eng = ContinuousServeEngine(_model(job, key), device="cpu",
                                **{**engine, **kw})
    return _results(eng.run(_requests(prompts, sps)))


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    import repro.models  # noqa: F401  (import order: models before kernels)
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("tp")
    job, ref = {}, {}
    qref, qparams, job["qwen"] = _bridge("qwen3-14b", n_heads=8,
                                         n_kv_heads=4)
    kref, kparams, job["qwen_kv2"] = _bridge("qwen3-14b", n_heads=8,
                                             n_kv_heads=2)
    _, _, job["deepseek"] = _bridge("deepseek-v2-lite-16b")
    _, _, job["danube"] = _bridge("h2o-danube-1.8b")
    _, _, job["draft"] = _bridge("qwen3-14b", seed=3, n_heads=8,
                                 n_kv_heads=4, n_layers=1,
                                 name="qwen3-14b-draft")
    rng = np.random.default_rng(1)
    vocab = job["qwen"][0].vocab_size
    base = rng.integers(0, vocab, (2, 12))
    job["prompts"] = [base[i] for i in (0, 1, 0, 1, 0, 0)]  # prefix hits
    job["long_prompts"] = [rng.integers(0, vocab, n)
                           for n in (30, 12, 25, 9, 31, 17)]  # past window 8
    job["sps"] = _sampling(6)
    page = ENGINE["page_size"]
    job["probe"] = (rng.integers(0, vocab, (3, 8)).astype(np.int32),
                    rng.permutation(np.arange(1, PROBE_PAGES)).reshape(
                        3, -1).astype(np.int32),
                    np.zeros(3, np.int32), np.array([8, 5, 7], np.int32),
                    rng.integers(0, vocab, 3).astype(np.int32))
    assert job["probe"][1].shape[1] * page >= 9
    job["spec_sps"] = [SamplingParams(),
                       SamplingParams(temperature=0.9, top_k=8, seed=7),
                       SamplingParams()]
    job_path = str(tmp / "job.pt")
    torch.save(job, job_path)
    # spawn first: the references run while the ranks serve
    ctx = mp.start_processes(
        _rank_main, args=(WORLD, f"file://{tmp}/rdzv", job_path, str(tmp)),
        nprocs=WORLD, join=False, start_method="spawn")
    try:
        prompts, sps = job["prompts"], job["sps"]
        ref["qwen"] = _reference_run(qref, qparams, prompts, sps, 64)
        ref["qwen_tight"] = _reference_run(qref, qparams, prompts, sps,
                                           TIGHT_PAGES)
        ref["qwen_kv2"] = _reference_run(kref, kparams, prompts, sps, 64)
        ref["deepseek"] = _port_run(job, "deepseek", prompts, sps)
        ref["danube"] = _port_run(job, "danube", job["long_prompts"], sps,
                                  engine=dict(ENGINE, max_len=40))
        ref["mxfp4_fp8"] = _port_run(job, "qwen", prompts, sps,
                                     weight_format="mxfp4",
                                     cache_dtype="fp8")
        spec = SpeculativeConfig(draft_model=_model(job, "draft"), gamma=3)
        ref["spec"] = _port_run(job, "qwen", prompts[:3], job["spec_sps"],
                                engine=SPEC_ENGINE, speculative=spec)
        ref["spec_plain"] = _port_run(job, "qwen", prompts[:3],
                                      job["spec_sps"], engine=SPEC_ENGINE)
        ref["qwen_psum"] = _reference_probe(qref, qparams, job["probe"])
        ref["psum_mxfp4"] = _probe_logits(
            ContinuousServeEngine(_model(job, "qwen"), device="cpu",
                                  weight_format="mxfp4", **ENGINE),
            job["probe"])
        ref["pool_dims"] = {
            "qwen": _reference_pool_dims("qwen3-14b", dict(
                n_heads=8, n_kv_heads=4), None, job["qwen"][0]),
            "qwen_kv2": _reference_pool_dims("qwen3-14b", dict(
                n_heads=8, n_kv_heads=2), None, job["qwen_kv2"][0]),
            "mxfp4_fp8": _reference_pool_dims("qwen3-14b", dict(
                n_heads=8, n_kv_heads=4), "fp8", job["qwen"][0]),
            "deepseek": _reference_pool_dims("deepseek-v2-lite-16b", {},
                                             None, job["deepseek"][0])}
        ref["pool_shapes"] = {
            key: [{k: tuple(v.shape) for k, v in pool.items()}
                  for pool in Model(cfg, device="meta").init_paged_cache(
                      ENGINE["num_pages"], page,
                      "fp8" if key == "mxfp4_fp8" else None)]
            for key, cfg in (("qwen", job["qwen"][0]),
                             ("qwen_kv2", dataclasses.replace(
                                 job["qwen_kv2"][0], n_kv_heads=WORLD)),
                             ("mxfp4_fp8", job["qwen"][0]),
                             ("deepseek", job["deepseek"][0]))}
        ref["tp1_kv_bytes"] = {
            key: ContinuousServeEngine(_model(job, key), device="cpu",
                                       **ENGINE).kv_token_bytes_per_device()
            for key in ("qwen", "qwen_kv2")}
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"ranks still running after "
                                   f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, ref, job


def _same_on_every_rank(ranks, key, field="results"):
    first = ranks[0][key][field]
    for r in ranks[1:]:
        assert r[key][field] == first, key
    return first


@pytest.mark.parametrize("key", ["qwen", "qwen_tight", "qwen_kv2",
                                 "qwen22", "qwen22_tight"])
def test_gather_streams_equal_the_reference_engine(tp_runs, key):
    """Gather mode on a (1, 4) and a (2, 2) mesh, greedy and sampled,
    through prefix hits, forced preemptions and KV-head replication:
    byte-identical to the reference's single-device engine."""
    ranks, ref, _ = tp_runs
    want = ref[key.replace("22", "")]
    assert _same_on_every_rank(ranks, key) == want


def test_pressure_and_sharing_were_exercised(tp_runs):
    ranks, _, _ = tp_runs
    for r in ranks:
        assert r["qwen"]["hits"] > 0, "no prefix sharing exercised"
        assert r["qwen_tight"]["preempt"] > 0, "no preemption pressure"
        assert r["qwen22_tight"]["preempt"] > 0
        assert r["qwen"]["reduce"] == "gather"     # auto on a CPU mesh


def test_pools_hold_their_share_of_kv_heads(tp_runs):
    """4 KV heads on 4 ranks: one a rank, bytes/token 1/4 of tp 1's; 2 KV
    heads on 4 ranks: one replicated head a rank, full // n_kv_heads.
    Every leaf of every rank's pools (fp8 scale leaves, MLA latents) is
    the full pool's leaf (at ``pool_config``'s widened heads) with the
    dim the reference's partition spec shards divided by 4."""
    ranks, ref, job = tp_runs
    for key, dims in ref["pool_dims"].items():
        full = ref["pool_shapes"][key]
        want = [{k: tuple(n // WORLD if i == layer_dims[k] else n
                          for i, n in enumerate(shape))
                 for k, shape in layer.items()}
                for layer, layer_dims in zip(full, dims)]
        assert [d.keys() for d in dims] == [f.keys() for f in full], key
        for r in ranks:
            assert r[key]["pools"] == want, key
    assert any(d is not None for layer in ref["pool_dims"]["mxfp4_fp8"]
               for k, d in layer.items() if k.endswith("scale"))
    for r in ranks:
        assert r["qwen"]["heads"] == {1} and r["mxfp4_fp8"]["heads"] == {1}
        assert r["qwen"]["kv_bytes"] * 4 == ref["tp1_kv_bytes"]["qwen"]
        assert r["qwen_kv2"]["heads"] == {1}
        assert r["qwen_kv2"]["kv_repl"] == 2
        assert r["qwen_kv2"]["kv_bytes"] == \
            ref["tp1_kv_bytes"]["qwen_kv2"] // job["qwen_kv2"][0].n_kv_heads


def test_spec_mesh_is_built_by_the_engine(tp_runs):
    """``DeploymentSpec(mesh="1x4")`` on a CPU engine: the engine builds
    the ``DeviceMesh`` over its ranks with its own device type ("auto" is
    then "gather"), and the deployment is priced on that same mesh."""
    ranks, _, _ = tp_runs
    for r in ranks:
        assert r["spec_mesh"] == {"type": "cpu", "reduce": "gather",
                                  "tp": (4, 4), "same": True}


def test_psum_mode_completes_every_request(tp_runs):
    """Row-sharded closing weights and one f32 all-reduce a block: streams
    equal single-device only up to f32 reassociation, so the run itself
    is held: every request reaches its budget, the same on every rank,
    through all-reduces and no all-gather."""
    ranks, _, _ = tp_runs
    res = _same_on_every_rank(ranks, "qwen_psum")
    assert all(len(t) == 8 for t in res.values())
    for r in ranks:
        assert set(r["qwen_psum"]["reasons"]) == {"length"}
        c = r["qwen_psum"]["counts"]
        assert c["all_reduce"] > 0 and "all_gather" not in c
        assert "all_reduce" not in r["qwen"]["counts"]
        assert "host_copies" not in c       # CPU tensors: no staging


@pytest.mark.parametrize("key", ["qwen_psum", "psum_mxfp4"])
def test_psum_logits_match_one_device(tp_runs, key):
    """psum mode's prefill-chunk logits (three ragged rows) and first
    decode step's, on every rank, within ``PSUM_REL_TOL`` of the largest
    |logit| of one device's: the reference's model in f32, and for
    mxfp4-packed weights (psum dequantizes its row shards) the port's
    single-device mxfp4 engine model.  A reduction applied twice, a
    partial scaled, or the packed row shards taken unquantized are far
    outside it; every psum request still reaches its budget."""
    ranks, ref, _ = tp_runs
    for r in ranks:
        for got, want in zip(r[key]["logits"], ref[key]):
            assert got.shape == want.shape
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= PSUM_REL_TOL, (key, err)
        assert set(r[key]["reasons"]) == {"length"}
    for r in ranks[1:]:
        for a, b in zip(r[key]["logits"], ranks[0][key]["logits"]):
            np.testing.assert_array_equal(a, b)


def test_psum_casts_once_after_the_f32_sum(tp_runs):
    """bf16 K-shards through ``tp_row_dot`` and ``tp_psum``, cast to bf16
    as the residual add casts: the whole f32 product cast once, up to
    the f32 sums' order tipping a rounding (at most 1% of the elements,
    each by one bf16 ulp).  Partials rounded to bf16 before the sum move
    far more elements."""
    ranks, _, _ = tp_runs
    for r in ranks:
        assert r["psum_bf16"]["differ"] <= 0.01, r["psum_bf16"]
        assert r["psum_bf16"]["ulps"] <= 1.0, r["psum_bf16"]


@pytest.mark.parametrize("key", ["deepseek", "danube", "mxfp4_fp8", "spec"])
def test_sharded_streams_equal_the_single_device_port(tp_runs, key):
    """MLA + MoE (latent pools and experts replicated, heads 4 -> 1),
    sliding-window ring pages, MXFP4 weights over fp8 pools, and
    speculation with a separate 1-layer draft on its own plan."""
    ranks, ref, _ = tp_runs
    assert _same_on_every_rank(ranks, key) == ref[key]
    if key == "spec":
        for r in ranks:
            assert r["spec"]["windows"] > 0
            assert r["spec"]["draft_heads"] == {1}
            assert r["spec"]["draft_tp"] == 4
        # greedy speculation is the plain engine's stream
        got = ranks[0]["spec"]["results"]
        for i in (0, 2):
            assert got[i] == ref["spec_plain"][i]


def test_straddling_arrivals_admit_on_one_step(tp_runs):
    """Clocks 0.4 s apart across ranks, arrivals 0.15 s apart: every rank
    admits each request on the same step, at rank 0's reading, and ends
    with the same streams and step count."""
    ranks, _, _ = tp_runs
    first = ranks[0]["straddle"]
    assert len(set(first["admitted_at"].values())) > 1, \
        "the arrivals did not straddle steps"
    for r in ranks[1:]:
        for field in ("results", "admitted_at", "admit_times", "steps"):
            assert r["straddle"][field] == first[field], field


@pytest.mark.parametrize("key", ["ring4", "ring2"])
def test_ring_matmuls_match_dense(tp_runs, key):
    """``ring_allgather_matmul`` and ``ring_matmul_reducescatter`` on the
    4-way and the 2-way model group equal ``x @ w`` within rtol = atol =
    1e-4 (each error below is |got - want| / (atol + rtol |want|))."""
    ranks, _, _ = tp_runs
    for r in ranks:
        assert r[key]["ag"] <= 1.0 and r[key]["rs"] <= 1.0, r[key]
    for r in ranks:
        assert r["linear_ag"] <= 1e-4


def test_serve_launcher_under_torchrun(tmp_path):
    """``launch/serve.py --mesh 1x2 --device cpu`` on two gloo ranks under
    ``torch.distributed.run`` returns 0; rank 0 alone prints the summary,
    with the mesh line."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--device", "cpu", "--continuous", "--mesh", "1x2",
         "--num-requests", "4", "--batch", "2", "--prompt-len", "8",
         "--max-new", "6"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=180)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert r.stdout.count("mesh: data=1 x model=2 (reduce=gather") == 1
    assert r.stdout.count("finish reasons: {'length': 4}") == 1
