"""Sharded static serving on real ranks: four CPU processes joined by a
gloo group, ``make_plan``'s serving plans run by ``ServeEngine`` on
(1, 4), (2, 2) and (4, 1) meshes.

The reference's ``tests/test_distributed.py::
test_sharded_decode_matches_single_device`` contract at reduced size, in
f32 on weights bridged from the reference's ``Model.init``: the sharded
engine's streams equal the reference's single-device ``ServeEngine``
token for token (its own mesh paths crash under this jax, ROADMAP Queue
3).

  * qwen3 (4 heads, 2 KV heads: one replicated head a rank) on the
    ``decode`` plan, full tensor parallelism over every axis with the KV
    caches split by sequence over all four ranks, on (1, 4), (2, 2) and
    (4, 1): greedy and sampled rows.  The prompt (10 tokens into
    32-entry caches, 8 entries a rank) leaves ranks 2 and 3 empty and
    rank 1 partial after the prefill;
  * the ``prefill`` plan on (2, 2) (DP over data, TP and the cache's
    sequence over model), also with FSDP on: the last-position logits
    within 1e-5 of the largest |logit| of the reference's, and each
    rank's cache its slice of the reference's cache;
  * hymba (3 layers: global, windowed, global; SSM heads split over the
    ranks) on the ``long_decode`` plan on (1, 4): streams, the 8-entry
    ring of the windowed layer split 2 a rank;
  * deepseek (MLA + MoE) on the ``decode`` plan on (2, 2), expert
    parallel (2 experts a rank): streams against the reference's
    single-device capacity path (``moe_impl="capacity"``);
  * MXFP4 weights on the ``prefill`` plan on (2, 2): streams against the
    port's single-device MXFP4 engine;
  * ``LLMEngine(backend="static", mesh=)`` and a "DxM" spec.

Every rank stores exactly the plan's shard shape of each weight and of
each cache leaf the plan shards, and the collective bytes of one prefill
and one decode step, by kind, equal ``predict_serve_bytes``.

One spawn of four ranks runs every scenario (``_rank_main``); the parent
computes the references while the ranks run.  Each process group has a
60 s timeout and the spawn is joined with one."""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs as tconfigs
from repro_torch.launch.mesh import init_world, parse_mesh
from repro_torch.models.model import Model
from repro_torch.parallel import plan as tplan
from repro_torch.parallel.plan import shard_shape
from repro_torch.parallel.serve import predict_serve_bytes
from repro_torch.runtime.engine import ServeEngine
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams

WORLD = 4
JOIN_TIMEOUT_S = 240
B, P, NEW, MAX_LEN = 4, 10, 8, 32      # rows, prompt, new tokens, cache
REL_TOL = 1e-5                          # logits: share of the largest
SAMPLING = [dict(), dict(temperature=0.9, top_k=8, seed=11),
            dict(), dict(temperature=0.7, top_p=0.9, seed=12)]
MODELS = {"qwen": ("qwen3-14b", {}),
          "hymba": ("hymba-1.5b", {"n_layers": 3}),
          "deepseek": ("deepseek-v2-lite-16b", {})}
# scenario -> (model, mesh, plan kind, make_plan's param_bytes, format)
CASES = {
    "qwen_1x4": ("qwen", "1x4", "decode", None, None),
    "qwen_2x2": ("qwen", "2x2", "decode", None, None),
    "qwen_4x1": ("qwen", "4x1", "decode", None, None),
    "qwen_prefill": ("qwen", "2x2", "prefill", None, None),
    "qwen_fsdp": ("qwen", "2x2", "prefill", 1e12, None),
    "hymba_long": ("hymba", "1x4", "long_decode", None, None),
    "deepseek_ep": ("deepseek", "2x2", "decode", None, None),
    "qwen_mxfp4": ("qwen", "2x2", "prefill", None, "mxfp4"),
}


def _sps() -> list:
    return [SamplingParams(**kw) for kw in SAMPLING]


def _model(job: dict, key: str, moe_impl: str = "auto") -> Model:
    """The port model of ``job[key]`` in f32 (built in f32 first: loading
    rounds into bf16 parameters otherwise)."""
    cfg, state = job[key]
    model = Model(cfg, device="cpu", moe_impl=moe_impl).float()
    model.load_state_dict(state)
    return model


def _step_counts(eng, tokens) -> dict:
    """The collective bytes by kind of one prefill and one decode step of
    ``eng``'s layout on ``tokens`` (the rank's rows), beside the
    prediction, and the rank's caches after them."""
    lay = eng.layout
    inputs = lay.local_rows({"tokens": torch.as_tensor(tokens)})
    rows = inputs["tokens"].shape[0]
    lay.groups.reset_counts()
    logits, cache, plen = eng._prefill(inputs)
    pre = {k: v for k, v in lay.groups.counts().items()
           if k.endswith("_bytes") and v}
    lay.groups.reset_counts()
    with eng._region():
        eng.model.decode_step(logits.argmax(-1).to(torch.int32), cache, plen)
    dec = {k: v for k, v in lay.groups.counts().items()
           if k.endswith("_bytes") and v}
    kw = dict(rows=rows, seq=plen, max_len=MAX_LEN, act_dtype=torch.float32)
    return {"prefill": pre, "decode": dec,
            "pred_prefill": predict_serve_bytes(lay, eng.model, **kw,
                                                step="prefill"),
            "pred_decode": predict_serve_bytes(lay, eng.model, **kw,
                                               step="decode"),
            "logits": logits.numpy()}


def _storage(eng) -> dict:
    """The rank's weight and cache leaf shapes beside the plan's shard
    shapes of them."""
    lay = eng.layout
    plan = lay.plan
    cfg = lay.cfg
    full = Model(cfg, device="meta")
    want_w = {n: tuple(plan.shard_shape(n, p.shape))
              for n, p in full.named_parameters()}
    got_w = {n: tuple(p.shape) for n, p in lay.params.items()}
    glob = full.init_cache(B, MAX_LEN, dtype=torch.float32)
    specs = plan.cache_shardings(glob)
    rows = B // lay.batch_comm.size
    local = lay.init_cache(full, rows, MAX_LEN, torch.float32, device="meta")
    got_c, want_c = [], []
    for g, s, c in zip(glob, specs, local):
        flat = [(g, s, c)] if "attn" not in g else [
            (g[k], s[k], c[k]) for k in ("attn", "ssm")]
        for gg, ss, cc in flat:
            for key in gg:
                if key in ("k", "v", "c_kv", "k_rope", "slot_pos"):
                    got_c.append(tuple(cc[key].shape))
                    want_c.append(shard_shape(ss[key], tuple(gg[key].shape),
                                              plan.mesh))
    return {"weights": (got_w, want_w), "cache": (got_c, want_c),
            "bytes": lay.stored_bytes(),
            "plan_bytes": sum(int(np.prod(s)) * 4 for s in want_w.values())}


def _rank_main(rank: int, world: int, rdzv: str, job_path: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    init_world("cpu", rank=rank, world_size=world, init_method=rdzv)
    job = torch.load(job_path, weights_only=False)
    toks = {k: torch.as_tensor(v) for k, v in job["tokens"].items()}
    out = {}
    for case, (key, mesh_s, kind, pbytes, fmt) in CASES.items():
        mesh = parse_mesh(mesh_s, "cpu")
        model = _model(job, key)
        plan = tplan.make_plan(model.cfg, mesh, global_batch=B,
                               shape_kind=kind, param_bytes=pbytes)
        eng = ServeEngine(model, device="cpu", max_len=MAX_LEN, plan=plan,
                          weight_format=fmt, cache_dtype=torch.float32)
        res = eng.generate({"tokens": toks[key]}, max_new_tokens=NEW,
                           sampling_params=_sps())
        rec = {"tokens": res.tokens.numpy(),
               "plan": (plan.dp, plan.tp, plan.fsdp, plan.cache_seq),
               "ep": eng.layout.ep_comm is not None,
               "split": dict(eng.layout._split)}
        rec.update(_step_counts(eng, toks[key].numpy()))
        if fmt is None:
            rec.update(_storage(eng))
        if kind == "prefill" and fmt is None:
            lay = eng.layout
            inputs = lay.local_rows({"tokens": toks[key]})
            with torch.no_grad():
                logits, cache, _ = eng._prefill(inputs)
            rec["prefill_out"] = (logits.numpy(), [
                {k: v.numpy() for k, v in c.items()} for c in cache])
            rec["coords"] = (lay.batch_comm.rank, lay.batch_comm.size,
                             lay.seq_shard(MAX_LEN).start,
                             lay.seq_shard(MAX_LEN).size)
        out[case] = rec
    # the LLMEngine front door and a "DxM" spec, on the decode plan
    llm = LLMEngine(_model(job, "qwen"), backend="static", device="cpu",
                    max_len=MAX_LEN, mesh=parse_mesh("2x2", "cpu"),
                    cache_dtype=torch.float32)
    outs = llm.generate(list(job["tokens"]["qwen"]), _sps(),
                        max_new_tokens=NEW)
    out["llm"] = [o.token_ids for o in outs]
    scored = llm.generate(list(job["tokens"]["qwen"]),
                          SamplingParams(max_tokens=2, prompt_logprobs=True))
    out["llm_scores"] = np.asarray([o.prompt_logprobs for o in scored])
    eng = ServeEngine(_model(job, "qwen"), device="cpu", max_len=MAX_LEN,
                      mesh="1x4", cache_dtype=torch.float32)
    out["spec"] = eng.generate({"tokens": toks["qwen"]}, max_new_tokens=NEW,
                               sampling_params=_sps()).tokens.numpy()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: the references, one spawn
# ---------------------------------------------------------------------------


def _bridge(arch: str, kw: dict, moe_impl: str = "auto"):
    """(reference model, f32 params, the port's (cfg, f32 state dict))."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduced_config
    from repro.models.model import Model as RefModel
    from repro_torch.bridge import params_from_jax
    jcfg = dataclasses.replace(reduced_config(get_config(arch)), **kw)
    tcfg = dataclasses.replace(
        tconfigs.reduced_config(tconfigs.get_config(arch)), **kw)
    ref = RefModel(jcfg, moe_impl=moe_impl)
    params = jax.tree.map(lambda a: np.array(a, np.float32),
                          ref.init(jax.random.PRNGKey(0)))
    port = params_from_jax(params, tcfg, device="cpu", dtype=torch.float32)
    return ref, jax.tree.map(jnp.asarray, params), (tcfg, port.state_dict())


def _reference_generate(ref, params, tokens) -> np.ndarray:
    import jax.numpy as jnp
    from repro.runtime.engine import ServeEngine as RefServeEngine
    from repro.runtime.sampling import SamplingParams as RefSP
    eng = RefServeEngine(ref, params, max_len=MAX_LEN, donate_cache=False,
                         cache_dtype=jnp.float32)
    res = eng.generate({"tokens": jnp.asarray(tokens)}, max_new_tokens=NEW,
                       sampling_params=[RefSP(**kw) for kw in SAMPLING])
    return np.asarray(res.tokens)


def _reference_prefill(ref, params, tokens):
    """The reference's last-position logits and per-layer (k, v,
    slot_pos) of one prefill into a fresh f32 cache (one scanned
    segment: leaves stacked over layers)."""
    import jax.numpy as jnp
    cache = ref.init_cache(B, MAX_LEN, dtype=jnp.float32)
    logits, cache = ref.prefill(params, {"tokens": jnp.asarray(tokens)},
                                cache)
    seg = cache[0][0]
    layers = [{k: np.asarray(seg[k][i]) for k in ("k", "v", "slot_pos")}
              for i in range(seg["k"].shape[0])]
    return np.asarray(logits), layers


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import repro.models  # noqa: F401  (import order: models before kernels)
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("static_tp")
    job, bridged = {}, {}
    for key, (arch, kw) in MODELS.items():
        impl = "capacity" if key == "deepseek" else "auto"
        bridged[key] = _bridge(arch, kw, impl)
        job[key] = bridged[key][2]
    rng = np.random.default_rng(3)
    job["tokens"] = {key: rng.integers(0, job[key][0].vocab_size, (B, P),
                                       dtype=np.int64) for key in MODELS}
    job_path = str(tmp / "job.pt")
    torch.save(job, job_path)
    ctx = mp.start_processes(
        _rank_main, args=(WORLD, f"file://{tmp}/rdzv", job_path, str(tmp)),
        nprocs=WORLD, join=False, start_method="spawn")
    ref = {}
    try:
        for key in MODELS:
            jref, jparams, _ = bridged[key]
            ref[key] = _reference_generate(jref, jparams, job["tokens"][key])
        jref, jparams, _ = bridged["qwen"]
        ref["prefill"] = _reference_prefill(jref, jparams,
                                            job["tokens"]["qwen"])
        ref["mxfp4"] = ServeEngine(
            _model(job, "qwen"), device="cpu", max_len=MAX_LEN,
            weight_format="mxfp4", cache_dtype=torch.float32).generate(
            {"tokens": job["tokens"]["qwen"]}, max_new_tokens=NEW,
            sampling_params=_sps()).tokens.numpy()
        ref["scores"] = np.asarray([o.prompt_logprobs for o in LLMEngine(
            _model(job, "qwen"), backend="static", device="cpu",
            max_len=MAX_LEN, cache_dtype=torch.float32).generate(
            list(job["tokens"]["qwen"]),
            SamplingParams(max_tokens=2, prompt_logprobs=True))])
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


@pytest.mark.parametrize("case", ["qwen_1x4", "qwen_2x2", "qwen_4x1",
                                  "qwen_prefill", "qwen_fsdp", "hymba_long",
                                  "deepseek_ep"])
def test_streams_equal_the_reference_engine(runs, case):
    """Greedy and sampled rows of every plan, on every rank, equal the
    reference's single-device ``ServeEngine``."""
    ranks, ref, _ = runs
    want = ref[CASES[case][0]]
    for r in ranks:
        np.testing.assert_array_equal(r[case]["tokens"], want)


def test_plans_are_the_reference_rules(runs):
    """qwen3's decode plan is full tensor parallelism over every axis,
    whatever the mesh's shape; the prefill plan is DP x TP; hymba's long
    decode splits the cache over every axis and its SSM heads over
    model; deepseek's decode plan is expert parallel."""
    ranks, _, _ = runs
    for r in ranks:
        for case in ("qwen_1x4", "qwen_2x2", "qwen_4x1"):
            assert r[case]["plan"] == ((), ("data", "model"), (),
                                       ("data", "model"))
        assert r["qwen_prefill"]["plan"] == (("data",), "model", (), "model")
        assert r["qwen_fsdp"]["plan"][2] == ("data",)
        assert r["hymba_long"]["plan"] == ((), "model", (),
                                           ("data", "model"))
        assert r["hymba_long"]["split"]["ssm"]
        assert r["deepseek_ep"]["ep"] and r["deepseek_ep"]["split"]["moe"]


def test_prefill_plan_logits_and_cache_slices(runs):
    """The prefill plan on (2, 2): each rank's last-position logits (its
    rows) within 1e-5 of the largest |logit| of the reference's, and its
    cache leaves its rows and sequence block of the reference's (slot_pos
    whole)."""
    ranks, ref, _ = runs
    want_logits, want_cache = ref["prefill"]
    for r in ranks:
        logits, cache = r["qwen_prefill"]["prefill_out"]
        i, n, start, size = r["qwen_prefill"]["coords"]
        b = B // n
        rows = slice(i * b, (i + 1) * b)
        w = want_logits[rows]
        assert np.abs(logits - w).max() <= REL_TOL * np.abs(w).max()
        assert size == MAX_LEN // 2
        for got, want in zip(cache, want_cache):
            for key in ("k", "v"):
                np.testing.assert_allclose(
                    got[key], want[key][rows, start:start + size], rtol=0,
                    atol=REL_TOL)
            np.testing.assert_array_equal(got["slot_pos"], want["slot_pos"])
    # ranks 0 and 1 of the model axis hold the two blocks of 16 entries
    assert {r["qwen_prefill"]["coords"][2] for r in ranks} == {0, 16}


def test_mxfp4_streams_equal_the_one_device_engine(runs):
    """MXFP4 weights on the prefill plan (every region a slice of the
    packed whole leaf): the port's single-device MXFP4 engine's
    streams."""
    ranks, ref, _ = runs
    for r in ranks:
        np.testing.assert_array_equal(r["qwen_mxfp4"]["tokens"], ref["mxfp4"])


def test_llm_engine_and_spec_mesh(runs):
    """``LLMEngine(backend="static", mesh=)`` and ``ServeEngine(mesh=
    "1x4")`` serve the decode plan: the reference's streams; the mesh
    engine's prompt scores (``Model.forward`` under the layout) within
    1e-5 of the port's one-device engine's."""
    ranks, ref, _ = runs
    for r in ranks:
        assert r["llm"] == ref["qwen"].tolist()
        np.testing.assert_array_equal(r["spec"], ref["qwen"])
        np.testing.assert_allclose(r["llm_scores"], ref["scores"], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_collective_bytes_equal_the_prediction(runs, case):
    """One prefill's and one decode step's collective bytes, by kind, on
    every rank, equal ``predict_serve_bytes``."""
    ranks, _, _ = runs
    for r in ranks:
        assert r[case]["prefill"] == r[case]["pred_prefill"]
        assert r[case]["decode"] == r[case]["pred_decode"]
        assert r[case]["decode"], "no collective counted"


@pytest.mark.parametrize("case", [c for c, v in CASES.items() if v[4] is None])
def test_every_rank_stores_the_plans_shards(runs, case):
    """Each weight the rank stores has the plan's shard shape, and each
    cache leaf the plan shards (k / v / MLA latents: batch over dp,
    sequence over cache_seq; slot_pos replicated) too; the bytes are
    the plan's."""
    ranks, _, _ = runs
    for r in ranks:
        got_w, want_w = r[case]["weights"]
        assert got_w == want_w
        got_c, want_c = r[case]["cache"]
        assert got_c == want_c and got_c
        assert r[case]["bytes"] == r[case]["plan_bytes"]


def test_static_serve_launcher_under_torchrun(tmp_path):
    """The static ``launch/serve.py`` on two gloo ranks under
    ``torch.distributed.run`` runs the decode plan over
    ``make_small_mesh()`` (2 x 1: reduced qwen3's widths divide the world,
    so full TP): it returns 0, and rank 0 alone prints the plan, the
    weight bytes a rank stores (half the model's but the replicated
    norms) and a step's collective bytes."""
    import re
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.path.join(repo, "src"),
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--max-new", "4"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=180)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert r.stdout.count("plan: dp=() tp=('data', 'model')") == 1
    stored, whole = map(int, re.search(
        r"rank stores (\d+) weight bytes \(the whole model: (\d+)\)",
        r.stdout).groups())
    assert whole / 2 < stored < 0.51 * whole    # the norms replicate
    assert r.stdout.count("backend=static batch=2 new_tokens=4") == 1
