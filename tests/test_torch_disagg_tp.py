"""Disaggregated serving across meshes on real ranks: four CPU processes
joined by a gloo group, the prefill and decode phase engines on disjoint
slices of a (1, 4) or a (2, 2) ``DeviceMesh`` (``split_mesh``), each with
its own TP degree.

The reference's ``tests/test_disagg.py`` request mix (ragged prompts, even
rids sharing a 12-token prefix) on reduced llama3-8b (4 heads, 2 KV
heads), the reference's weights in f32 on both sides (gather mode, f32
pools; fp8 codes with f32 scales for the fp8 case), held token for token
against the reference's single-device ``DisaggServeEngine`` and its
colocated ``ContinuousServeEngine``:

  * (1, 4) split 1:2, greedy and sampled: prefill tp 1 on rank 0, decode
    tp 2 on ranks 1-2, rank 3 in neither slice (it returns without
    serving); the handoff bytes the decode ranks receive add up to the
    reference's ``handoff_bytes``, each receiving the half of every page
    its KV head holds;
  * (1, 4) split 2:2 over fp8 pools (the scale leaves split by head too),
    through ``LLMEngine(disaggregate=True, prefill_mesh=, decode_mesh=)``,
    and split 1:2 over fp8 pools (each scale leaf regrouped);
  * (2, 2) split 1:1 on ``model``, the ``data`` dim whole in each slice;
  * decode-side preemption (the reference's seed 9, 24 new tokens, 16
    pages, max_len 56): a victim re-prefills on the prefill group and is
    handed off again;
  * self-draft speculation (gamma 3): the draft pools travel with the
    chain;
  * reduced deepseek-v2-lite (MLA): the latent leaves replicate, so each
    decode rank receives them whole;
  * one mesh for both phases (``LLMEngine(mesh=, disaggregate=True)``).

Also ``split_mesh`` against the reference's on the same ``arange``
layouts (its ``_FakeMesh`` stand-in): slices, order and errors, on
``MeshShape``s and on ``DeviceMesh``es of the four ranks; each half priced
by ``DeploymentSpec.resolve(phase=, mesh=)`` as the reference prices it;
the refusals in the reference's words (a ``kv_repl`` mismatch between the
slices, a stateful model); and the launcher under
``torch.distributed.run`` with ``--mesh 1x2 --disaggregate 1:1``.

One spawn of four ranks runs every scenario (``_rank_main``); the parent
computes the references meanwhile.  Each process group has a 60 s timeout
and the spawn is joined with one, so a rank that diverges fails the run
instead of hanging it."""
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
from repro_torch.launch.mesh import MeshShape, init_world, parse_mesh
from repro_torch.models.model import Model
from repro_torch.parallel.plan import split_mesh
from repro_torch.runtime.deployment import DeploymentSpec
from repro_torch.runtime.engine import DisaggServeEngine
from repro_torch.runtime.llm import LLMEngine
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.speculative import SpeculativeConfig

WORLD = 4
JOIN_TIMEOUT_S = 240
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-12

# tests/test_disagg.py's engine; "kw" the case's changes, "seed" / "new"
# its requests, "sampled" whether odd rids sample
BASE = dict(num_slots=4, page_size=4, num_pages=48, max_len=64,
            prefill_chunk=8, enable_prefix_cache=True)
CASES = {
    "tp12": dict(mesh="1x4", split=(1, 2), seed=3, new=8, sampled=True,
                 kw={}),
    "tp22_fp8": dict(mesh="1x4", split=(2, 2), seed=3, new=8, sampled=False,
                     kw=dict(cache_dtype="fp8")),
    # regrouped fp8: the decode ranks' scale leaves hold half the prefill
    # rank's heads
    "tp12_fp8": dict(mesh="1x4", split=(1, 2), seed=3, new=8, sampled=False,
                     kw=dict(cache_dtype="fp8")),
    "dp2_11": dict(mesh="2x2", split=(1, 1), seed=3, new=8, sampled=True,
                   kw={}),
    "preemption": dict(mesh="1x4", split=(1, 2), seed=9, new=24,
                       sampled=False, kw=dict(num_pages=16, max_len=56)),
    "speculative": dict(mesh="1x4", split=(1, 2), seed=3, new=8,
                        sampled=False, kw=dict(speculative=3)),
    "mla": dict(mesh="1x4", split=(1, 2), seed=5, new=8, sampled=False,
                kw={}, model="deepseek"),
    "same_mesh": dict(mesh="2x2", split=None, seed=3, new=8, sampled=True,
                      kw={}),
}
# split_mesh's layouts: (shape, n_first, n_second, axis)
SPLITS = (((1, 4), 1, None, "model"), ((1, 4), 1, 2, "model"),
          ((1, 4), 2, 2, "model"), ((2, 2), 1, None, "model"),
          ((2, 2), 1, None, "data"))
BAD_SPLITS = (((1, 4), 2, None, "pipeline"), ((1, 4), 4, None, "model"),
              ((1, 4), 3, 2, "model"), ((2, 2), 0, None, "model"))
DEPLOY = dict(sku="h100", max_len=64, page_size=4)


def _requests(vocab, n, seed, *, max_new=8, sampled=False, port=True):
    """``tests/test_disagg.py``'s ragged mix (even rids share a 12-token
    prefix); with ``sampled`` the odd rids sample, each with its seed."""
    if port:
        req, sp = Request, SamplingParams
    else:
        from repro.runtime.sampling import SamplingParams as sp
        from repro.runtime.scheduler import Request as req
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 12).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(6, 20))).astype(
            np.int32)
        prompt = np.concatenate([shared, tail]) if i % 2 == 0 else tail
        extra = (dict(temperature=0.9, top_k=8, top_p=0.95, seed=100 + i)
                 if sampled and i % 2 else {})
        out.append(req(rid=i, prompt=prompt, max_new_tokens=max_new,
                       sampling=sp(max_tokens=max_new, **extra)))
    return out


def _engine_kw(kw: dict, port: bool = True) -> dict:
    kw = {**BASE, **kw}
    gamma = kw.pop("speculative", None)
    if gamma is not None:
        if port:
            kw["speculative"] = SpeculativeConfig(gamma=gamma)
        else:
            from repro.runtime.speculative import SpeculativeConfig as RefSC
            kw["speculative"] = RefSC(gamma=gamma)
    cache = kw.pop("cache_dtype", None)
    if cache is None and port:
        cache = torch.float32
    elif cache is None:
        import jax.numpy as jnp
        cache = jnp.float32
    kw["cache_dtype"] = cache
    return kw


def _model(job: dict, key: str) -> Model:
    """The port model of ``job[key]``: its config and f32 weights."""
    cfg, state = job[key]
    model = Model(cfg, device="cpu").float()
    model.load_state_dict(state)
    return model


def _stats(st) -> dict:
    return {"results": {rid: np.asarray(t).tolist()
                        for rid, t in st.results.items()},
            **{k: getattr(st, k) for k in (
                "handoffs", "handoff_pages", "handoff_bytes",
                "handoff_shared_tokens", "preemptions", "steps",
                "spec_windows", "chunks")},
            "ttft": {rid: r["ttft"] for rid, r in st.per_request.items()},
            "finish": {rid: r["finish_time"]
                       for rid, r in st.per_request.items()}}


def _pool_heads(pools) -> dict:
    """KV-head counts of a rank's pools: GQA code and scale leaves, and
    the width of MLA's latent leaf."""
    out = {}
    for pool in pools or ():
        for k, v in pool.items():
            out.setdefault(k, set()).add(
                v.shape[-1] if k in ("c_kv", "k_rope") else v.shape[2])
    return {k: sorted(v) for k, v in out.items()}


def _numbers(dep) -> dict:
    return {f.name: getattr(dep, f.name) for f in dataclasses.fields(dep)
            if isinstance(getattr(dep, f.name), (int, float))
            and not isinstance(getattr(dep, f.name), bool)}


def _serve_case(job, name: str, rank: int) -> dict:
    case = CASES[name]
    key = case.get("model", "llama")
    mesh = parse_mesh(case["mesh"], "cpu")
    vocab = job[key][0].vocab_size
    reqs = _requests(vocab, 8, case["seed"], max_new=case["new"],
                     sampled=case["sampled"])
    kw = _engine_kw(case["kw"])
    if case["split"] is None:
        llm = LLMEngine(_model(job, key), backend="continuous", device="cpu",
                        mesh=mesh, disaggregate=True, **kw)
        eng = llm._eng
        st = eng.run(reqs)
    else:
        pm, dm = split_mesh(mesh, *case["split"])
        if name == "tp22_fp8":
            llm = LLMEngine(_model(job, key), backend="continuous",
                            device="cpu", disaggregate=True, prefill_mesh=pm,
                            decode_mesh=dm, **kw)
            eng = llm._eng
            llm.generate([r.prompt for r in reqs],
                         [r.sampling for r in reqs])
            st = llm.last_stats
        else:
            eng = DisaggServeEngine(_model(job, key), device="cpu",
                                    prefill_mesh=pm, decode_mesh=dm, **kw)
            st = eng.run(reqs)
    out = {"serving": eng.serving,
           "members": (eng.prefill.member, eng.decode.member),
           "tp": (eng.prefill.serve_plan.tp, eng.decode.serve_plan.tp),
           "pools": (eng.prefill._pools is not None,
                     eng.decode._pools is not None),
           "heads": _pool_heads(eng.decode._pools),
           "prefill_heads": _pool_heads(eng.prefill._pools),
           "own_bytes": eng.handoff.bytes_moved,
           "stats": None if st is None else _stats(st)}
    return out


def _split_layouts() -> dict:
    """The port's ``split_mesh`` on ``DeviceMesh``es of the four ranks
    (every rank makes the same calls: they are collective), as rank
    tensors, this rank's membership, and the errors' texts."""
    out = {"ok": [], "bad": []}
    for shape, a, b, axis in SPLITS:
        mesh = parse_mesh("x".join(map(str, shape)), "cpu")
        first, second = split_mesh(mesh, a, b, axis=axis)
        out["ok"].append([(m.mesh.tolist(), tuple(m.mesh_dim_names),
                           m.get_coordinate() is not None)
                          for m in (first, second)])
    mesh = parse_mesh("1x4", "cpu")
    for shape, a, b, axis in BAD_SPLITS:
        if shape == (2, 2):
            mesh = parse_mesh("2x2", "cpu")
        try:
            split_mesh(mesh, a, b, axis=axis)
            out["bad"].append(None)
        except ValueError as e:
            out["bad"].append(str(e))
    return out


def _deployments(job) -> dict:
    """Each half of a (1, 4) 1:2 split priced for its phase on its
    ``DeviceMesh`` (every rank, whether or not it is in the half)."""
    meta = Model(job["llama"][0], device="meta").float()
    pm, dm = split_mesh(parse_mesh("1x4", "cpu"), 1, 2)
    spec = DeploymentSpec(**DEPLOY)
    return {phase: _numbers(spec.resolve(meta, params=meta, mesh=m,
                                         phase=phase))
            for phase, m in (("prefill", pm), ("decode", dm))}


def _refusals(job) -> dict:
    """What the engine says for a ``kv_repl`` mismatch between the slices
    (1 KV head: tp 1 holds it once, tp 2 twice) and for a ring-page
    model, on every rank."""
    out = {}
    pm, dm = split_mesh(parse_mesh("1x4", "cpu"), 1, 2)
    for key, exc in (("llama_kv1", ValueError),
                     ("danube", NotImplementedError)):
        try:
            DisaggServeEngine(_model(job, key), device="cpu",
                              prefill_mesh=pm, decode_mesh=dm,
                              **_engine_kw({}))
            out[key] = None
        except exc as e:
            out[key] = str(e)
    return out


def _rank_main(rank: int, world: int, rdzv: str, job_path: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    init_world("cpu", rank=rank, world_size=world, init_method=rdzv)
    job = torch.load(job_path, weights_only=False)
    out = {"split": _split_layouts(), "deploy": _deployments(job),
           "refusals": _refusals(job)}
    for name in CASES:
        t = time.monotonic()
        out[name] = _serve_case(job, name, rank)
        out[name]["seconds"] = time.monotonic() - t
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


def _reference(pair, case: dict) -> dict:
    """The reference's single-device disaggregated run of ``case`` (and,
    for a sampled mix, its colocated one)."""
    from repro.runtime.engine import ContinuousServeEngine as RefEngine
    from repro.runtime.engine import DisaggServeEngine as RefDisagg
    ref, params, (cfg, _) = pair
    kw = _engine_kw(case["kw"], port=False)

    def reqs():
        return _requests(cfg.vocab_size, 8, case["seed"],
                         max_new=case["new"], sampled=case["sampled"],
                         port=False)
    out = {"disagg": _stats(RefDisagg(ref, params, **kw).run(reqs()))}
    if case["sampled"]:
        out["colocated"] = _stats(RefEngine(ref, params, **kw).run(reqs()))
    return out


def _fake_jax_mesh(shape):
    """A JAX Mesh of the one CPU device repeated: the reference's
    ``split_mesh`` and ``resolve`` read only its shape."""
    import jax
    dev = jax.devices()[0]
    return jax.sharding.Mesh(np.array([dev] * int(np.prod(shape)),
                                      dtype=object).reshape(shape),
                             ("data", "model"))


@pytest.fixture(scope="module")
def disagg_runs(tmp_path_factory):
    import repro.models  # noqa: F401  (import order: models before kernels)
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("disagg_tp")
    job, pairs = {}, {}
    pairs["llama"] = _bridge("llama3-8b")
    pairs["deepseek"] = _bridge("deepseek-v2-lite-16b", seed=2)
    for key in pairs:
        job[key] = pairs[key][2]
    job["llama_kv1"] = _bridge("llama3-8b", n_kv_heads=1)[2]
    job["danube"] = _bridge("h2o-danube-1.8b")[2]
    job_path = str(tmp / "job.pt")
    torch.save(job, job_path)
    ctx = mp.start_processes(
        _rank_main, args=(WORLD, f"file://{tmp}/rdzv", job_path, str(tmp)),
        nprocs=WORLD, join=False, start_method="spawn")
    ref = {}
    try:
        t, by_inputs = time.monotonic(), {}
        for name, case in CASES.items():
            # cases of one model and request mix share the reference run
            key = repr({k: v for k, v in case.items()
                        if k not in ("mesh", "split")})
            if key not in by_inputs:
                by_inputs[key] = _reference(
                    pairs[case.get("model", "llama")], case)
            ref[name] = by_inputs[key]
        ref["seconds"] = time.monotonic() - t
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
    return ranks, ref, pairs


def _serving(ranks, name):
    return [r[name] for r in ranks if r[name]["serving"]]


# ---------------------------------------------------------------------------
# split_mesh
# ---------------------------------------------------------------------------


class _FakeMesh:
    """``tests/test_disagg.py``'s duck-typed mesh: the reference's
    ``split_mesh`` touches only ``.devices`` / ``.axis_names`` and
    rebuilds through ``type(mesh)``."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)


def _ref_split(shape, a, b, axis):
    from repro.parallel.plan import split_mesh as ref_split_mesh
    mesh = _FakeMesh(np.arange(int(np.prod(shape))).reshape(shape),
                     ("data", "model"))
    return ref_split_mesh(mesh, a, b, axis=axis)


@pytest.mark.parametrize("layout", SPLITS, ids=lambda s: f"{s}")
def test_split_mesh_slices_match_the_reference(disagg_runs, layout):
    """On the same ``arange`` layouts the port's slices hold the
    reference's positions in its order, every other axis whole: as
    ``DeviceMesh``es of the four ranks (each rank a member of the slices
    that hold it) and as ``MeshShape``s."""
    ranks, _, _ = disagg_runs
    i = SPLITS.index(layout)
    shape, a, b, axis = layout
    want = [m.devices.astype(int).tolist() for m in _ref_split(*layout)]
    for rank, r in enumerate(ranks):
        got = r["split"]["ok"][i]
        assert [g[0] for g in got] == want
        assert all(g[1] == ("data", "model") for g in got)
        assert [g[2] for g in got] == [rank in np.ravel(w) for w in want]
    halves = split_mesh(MeshShape(shape), a, b, axis=axis)
    assert [h.shape for h in halves] == [np.shape(w) for w in want]
    assert all(h.mesh_dim_names == ("data", "model") for h in halves)


def test_split_mesh_errors_match_the_reference(disagg_runs):
    """A missing axis and every split that does not fit raise ValueError
    in the reference's words, on ``DeviceMesh``es and ``MeshShape``s."""
    ranks, _, _ = disagg_runs
    for i, layout in enumerate(BAD_SPLITS):
        with pytest.raises(ValueError) as want:
            _ref_split(*layout)
        text = str(want.value).replace("('data', 'model')", "")
        for r in ranks:
            assert r["split"]["bad"][i] is not None
            assert r["split"]["bad"][i].replace(
                "('data', 'model')", "") == text
        shape, a, b, axis = layout
        with pytest.raises(ValueError) as got:
            split_mesh(MeshShape(shape), a, b, axis=axis)
        assert str(got.value).replace("('data', 'model')", "") == text
    assert "no 'pipeline' axis" in ranks[0]["split"]["bad"][0]
    assert all("cannot split" in t for t in ranks[0]["split"]["bad"][1:])


def test_each_half_is_priced_as_the_reference_prices_it(disagg_runs):
    """``DeploymentSpec.resolve(phase=, mesh=)`` on each half of a (1, 4)
    1:2 split: on the ranks' ``DeviceMesh`` halves the numbers of the
    ``MeshShape`` halves, and those the reference's on its halves (a
    repeated-device JAX mesh split by its ``split_mesh``), integers
    exactly, floats at 1e-12."""
    from repro.parallel.plan import split_mesh as ref_split_mesh
    from repro.runtime import deployment as jdep
    ranks, _, pairs = disagg_runs
    ref_model, ref_params, (cfg, _) = pairs["llama"]
    meta = Model(cfg, device="meta").float()     # the f32 params' bytes
    jhalves = ref_split_mesh(_fake_jax_mesh((1, 4)), 1, 2)
    halves = split_mesh(MeshShape((1, 4)), 1, 2)
    for phase, jm, m in zip(("prefill", "decode"), jhalves, halves):
        want = _numbers(jdep.DeploymentSpec(**DEPLOY).resolve(
            ref_model, params=ref_params, mesh=jm, phase=phase))
        got = _numbers(DeploymentSpec(**DEPLOY).resolve(
            meta, params=meta, mesh=m, phase=phase))
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k] == pytest.approx(w, rel=REL, abs=0), (phase, k)
        assert got["tp"] == {"prefill": 1, "decode": 2}[phase]
        for r in ranks:
            assert r["deploy"][phase] == got, phase


# ---------------------------------------------------------------------------
# serving on the slices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_streams_equal_the_reference(disagg_runs, name):
    """Every serving rank returns the same merged stats, whose streams
    equal the reference's single-device disaggregated engine's token for
    token (and, for a sampled mix, its colocated engine's); the handoff
    counts chains, pages and prefix-shared tokens as the reference does,
    the decode steps and preemptions too.  On split slices the TTFT and
    finish stamps are the same on every rank as well (one clock, read by
    the phase that acts); one mesh for both phases keeps each data
    replica's own clock, as a colocated mesh engine does."""
    ranks, ref, _ = disagg_runs
    runs = _serving(ranks, name)
    first = runs[0]["stats"]
    stamps = ("ttft", "finish") if CASES[name]["split"] is None else ()
    for r in runs[1:]:
        assert {k: v for k, v in r["stats"].items() if k not in stamps} \
            == {k: v for k, v in first.items() if k not in stamps}, name
    want = ref[name]["disagg"]
    assert first["results"] == want["results"]
    if "colocated" in ref[name]:
        assert first["results"] == ref[name]["colocated"]["results"]
    for k in ("handoffs", "handoff_pages", "handoff_shared_tokens",
              "preemptions", "steps", "spec_windows", "chunks"):
        assert first[k] == want[k], (name, k)
    assert first["handoffs"] >= 8                # every request transferred
    assert all(t is not None for t in first["ttft"].values())
    assert all(f is not None for f in first["finish"].values())


@pytest.mark.parametrize("name", ["tp12", "tp22_fp8", "tp12_fp8",
                                  "dp2_11", "mla"])
def test_handoff_bytes_add_up_to_the_reference(disagg_runs, name):
    """The decode ranks' received bytes (of one data row) add up to the
    reference's one-device ``handoff_bytes`` for GQA pools: each decode
    rank receives its KV heads' share of every page, and each prefill
    rank sends as many bytes as its peers receive from it.  MLA's latent
    leaves replicate, so each decode rank receives them whole."""
    ranks, ref, _ = disagg_runs
    case = CASES[name]
    want = ref[name]["disagg"]["handoff_bytes"]
    runs = _serving(ranks, name)
    assert want > 0
    got = runs[0]["stats"]["handoff_bytes"]
    n_dec = case["split"][1]
    rows = 2 if case["mesh"] == "2x2" else 1
    dec = [r["own_bytes"] for r in runs if r["members"][1]]
    pre = [r["own_bytes"] for r in runs if r["members"][0]]
    assert len(dec) == n_dec * rows
    if name == "mla":
        assert got == n_dec * want
        assert dec == [want] * len(dec)
    else:
        assert got == want
        assert dec == [want // n_dec] * len(dec)
    assert sum(pre) == sum(dec)


def test_decode_pools_hold_their_share_of_the_heads(disagg_runs):
    """Decode tp 2 over 2 KV heads: one head a rank in every leaf (codes
    and fp8 scales); prefill tp 1: both; MLA's latent leaf whole on each
    rank.  A mirror builds no pools."""
    ranks, _, pairs = disagg_runs
    kvh = pairs["llama"][2][0].n_kv_heads
    for r in _serving(ranks, "tp12"):
        pre, dec = r["members"]
        assert r["pools"] == (pre, dec)
        if dec:
            assert r["heads"] == {"k": [kvh // 2], "v": [kvh // 2]}
        if pre:
            assert r["prefill_heads"] == {"k": [kvh], "v": [kvh]}
    for name in ("tp22_fp8", "tp12_fp8"):
        for r in _serving(ranks, name):
            if r["members"][1]:
                assert r["heads"] == {k: [kvh // 2] for k in (
                    "k", "v", "k_scale", "v_scale")}
    lora = pairs["deepseek"][2][0].kv_lora_rank
    for r in _serving(ranks, "mla"):
        if r["members"][1]:
            assert r["heads"]["c_kv"] == [lora]


def test_idle_rank_returns_without_serving(disagg_runs):
    """Rank 3 is in neither slice of a (1, 4) 1:2 split: it builds no
    pools, its ``run()`` returns None at once, and the other ranks finish
    without it; in a 2:2 split every rank serves."""
    ranks, _, _ = disagg_runs
    for name in ("tp12", "preemption", "speculative", "mla"):
        idle = ranks[3][name]
        assert idle["serving"] is False and idle["stats"] is None
        assert idle["members"] == (False, False)
        assert idle["pools"] == (False, False)
        assert [r[name]["serving"] for r in ranks[:3]] == [True] * 3
        assert [r[name]["tp"] for r in ranks] == [(1, 2)] * 4
    assert all(r["tp22_fp8"]["serving"] for r in ranks)


def test_pressure_speculation_and_sharing_were_exercised(disagg_runs):
    ranks, _, _ = disagg_runs
    pre = ranks[0]["preemption"]["stats"]
    assert pre["preemptions"] > 0, "settings no longer force preemption"
    assert pre["handoffs"] > 8                   # re-handoffs after restarts
    assert ranks[0]["speculative"]["stats"]["spec_windows"] > 0
    assert ranks[0]["tp12"]["stats"]["handoff_shared_tokens"] > 0
    same = ranks[0]["same_mesh"]
    assert same["members"] == (True, True) and same["tp"] == (2, 2)


def test_refusals_in_the_reference_words(disagg_runs):
    """A ``kv_repl`` mismatch between the slices (one KV head: tp 1 holds
    it once, tp 2 on each rank) and a ring-page model raise on every rank,
    in the words of the reference's ``KVHandoff`` and engine."""
    from repro.runtime.engine import ContinuousServeEngine as RefEngine
    ranks, _, pairs = disagg_runs
    for r in ranks:
        assert r["refusals"]["llama_kv1"] == (
            "handoff across kv_repl 1 vs 2 meshes needs a head-regrouping "
            "repack (recorded follow-on)")
    danube_ref, danube_params, _ = _bridge("h2o-danube-1.8b")
    with pytest.raises(NotImplementedError) as want:
        RefEngine(danube_ref, danube_params, phase="prefill",
                  **_engine_kw({}, port=False))
    for r in ranks:
        assert r["refusals"]["danube"] == str(want.value)


def test_launcher_disaggregates_under_torchrun(tmp_path):
    """``launch/serve.py --mesh 1x2 --disaggregate 1:1 --device cpu`` on
    two gloo ranks under ``torch.distributed.run`` returns 0; rank 0 alone
    prints the summary, with the split and the handoff line."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--device", "cpu", "--continuous", "--mesh", "1x2",
         "--disaggregate", "1:1", "--num-requests", "4", "--batch", "2",
         "--prompt-len", "8", "--max-new", "6"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=180)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert r.stdout.count("split 1:1 - prefill tp=1, decode tp=1") == 1
    assert r.stdout.count("handoff: 4 chains") == 1
    assert r.stdout.count("finish reasons: {'length': 4}") == 1
