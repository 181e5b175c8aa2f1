"""The port's fleet package (``repro_torch/fleet``, a copy of the
reference's numpy-only ``repro/fleet`` over the port's ``core``,
``runtime/deployment.py`` and ``runtime/kv_cache.py``) against the
reference on seeded traces: traces request for request, simulator
summaries and plans exactly for counts and within 1e-12 (relative) for
floats; the router's placement map, the latency table's round trip, and
the calibration against a port engine on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.models  # noqa: F401  (import order: models before kernels)

from repro import fleet as jf
from repro.configs import get_config
from repro.fleet import traffic as jtr
from repro.launch import fleet as jlaunch
from repro.models.model import build_model
from repro.runtime import deployment as jdep
from repro_torch import configs as tconfigs
from repro_torch import fleet as tf
from repro_torch.fleet import traffic as ttr
from repro_torch.launch import fleet as tlaunch
from repro_torch.models.model import Model
from repro_torch.runtime import deployment as tdep

REL = 1e-12


def _same(got, want, path="") -> None:
    """Equal structures: counts, strings and bools exactly, floats within
    ``REL`` (relative)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=REL, abs=0), path
    else:
        assert got == want, path


@pytest.mark.parametrize("kind", list(jtr.ARRIVAL_KINDS))
def test_traces_match_reference(kind):
    got = tlaunch.gate_workload(300, 5, kind, 80.0)
    want = jlaunch.gate_workload(300, 5, kind, 80.0)
    assert got.vocab == want.vocab and got.duration == want.duration
    assert [dataclasses.astuple(r) for r in got.requests] == [
        dataclasses.astuple(r) for r in want.requests]
    for r in got.requests[:20]:
        np.testing.assert_array_equal(
            ttr.materialize_prompt(got, r),
            jtr.materialize_prompt(want, want.requests[r.rid]))
    assert ttr.tenant_chains(got, 16) == jtr.tenant_chains(want, 16)


@pytest.mark.parametrize("router", ["affinity", "round-robin"])
@pytest.mark.parametrize("autoscale", [False, True], ids=["fixed", "scaled"])
def test_simulator_summaries_match_reference(router, autoscale):
    """The fleet launcher's simulate path (gate table, 4 replicas) with
    either router, with and without the reactive autoscaler."""
    slo_args = dict(ttft_s=0.025, tpot_s=0.012)
    out = []
    for mod, launch in ((tf, tlaunch), (jf, jlaunch)):
        trace = launch.gate_workload(600, 2, "diurnal", 150.0)
        spec = mod.ReplicaSpec(latency=launch.gate_table(), num_slots=8,
                               max_queue=16, page_size=16, prefix_blocks=24)
        slo = mod.SLO(**slo_args)
        r = (mod.PrefixAffinityRouter(slo=slo) if router == "affinity"
             else mod.RoundRobinRouter(slo=slo))
        scaler = (mod.ReactiveAutoscaler(min_replicas=1, max_replicas=8)
                  if autoscale else None)
        fs = mod.FleetSimulator(spec, 4, r, autoscaler=scaler).run(trace)
        out.append((fs.summary(slo), scaler.decisions if scaler else None))
    _same(out[0][0], out[1][0])
    _same(out[0][1], out[1][1])


def test_roofline_table_and_plans_match_reference():
    """``LatencyTable.from_roofline`` of a resolved qwen3-14b deployment,
    and ``plan_fleet`` / ``plan_disagg_fleet`` over the default
    candidates for a diurnal envelope (``tests/test_disagg.py``'s
    planning case), plan for plan."""
    ref = build_model(get_config("qwen3-14b"))
    port = Model(tconfigs.get_config("qwen3-14b"), device="meta")
    kw = dict(max_len=2048, weight_format="mxfp4", cache_dtype="fp8",
              max_slots=32)
    _same(tf.LatencyTable.from_roofline(tdep.DeploymentSpec(
              sku="h200", **kw).resolve(port)).as_dict(),
          jf.LatencyTable.from_roofline(jdep.DeploymentSpec(
              sku="h200", **kw).resolve(ref)).as_dict())
    res = []
    for mod, tr, dep, model in ((tf, ttr, tdep, port), (jf, jtr, jdep, ref)):
        lengths = tr.LengthMix(prompt_mean=512.0, prompt_min=64,
                               prompt_max=1024, output_mean=256.0,
                               output_min=32, output_max=512)
        trace = tr.make_trace(400, 0, kind="diurnal", rate=200.0,
                              lengths=lengths)
        env = mod.TrafficEnvelope.from_trace(trace)
        slo = mod.SLO(ttft_s=0.4, tpot_s=0.05)
        cands = mod.default_candidates(model, dep.DeploymentSpec(**kw))
        best, plans = mod.plan_fleet(model, env, slo, cands)
        dbest, dplans = mod.plan_disagg_fleet(model, env, slo, cands, cands)
        res.append(([p.as_dict() for p in plans], best.as_dict(),
                    [p.as_dict() for p in dplans], dbest.as_dict()))
    _same(res[0], res[1])
    got_best = res[0][3]
    assert got_best["prefill_replicas"] >= 1
    assert got_best["decode_replicas"] >= 1


def test_router_adopt_placement_survives_drain():
    """``tests/test_disagg.py``'s router case on the port's router."""
    r = tf.PrefixAffinityRouter()
    keys = [b"a", b"b", b"c"]

    class _Rep:
        draining = False

        def queue_depth(self):
            return 0

        def load(self):
            return 0.0

        def saturated(self):
            return False

        def match_tokens(self, chain):
            return 0

    a, b = _Rep(), _Rep()
    assert r.adopt_placement(keys, b) == 3
    order = r.order(0.0, 64, keys, [a, b])
    assert order[0][2] == 1 and order[0][0] > order[1][0]
    assert r._adopted_frac([b"a", b"x", b"c"], b) == pytest.approx(1 / 3)
    r.placement_cap = 4
    r.adopt_placement([b"1", b"2", b"3", b"4"], a)
    assert len(r.placement) == 4 and b"a" not in r.placement
    rr = tf.RoundRobinRouter()
    rr.adopt_placement(keys, b)
    assert [i for _, _, i in rr.order(0.0, 64, keys, [a, b])] == [0, 1]
    assert [i for _, _, i in rr.order(0.0, 64, keys, [a, b])] == [1, 0]


def test_latency_table_save_load_roundtrip(tmp_path):
    port = Model(tconfigs.get_config("qwen3-14b"), device="meta")
    t = tf.LatencyTable.from_roofline(tdep.DeploymentSpec(
        sku="h200", max_len=2048, weight_format="mxfp4", cache_dtype="fp8",
        max_slots=32).resolve(port))
    p = tmp_path / "calibration" / "qwen3-14b--h200.json"
    t.save(str(p))
    back = tf.LatencyTable.load(str(p))
    assert back.batches == t.batches and back.contexts == t.contexts
    np.testing.assert_array_equal(np.asarray(back.decode_s),
                                  np.asarray(t.decode_s))
    assert back.decode_step_s(5, 300) == t.decode_step_s(5, 300)


def test_calibrate_times_a_port_engine():
    """``calibrate`` drives a port ``ContinuousServeEngine`` (reduced
    llama3-8b on the CPU) through its grid: every entry a positive time,
    the engine left reset and idle."""
    from repro_torch.runtime.engine import ContinuousServeEngine
    cfg = tconfigs.reduced_config(tconfigs.get_config("llama3-8b"))
    eng = ContinuousServeEngine(
        Model(cfg, device="cpu").init(seed=0), device="cpu", num_slots=2,
        page_size=4, num_pages=40, max_len=40, cache_dtype=torch.float32,
        prefill_chunk=8, enable_prefix_cache=False)
    table = tf.calibrate(eng, n_steps=2)
    assert table.batches == (1, 2) and len(table.contexts) == 2
    assert (np.asarray(table.decode_s) > 0).all()
    assert table.prefill_chunk_s > 0 and table.prefill_chunk == 8
    assert not eng.has_unfinished()
