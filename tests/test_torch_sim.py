"""The port's simulator and cost models (``repro_torch.sim``,
``repro_torch.core.provisioning``, ``repro_torch.core.sku``) against the
reference's on the same configs and inputs.

The modules are copies with their imports redirected, so every number is
held at 1e-12 (relative) and every program phase by phase: a difference
would come from the port's ``build_plan`` or footprint helpers, which the
compiler and the cost models read.  The configs are the twelve that both
packages plan (the port's registry, the stateful mamba2 and hymba among
them); the reference's other configs go through the port's plan as the
reference's own ``ModelConfig`` fields, as do the configs the registry
gained after those cases were written.  The port's counterparts of ``tests/test_sim.py``'s paper checks
run as one parametrised test.
"""
import dataclasses
import math

import pytest

from repro.configs import get_config, list_configs
from repro.core import provisioning as jprov
from repro.core import sku as jsku
from repro.core.hbmco import (CANDIDATE_CO as J_CO,
                              enumerate_design_space as j_space,
                              pareto_frontier as j_frontier)
from repro.models.model import build_model
from repro.sim import compiler as jcomp
from repro.sim import engine as jeng
from repro.sim import gpu_model as jgpu
from repro.sim import scaling as jscal
from repro_torch import configs as tconfigs
from repro_torch.core import hardware as thw
from repro_torch.core import provisioning as tprov
from repro_torch.core import sku as tsku
from repro_torch.core.hbmco import (CANDIDATE_CO as T_CO,
                                    enumerate_design_space as t_space,
                                    pareto_frontier as t_frontier)
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import Model
from repro_torch.sim import compiler as tcomp
from repro_torch.sim import engine as teng
from repro_torch.sim import gpu_model as tgpu
from repro_torch.sim import scaling as tscal

PLANNED = ["llama3-8b", "llama3-70b", "llama3-405b", "qwen3-14b",
           "qwen2.5-14b", "deepseek-v2-lite-16b", "llama4-scout-109b-a17b",
           "llama4-maverick-400b-a17b", "phi3-mini-3.8b", "h2o-danube-1.8b",
           "mamba2-370m", "hymba-1.5b"]
# configs the registry gained since the outside-the-registry cases were
# written: still held there too, through their ModelConfig fields
ADDED = ["phi3-mini-3.8b", "h2o-danube-1.8b", "mamba2-370m", "hymba-1.5b"]
STATEFUL = ["mamba2-370m", "hymba-1.5b"]
REL = 1e-12
OPTIONS = [dict(), dict(n_cus=16, batch=8, seq_len=2048, kv_bytes=2.0),
           dict(n_cus=428, batch=1, seq_len=8192)]


def _same(got, want, where="") -> None:
    """Recursive equality: floats at ``REL``, everything else exactly;
    dataclasses field by field (so the two packages' classes compare)."""
    if dataclasses.is_dataclass(want):
        assert dataclasses.is_dataclass(got), where
        assert type(got).__name__ == type(want).__name__, where
        fields = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == fields, where
        for f in fields:
            _same(getattr(got, f), getattr(want, f), f"{where}.{f}")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        assert got == pytest.approx(want, rel=REL, abs=0), where
    else:
        assert got == want, where


def _pair(name):
    return tconfigs.get_config(name), get_config(name)


@pytest.mark.parametrize("name", PLANNED)
def test_compiled_program_matches_reference(name):
    """``compile_decode_step``: the same layers, repeats and phases (every
    byte, flop, hop and flag) at three deployment points."""
    t, j = _pair(name)
    for kw in OPTIONS:
        got = tcomp.compile_decode_step(t, tcomp.CompileOptions(**kw))
        want = jcomp.compile_decode_step(j, jcomp.CompileOptions(**kw))
        _same(got, want, f"{name} {kw}")
        assert got.total_mem_bytes() == pytest.approx(
            want.total_mem_bytes(), rel=REL, abs=0)


@pytest.mark.parametrize("name", PLANNED)
def test_simulation_matches_reference(name):
    """``simulate_program`` on both programs: every field of the result,
    the phase spans included, also without decoupling and with global
    barriers."""
    t, j = _pair(name)
    kw = OPTIONS[1]
    tp = tcomp.compile_decode_step(t, tcomp.CompileOptions(**kw))
    jp = jcomp.compile_decode_step(j, jcomp.CompileOptions(**kw))
    for sim in (dict(), dict(decoupled=False), dict(fine_grained_net=False),
                dict(buffer_bytes=1 << 20, chunk_bytes=16 * 1024)):
        _same(teng.simulate_program(tp, **sim),
              jeng.simulate_program(jp, **sim), f"{name} {sim}")


@pytest.mark.parametrize("name", PLANNED)
def test_gpu_model_matches_reference(name):
    """``gpu_decode_latency`` (bf16 and the paper's MXFP4 deployment, 1-8
    GPUs, batch 1-32) and ``min_gpus_for_model``."""
    t, j = _pair(name)
    for n_gpus, wbits, kvbits in ((1, 16.0, 16.0), (1, 4.25, 8.0),
                                  (8, 4.25, 16.0)):
        for batch, seq in ((1, 8192), (8, 700), (32, 4096)):
            got = tgpu.gpu_decode_latency(
                t, tgpu.GPUSystemConfig(n_gpus=n_gpus, weight_bits=wbits,
                                        kv_bits=kvbits),
                batch=batch, seq_len=seq)
            want = jgpu.gpu_decode_latency(
                j, jgpu.GPUSystemConfig(n_gpus=n_gpus, weight_bits=wbits,
                                        kv_bits=kvbits),
                batch=batch, seq_len=seq)
            _same(got, want, f"{name} {n_gpus} {wbits} {batch}")
            assert got.tokens_per_s == pytest.approx(want.tokens_per_s,
                                                     rel=REL)
    for chip in ("H100", "H200"):
        for wbits in (16.0, 4.25):
            assert tgpu.min_gpus_for_model(t, getattr(thw, chip), wbits) == \
                jgpu.min_gpus_for_model(j, getattr(jgpu.hardware, chip),
                                        wbits)


@pytest.mark.parametrize("name", PLANNED)
def test_scaling_matches_reference(name):
    """``min_cus_for_model``, ``select_sku_for``, ``rpu_point``,
    ``strong_scaling`` and ``iso_tdp_comparison`` (the paper's headline
    table) as the reference's."""
    t, j = _pair(name)
    assert tscal.min_cus_for_model(t) == jscal.min_cus_for_model(j)
    assert tscal.min_cus_for_model(t, batch=8, seq_len=4096) == \
        jscal.min_cus_for_model(j, batch=8, seq_len=4096)
    for n in (64, 256):
        _same(tscal.select_sku_for(t, n), jscal.select_sku_for(j, n), name)
    _same(tscal.strong_scaling(t, [32, 128, 512], batch=1, seq_len=8192),
          jscal.strong_scaling(j, [32, 128, 512], batch=1, seq_len=8192),
          name)
    _same(tscal.rpu_point(t, 128, batch=4, seq_len=2048, decoupled=False),
          jscal.rpu_point(j, 128, batch=4, seq_len=2048, decoupled=False),
          name)
    for kw in (dict(), dict(batch=8, seq_len=2048)):
        _same(tscal.iso_tdp_comparison(t, **kw),
              jscal.iso_tdp_comparison(j, **kw), f"{name} {kw}")


def test_system_cost_and_provisioning_match_reference():
    """``system_cost``, ``cu_tdp_w``, ``iso_tdp_cus`` over the whole
    HBM-CO frontier, and every function of ``core/provisioning.py``."""
    tf, jf = t_frontier(t_space()), j_frontier(j_space())
    _same(tf, jf, "frontier")
    for ts, js in zip(tf, jf):
        for n in (1, 64, 428):
            _same(tscal.system_cost(n, ts), jscal.system_cost(n, js), n)
        _same(tscal.cu_tdp_w(thw.RPU_DEFAULT, ts),
              jscal.cu_tdp_w(jscal.hardware.RPU_DEFAULT, js), ts.name)
        assert tscal.iso_tdp_cus(2800.0, ts) == jscal.iso_tdp_cus(2800.0, js)
        for bw in (0.3, 1.0):
            _same(tprov.cu_mem_stream_w(ts, bw), jprov.cu_mem_stream_w(js, bw))
            _same(tprov.cu_power_w(ts, bw, 0.4, 0.1),
                  jprov.cu_power_w(js, bw, 0.4, 0.1))
        _same(tprov.cu_tdp_w(ts), jprov.cu_tdp_w(js))
        assert tprov.iso_tdp_cus(2800.0, ts) == jprov.iso_tdp_cus(2800.0, js)
    _same(tprov.GPU_LIKE, jprov.GPU_LIKE)
    _same(tprov.RPU_POINT, jprov.RPU_POINT)
    _same(tprov.die_cost_saving(), jprov.die_cost_saving())
    for ai in (0.5, 1.0, 2.0, 64.0, 500.0):
        _same(tprov.tdp_utilization(tprov.GPU_LIKE, ai),
              jprov.tdp_utilization(jprov.GPU_LIKE, ai))
        _same(tprov.tdp_utilization_gain(ai), jprov.tdp_utilization_gain(ai))
    for n in (1, 128, 856):
        _same(tprov.shoreline_mm(n), jprov.shoreline_mm(n))
    assert tprov.DATAPATH_PJ_PER_BIT == jprov.DATAPATH_PJ_PER_BIT


@pytest.mark.parametrize("name", ["llama3-8b", "llama3-70b",
                                  "deepseek-v2-lite-16b",
                                  "llama4-scout-109b-a17b",
                                  "llama4-maverick-400b-a17b"])
def test_sku_map_matches_reference(name):
    """``WorkloadFootprint.from_model`` on a ``meta`` model (bf16 and
    MXFP4 weights, bf16 and fp8 KV where the model's pools take it) and
    the Fig 10 ``sku_map`` over a (batch, seq) grid."""
    import jax.numpy as jnp
    import torch

    t, j = _pair(name)
    port, ref = Model(t, device="meta"), build_model(j)
    caches = [(None, None), (jnp.bfloat16, torch.bfloat16)]
    if not t.mla:
        caches.append(("fp8", "fp8"))
    for fmt in (None, "mxfp4"):
        for jc, tc in caches:
            got = tsku.WorkloadFootprint.from_model(
                port, weight_format=fmt, cache_dtype=tc)
            want = jsku.WorkloadFootprint.from_model(
                ref, weight_format=fmt, cache_dtype=jc)
            _same(got, want, f"{name} {fmt} {jc}")
            for kw in (dict(), dict(n_cus=256, ref_batch=8, ref_seq=2048)):
                _same(tsku.sku_map(got, [1, 8, 64], [2048, 32768], **kw),
                      jsku.sku_map(want, [1, 8, 64], [2048, 32768], **kw),
                      f"{name} {fmt} {kw}")


@pytest.mark.parametrize("name", [n for n in list_configs()
                                  if n not in PLANNED or n in ADDED])
def test_reference_configs_outside_the_registry(name):
    """The reference's other configs, given to the port as the same
    ``ModelConfig`` fields (sliding-window danube, phi3-mini, the frontend
    configs, whose plans are plain ``attn_dense``, and the stateful mamba2
    and hymba, whose ``ssm`` and ``hybrid`` plans the port builds now),
    compile to the reference's program and give its GPU latency; the
    stateful ones also its ISO-TDP comparison, in every entry point that
    plans."""
    j = get_config(name)
    t = ModelConfig(**dataclasses.asdict(j))
    opts = tcomp.CompileOptions()
    if name in STATEFUL:
        _same(tscal.iso_tdp_comparison(t), jscal.iso_tdp_comparison(j), name)
    _same(tcomp.compile_decode_step(t, opts),
          jcomp.compile_decode_step(j, jcomp.CompileOptions()), name)
    _same(tgpu.gpu_decode_latency(t, tgpu.GPUSystemConfig(), batch=4),
          jgpu.gpu_decode_latency(j, jgpu.GPUSystemConfig(), batch=4), name)


# ---------------------------------------------------------------------------
# the paper's checks (tests/test_sim.py) on the port
# ---------------------------------------------------------------------------


def _sim(name, n_cus=64, batch=1, seq=16384, **kw):
    prog = tcomp.compile_decode_step(
        tconfigs.get_config(name),
        tcomp.CompileOptions(n_cus=n_cus, batch=batch, seq_len=seq))
    return teng.simulate_program(prog, **kw)


def _bs1_saturates_memory_bandwidth():
    assert _sim("llama3-8b", batch=1).mem_bw_utilization > 0.95


def _compiled_bytes_match_footprint():
    from repro_torch.models.footprint import compute_footprint
    cfg = tconfigs.get_config("llama3-8b")
    prog = tcomp.compile_decode_step(
        cfg, tcomp.CompileOptions(n_cus=64, batch=1, seq_len=16384))
    want = compute_footprint(cfg).streamed_bytes_per_token(1, 16384) / 64
    assert prog.total_mem_bytes() == pytest.approx(want, rel=0.1)


def _decoupling_speedup_bs32():
    r_dec = _sim("llama3-8b", batch=32, seq=8192)
    r_ser = _sim("llama3-8b", batch=32, seq=8192, decoupled=False)
    assert 1.05 < r_ser.latency_s / r_dec.latency_s < 2.2


def _fine_grained_net_avoids_collective_stalls():
    r_fg = _sim("llama3-405b", n_cus=428, batch=1, seq=8192)
    r_gb = _sim("llama3-405b", n_cus=428, batch=1, seq=8192,
                fine_grained_net=False)
    assert 1.3 < r_gb.latency_s / r_fg.latency_s < 2.3


def _batch32_slower_than_batch1():
    r1 = _sim("llama3-8b", batch=1, seq=16384)
    r32 = _sim("llama3-8b", batch=32, seq=8192)
    assert 3.0 < r32.latency_s / r1.latency_s < 20.0


def _peak_latency_points_vs_paper():
    g = tconfigs.get_config
    p70 = tscal.rpu_point(g("llama3-70b"), 204, batch=1, seq_len=8192)
    assert p70.ms_per_token == pytest.approx(0.4, rel=0.5)
    p405 = tscal.rpu_point(g("llama3-405b"), 428, batch=1, seq_len=8192)
    assert p405.ms_per_token == pytest.approx(1.0, rel=0.5)
    scout = tscal.rpu_point(g("llama4-scout-109b-a17b"), 128, batch=1,
                            seq_len=8192)
    assert scout.ms_per_token == pytest.approx(0.2, rel=0.6)


def _iso_tdp_headline_405b():
    r = tscal.iso_tdp_comparison(tconfigs.get_config("llama3-405b"),
                                 batch=1, seq_len=8192)
    assert r["n_gpus"] == 4
    assert 30.0 < r["speedup"] < 60.0, r["speedup"]
    assert abs(r["rpu_tdp_w"] - r["gpu_tdp_w"]) / r["gpu_tdp_w"] < 0.25
    assert r["energy_ratio"] > 5.0


def _strong_scaling_monotone_then_plateau():
    pts = tscal.strong_scaling(tconfigs.get_config("llama3-70b"),
                               [32, 64, 128, 256, 512], batch=1,
                               seq_len=8192)
    lat = [p.ms_per_token for p in pts]
    assert lat[1] < lat[0] and lat[2] < lat[1] and lat[3] < lat[2]
    assert lat[-2] / lat[-1] < lat[0] / lat[1]
    assert lat[-1] < lat[0]


def _gpu_decode_utilization_calibration():
    g = tgpu.gpu_decode_latency(tconfigs.get_config("llama3-405b"),
                                tgpu.GPUSystemConfig(n_gpus=4), batch=1,
                                seq_len=8192)
    assert g.bw_utilization == pytest.approx(0.32, abs=0.08)


def _system_cost_components():
    c = tscal.system_cost(64, T_CO)
    assert c["total"] == pytest.approx(sum(
        c[k] for k in ("silicon", "memory", "substrate", "pcb")))
    assert c["memory"] > 0 and c["silicon"] > 0


def _min_cus_scales_with_model():
    g = tconfigs.get_config
    assert tscal.min_cus_for_model(g("llama3-405b")) > \
        tscal.min_cus_for_model(g("llama3-8b"))


PAPER_CHECKS = [_bs1_saturates_memory_bandwidth,
                _compiled_bytes_match_footprint, _decoupling_speedup_bs32,
                _fine_grained_net_avoids_collective_stalls,
                _batch32_slower_than_batch1, _peak_latency_points_vs_paper,
                _iso_tdp_headline_405b, _strong_scaling_monotone_then_plateau,
                _gpu_decode_utilization_calibration, _system_cost_components,
                _min_cus_scales_with_model]


@pytest.mark.parametrize("check", PAPER_CHECKS,
                         ids=[c.__name__.lstrip("_") for c in PAPER_CHECKS])
def test_paper_checks_hold_on_the_port(check):
    """``tests/test_sim.py``'s claims of the paper (§VI, §VIII, §IX),
    computed by the port's modules."""
    check()


def test_constants_match_reference():
    """No constant of the paper's models differs from the reference's."""
    for mod_t, mod_j in ((tcomp, jcomp), (teng, jeng), (tscal, jscal),
                         (tprov, jprov)):
        for k, v in vars(mod_j).items():
            if k.isupper() and isinstance(v, (int, float)):
                assert getattr(mod_t, k) == v, (mod_t.__name__, k)
    _same(tgpu.GPUSystemConfig(), jgpu.GPUSystemConfig())
    assert math.isclose(tgpu.GPUSystemConfig().tdp_w,
                        jgpu.GPUSystemConfig().tdp_w)
    _same(T_CO, J_CO)
