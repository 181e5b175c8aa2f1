"""Fleet serving launcher of the port: simulate, plan, and cross-check a
replica fleet (the port of ``repro/launch/fleet.py`` over the numpy fleet
package ``repro_torch.fleet``).

Three modes over one seeded workload (``--arrival poisson|diurnal|mmpp``):

  **simulate** (default) — route the trace over ``--replicas`` simulated
  engine replicas with the prefix-affinity SLO router (or
  ``--router round-robin``; ``--compare-routers`` runs both) and print
  the fleet summary: TTFT/TPOT quantiles, SLO attainment, goodput,
  shed/retries, per-replica utilization.  The per-replica service model
  is the analytic memory-roofline table of the ``--sku``/``--hbmco``
  deployment; add ``--autoscale`` to close the loop with the reactive
  replica scaler.

  **--plan** — size the fleet from the trace's traffic envelope: resolve
  candidate (SKU, HBM-CO stack) specs via ``DeploymentSpec.resolve``,
  price them with the paper's provisioning models (TDP, die-mm2, J/tok),
  and report the cheapest feasible (SKU, replica-count) next to a fixed
  GPU baseline.

  **--calibrate** — build a small real ``ContinuousServeEngine`` of the
  port on ``--device`` (the card by default; ``--arch`` reduced, or with
  ``--no-reduced`` its full widths at ``--layers`` layers, which the
  card's kernels take), time its steps into a latency table, replay the
  trace through engine AND simulator, and report the throughput ratio.
  On the card the table holds the card's own step times.

  PYTHONPATH=src python -m repro_torch.launch.serve --fleet --requests 1200 \
      --arrival diurnal --rate 100 --replicas 4 --compare-routers
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet --plan \
      --arch qwen3-14b --no-reduced --weight-format mxfp4
  python -m repro_torch.launch.serve --fleet --calibrate --arch llama3-8b \
      --no-reduced --layers 2 --requests 40 --rate 30 \
      --calibration-dir /tmp/calibration                  # on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.fleet import traffic as tr
from repro_torch.fleet.autoscaler import (ReactiveAutoscaler,
                                          TrafficEnvelope, default_candidates,
                                          plan_candidate, plan_disagg_fleet,
                                          plan_fleet, replica_power_w)
from repro_torch.fleet.router import SLO, PrefixAffinityRouter, RoundRobinRouter
from repro_torch.fleet.simulator import (FleetSimulator, LatencyTable,
                                         ReplicaSpec, cross_check)
from repro_torch.models.model import Model
from repro_torch.runtime.deployment import DeploymentSpec


def gate_workload(n: int, seed: int, kind: str, rate: float,
                  prefix_len: int = 96, n_tenants: int = 12) -> tr.Trace:
    """The shared-prefix tenant workload the router gates run on."""
    lengths = tr.LengthMix(prompt_mean=128.0, prompt_sigma=0.25,
                           prompt_min=100, prompt_max=224, output_mean=24.0,
                           output_min=4, output_max=48)
    tenants = tr.TenantMix(n_tenants=n_tenants, prefix_len=prefix_len,
                           zipf_s=0.8)
    return tr.make_trace(n, seed, kind=kind, rate=rate, lengths=lengths,
                         tenants=tenants)


def gate_table() -> LatencyTable:
    """Synthetic service model for SKU-independent router experiments."""
    return LatencyTable(batches=(1, 4, 8), contexts=(32, 256),
                        decode_s=np.full((3, 2), 0.002),
                        prefill_chunk_s=0.002, prefill_chunk=32)


def _spec_from_args(args) -> DeploymentSpec:
    import torch
    cache = {"bf16": torch.bfloat16, "f32": torch.float32,
             "fp8": "fp8", "int8": "int8", None: None}[args.cache_dtype]
    return DeploymentSpec(
        sku=args.sku, hbmco=args.hbmco, max_len=args.max_len,
        weight_format=args.weight_format, cache_dtype=cache,
        max_slots=args.max_slots, stacks_per_device=args.stacks)


def _calib_path(args, cfg) -> str:
    """``experiments/calibration/<arch>--<sku-key>.json`` — the (arch,
    SKU) key the calibrated table is persisted and looked up under."""
    sku = args.sku if args.sku != "rpu-cu" else f"rpu-cu{args.stacks}"
    return os.path.join(args.calibration_dir, f"{cfg.name}--{sku}.json")


def _simulate(args, trace: tr.Trace, slo: SLO) -> int:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = Model(cfg, device="meta")     # priced from shapes, no weights
    spec = _spec_from_args(args)
    # a persisted calibration for this (arch, SKU) beats the analytic
    # roofline; the roofline beats the synthetic gate table
    table = None
    cpath = _calib_path(args, cfg)
    if os.path.exists(cpath):
        table = LatencyTable.load(cpath)
        print(f"using calibrated table {cpath}")
    try:
        resolved = spec.resolve(model)
        if table is None:
            table = LatencyTable.from_roofline(resolved)
        num_slots = resolved.num_slots
        power = replica_power_w(spec, resolved.tp)
    except Exception as e:   # tiny reduced models may not resolve a SKU
        if table is None:
            print(f"note: roofline table unavailable ({e}); "
                  f"using the synthetic gate table")
            table = gate_table()
        num_slots, power = 8, None
    rspec = ReplicaSpec(latency=table, num_slots=num_slots,
                        max_queue=2 * num_slots, page_size=spec.page_size,
                        prefix_blocks=args.prefix_blocks, power_w=power)
    routers = {"affinity": lambda: PrefixAffinityRouter(slo=slo),
               "round-robin": lambda: RoundRobinRouter(slo=slo)}
    names = list(routers) if args.compare_routers else [args.router]
    for name in names:
        scaler = ReactiveAutoscaler(min_replicas=1,
                                    max_replicas=4 * args.replicas) \
            if args.autoscale else None
        sim = FleetSimulator(rspec, args.replicas, routers[name](),
                             autoscaler=scaler)
        fs = sim.run(trace)
        print(f"--- router={name}")
        print(json.dumps(fs.summary(slo), indent=2))
        if scaler is not None and scaler.decisions:
            print("autoscaler decisions:", scaler.decisions)
    return 0


def _plan(args, trace: tr.Trace, slo: SLO) -> int:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = Model(cfg, device="meta")     # priced from shapes, no weights
    env = TrafficEnvelope.from_trace(trace)
    print(f"envelope: peak {env.peak_rate:.1f} req/s, "
          f"mean {env.mean_rate:.1f} req/s, "
          f"prompt ~{env.mean_prompt:.0f} tok, "
          f"output ~{env.mean_output:.0f} tok "
          f"-> peak decode {env.peak_decode_tokens_per_s:.0f} tok/s")
    base = _spec_from_args(args)
    best, plans = plan_fleet(model, env, slo, default_candidates(model, base),
                             headroom=args.headroom)
    for p in plans:
        print(json.dumps(p.as_dict()))
    baseline = plan_candidate(
        model, dataclasses.replace(base, sku=args.baseline_sku, hbmco=None),
        env, slo, headroom=args.headroom)
    print(f"chosen: {best.name} x {best.replicas} "
          f"({best.die_mm2:.0f} mm2, {best.power_w:.0f} W fleet)")
    print(f"baseline {baseline.name} x {baseline.replicas}: "
          f"{baseline.die_mm2 / best.die_mm2:.1f}x die, "
          f"{baseline.energy_j_per_token / best.energy_j_per_token:.1f}x "
          f"J/token vs chosen")
    if args.disagg:
        cands = default_candidates(model, base)
        dbest, dplans = plan_disagg_fleet(model, env, slo, cands, cands,
                                          headroom=args.headroom,
                                          handoff_gbs=args.handoff_gbs)
        print("--- disaggregated (phase-specialized SKUs)")
        for p in dplans:
            if p.feasible:
                print(json.dumps(p.as_dict()))
        print(f"chosen: {dbest.prefill.name} x {dbest.prefill.replicas} "
              f"prefill + {dbest.decode.name} x {dbest.decode.replicas} "
              f"decode ({dbest.die_mm2:.0f} mm2, {dbest.power_w:.0f} W, "
              f"{dbest.energy_j_per_token:.4f} J/tok)")
        print(f"vs colocated {best.name} x {best.replicas}: "
              f"{best.die_mm2 / dbest.die_mm2:.2f}x die, "
              f"{best.energy_j_per_token / dbest.energy_j_per_token:.2f}x "
              f"J/token")
    return 0


def _calibrate(args, trace: tr.Trace, slo: SLO) -> int:
    import torch

    from repro_torch.runtime.engine import ContinuousServeEngine

    cfg = get_config(args.arch)
    cfg = reduced_config(cfg) if args.reduced else dataclasses.replace(
        cfg, n_layers=args.layers or cfg.n_layers)
    model = Model(cfg, device=args.device).init(seed=args.seed)
    if trace.vocab > cfg.vocab_size:
        # materialized prompts must be valid token ids for the reduced
        # model that replays them (presence rows index by token id)
        trace = dataclasses.replace(trace, vocab=cfg.vocab_size)
    max_len = max(trace.lengths.prompt_max + trace.lengths.output_max + 8,
                  args.max_len)
    eng = ContinuousServeEngine(
        model, device=args.device, num_slots=8, page_size=16,
        num_pages=1 + 16 * -(-max_len // 16), max_len=max_len,
        cache_dtype=torch.float32, prefill_chunk=32,
        enable_prefix_cache=False)
    res = cross_check(eng, trace)
    table = LatencyTable.from_dict(res.pop("table"))
    cpath = _calib_path(args, cfg)
    table.save(cpath)
    print(f"calibration table ({cfg.name}, {cfg.n_layers} layers, on "
          f"{eng.device}) -> {cpath}")
    print(json.dumps(res, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.fleet")
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--plan", action="store_true",
                    help="size the fleet from the traffic envelope")
    ap.add_argument("--calibrate", action="store_true",
                    help="calibrate a real engine + cross-check the sim")
    ap.add_argument("--requests", type=int, default=1200)
    ap.add_argument("--rate", type=float, default=100.0, help="req/s mean")
    ap.add_argument("--arrival", default="diurnal",
                    choices=list(tr.ARRIVAL_KINDS))
    ap.add_argument("--tenants", type=int, default=12)
    ap.add_argument("--prefix-len", type=int, default=96,
                    help="shared tokens per tenant (system prompt)")
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--router", default="affinity",
                    choices=["affinity", "round-robin"])
    ap.add_argument("--compare-routers", action="store_true")
    ap.add_argument("--autoscale", action="store_true",
                    help="closed-loop replica scaling during the sim")
    ap.add_argument("--ttft-slo", type=float, default=0.025,
                    help="seconds, arrival -> first token")
    ap.add_argument("--tpot-slo", type=float, default=0.012,
                    help="seconds per token after the first")
    ap.add_argument("--prefix-blocks", type=int, default=24,
                    help="per-replica prefix-index capacity (blocks)")
    ap.add_argument("--sku", default="rpu-cu")
    ap.add_argument("--hbmco", default=None)
    ap.add_argument("--stacks", type=int, default=2)
    ap.add_argument("--weight-format", default=None)
    ap.add_argument("--cache-dtype", default=None,
                    choices=["bf16", "f32", "fp8", "int8"])
    ap.add_argument("--max-slots", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--headroom", type=float, default=1.25)
    ap.add_argument("--baseline-sku", default="h200")
    ap.add_argument("--disagg", action="store_true",
                    help="with --plan: also price phase-specialized "
                         "prefill/decode SKU pairings")
    ap.add_argument("--handoff-gbs", type=float, default=64.0,
                    help="KV handoff bandwidth between phases, GB/s")
    ap.add_argument("--device", default="cuda",
                    help="--calibrate: where the engine runs (cuda, the "
                         "default, or cpu)")
    ap.add_argument("--layers", type=int, default=None,
                    help="--calibrate with --no-reduced: the model's first "
                         "layers only (full widths)")
    ap.add_argument("--calibration-dir", default="experiments/calibration",
                    help="persisted (arch, SKU) latency tables: "
                         "--calibrate writes, simulate reads")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    trace = gate_workload(args.requests, args.seed, args.arrival, args.rate,
                          prefix_len=args.prefix_len,
                          n_tenants=args.tenants)
    slo = SLO(ttft_s=args.ttft_slo, tpot_s=args.tpot_slo)
    print(f"trace: {len(trace.requests)} requests over "
          f"{trace.duration:.1f}s ({args.arrival}, seed {args.seed})")
    if args.plan:
        return _plan(args, trace, slo)
    if args.calibrate:
        return _calibrate(args, trace, slo)
    return _simulate(args, trace, slo)


if __name__ == "__main__":
    raise SystemExit(main())
