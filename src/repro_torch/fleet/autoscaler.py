"""Fleet planning: SKU + replica count from a traffic envelope.

Closes the loop from the paper's provisioning analysis to a running
system: a :class:`TrafficEnvelope` (peak/mean arrival rate, length mix)
is turned into candidate ``DeploymentSpec``s — RPU CUs with the HBM-CO
stack chosen from the Fig-10 Pareto frontier (``core.hbmco``), plus
named GPU SKUs — each resolved into per-replica throughput via
``DeploymentSpec.resolve`` and priced with the §IV provisioning models
(``core.provisioning``): TDP per replica, die-mm² per provisioned GB/s,
joules per token.  :func:`plan_fleet` picks the cheapest feasible
(SKU, replica count) under the SLO; :class:`ReactiveAutoscaler` is the
closed-loop variant the simulator polls mid-run.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import hardware, provisioning
from repro_torch.core.hbmco import CANDIDATE_CO, enumerate_design_space, \
    hbmco_by_name, pareto_frontier, select_sku
from repro_torch.core.sku import WorkloadFootprint
from repro_torch.fleet.router import SLO
from repro_torch.fleet import traffic as tr
from repro_torch.runtime.deployment import CHIP_SKUS, DeploymentError, \
    DeploymentSpec


# ---------------------------------------------------------------------------
# traffic envelope
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrafficEnvelope:
    """What the fleet must absorb: rates in req/s, lengths in tokens."""
    peak_rate: float
    mean_rate: float
    mean_prompt: float
    mean_output: float

    @classmethod
    def from_trace(cls, trace: tr.Trace,
                   window_s: float = 10.0) -> "TrafficEnvelope":
        """Peak = max windowed arrival rate over the trace."""
        arr = np.asarray([r.arrival for r in trace.requests])
        if arr.size == 0:
            raise ValueError("empty trace")
        duration = max(float(arr[-1]), 1e-9)
        # a window longer than the trace would report peak < mean
        w = min(window_s, max(duration / 4.0, 1e-6))
        nbins = max(int(math.ceil(duration / w)), 1)
        counts, _ = np.histogram(arr, bins=nbins, range=(0.0, nbins * w))
        return cls(
            peak_rate=float(counts.max()) / w,
            mean_rate=trace.mean_rate(),
            mean_prompt=float(np.mean([r.prompt_len
                                       for r in trace.requests])),
            mean_output=float(np.mean([r.output_len
                                       for r in trace.requests])))

    @property
    def peak_decode_tokens_per_s(self) -> float:
        return self.peak_rate * self.mean_output


# ---------------------------------------------------------------------------
# per-replica cost models (paper §IV provisioning)
# ---------------------------------------------------------------------------


def _resolve_hbm(spec: DeploymentSpec):
    hbm = spec.hbmco
    if isinstance(hbm, str):
        hbm = hbmco_by_name(hbm)
    return hbm or CANDIDATE_CO


def replica_power_w(spec: DeploymentSpec, tp: int = 1) -> float:
    """Modeled TDP of one replica (``tp`` devices).

    RPU CUs get the §IV per-CU TDP (full memory stream over the stack's
    pJ/bit, divided by the memory power fraction); named chips use their
    data-sheet TDP.
    """
    if isinstance(spec.sku, str) and spec.sku == "rpu-cu":
        return provisioning.cu_tdp_w(_resolve_hbm(spec)) * tp
    chip = spec.sku if isinstance(spec.sku, hardware.ChipSpec) \
        else CHIP_SKUS[spec.sku]
    return chip.tdp_w * tp


def replica_die_mm2(spec: DeploymentSpec, tp: int = 1) -> float:
    """Die-area cost proxy per replica: mm² per provisioned GB/s at the
    SKU's compute-to-bandwidth provisioning point (the §IX 3.3x lever)."""
    if isinstance(spec.sku, str) and spec.sku == "rpu-cu":
        gbs = hardware.RPU_DEFAULT.cu_mem_bw / 1e9
        return provisioning.RPU_POINT.die_mm2_per_gbs() * gbs * tp
    chip = spec.sku if isinstance(spec.sku, hardware.ChipSpec) \
        else CHIP_SKUS[spec.sku]
    return provisioning.GPU_LIKE.die_mm2_per_gbs() * (chip.hbm_bw / 1e9) * tp


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------


def rpu_candidates(model, base: DeploymentSpec, *,
                   stacks=(2, 4, 8)) -> list[DeploymentSpec]:
    """RPU-CU candidates with the HBM-CO stack picked from the Pareto
    frontier for the model's footprint (the Fig-10 selection rule: the
    highest-BW/Cap stack whose capacity still fits weights + KV)."""
    wl = WorkloadFootprint.from_model(model, weight_format=base.weight_format,
                                      cache_dtype=base.cache_dtype)
    frontier = pareto_frontier(enumerate_design_space())
    out = []
    for n in stacks:
        # per-stack capacity the workload needs at a full slot set,
        # with workspace headroom mirroring resolve()'s budget split
        need = wl.capacity_bytes(base.max_slots, base.max_len) \
            / (n * (1.0 - base.workspace_fraction))
        sku = select_sku(need, frontier)
        if sku is None:
            continue
        out.append(dataclasses.replace(base, sku="rpu-cu", hbmco=sku,
                                       stacks_per_device=n))
    return out


def default_candidates(model, base: DeploymentSpec | None = None,
                       **kw) -> list[DeploymentSpec]:
    """RPU stacks off the frontier + the named GPU SKUs."""
    base = base or DeploymentSpec(**kw)
    cands = rpu_candidates(model, base)
    for name in ("h100", "h200"):
        cands.append(dataclasses.replace(base, sku=name, hbmco=None,
                                         stacks_per_device=2))
    return cands


# ---------------------------------------------------------------------------
# static planning
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetPlan:
    """One (SKU, replica-count) point, priced and SLO-checked."""
    spec: DeploymentSpec
    resolved: object | None
    replicas: int
    feasible: bool
    reason: str = ""
    per_replica_tokens_per_s: float = 0.0
    fleet_tokens_per_s: float = 0.0
    ttft_est_s: float = 0.0
    tpot_est_s: float = 0.0
    power_w: float = 0.0              # whole fleet
    die_mm2: float = 0.0              # whole fleet
    energy_j_per_token: float = 0.0   # TDP / per-replica throughput

    @property
    def name(self) -> str:
        if self.resolved is not None:
            return self.resolved.device.name
        return str(self.spec.sku)

    def as_dict(self) -> dict:
        return {"sku": self.name, "replicas": self.replicas,
                "feasible": self.feasible, "reason": self.reason,
                "per_replica_tokens_per_s":
                    round(self.per_replica_tokens_per_s, 2),
                "fleet_tokens_per_s": round(self.fleet_tokens_per_s, 2),
                "ttft_est_s": round(self.ttft_est_s, 4),
                "tpot_est_s": round(self.tpot_est_s, 5),
                "power_w": round(self.power_w, 1),
                "die_mm2": round(self.die_mm2, 1),
                "energy_j_per_token": round(self.energy_j_per_token, 6)}


def plan_candidate(model, spec: DeploymentSpec, envelope: TrafficEnvelope,
                   slo: SLO, *, headroom: float = 1.25) -> FleetPlan:
    try:
        r = spec.resolve(model)
    except (DeploymentError, NotImplementedError) as e:
        return FleetPlan(spec=spec, resolved=None, replicas=0,
                         feasible=False, reason=str(e))
    # prefill chunks interleave with decode iterations: a fresh prompt
    # waits ~one decode step per chunk on top of its own chunk compute
    chunks = math.ceil(envelope.mean_prompt / r.prefill_chunk)
    ttft_est = 2.0 * chunks * r.step_seconds
    tpot_est = r.step_seconds
    feasible, reason = True, ""
    if tpot_est > slo.tpot_s:
        feasible, reason = False, (f"modeled TPOT {tpot_est:.4f}s exceeds "
                                   f"SLO {slo.tpot_s}s")
    elif ttft_est > slo.ttft_s:
        feasible, reason = False, (f"modeled TTFT {ttft_est:.3f}s exceeds "
                                   f"SLO {slo.ttft_s}s")
    demand = envelope.peak_decode_tokens_per_s * headroom
    per = r.tokens_per_s_ceiling
    n = max(1, math.ceil(demand / per))
    power = replica_power_w(spec, r.tp)
    return FleetPlan(
        spec=spec, resolved=r, replicas=n, feasible=feasible, reason=reason,
        per_replica_tokens_per_s=per, fleet_tokens_per_s=per * n,
        ttft_est_s=ttft_est, tpot_est_s=tpot_est,
        power_w=power * n, die_mm2=replica_die_mm2(spec, r.tp) * n,
        energy_j_per_token=power / per)


def plan_fleet(model, envelope: TrafficEnvelope, slo: SLO,
               candidates: list[DeploymentSpec], *, headroom: float = 1.25,
               objective: str = "cost") -> tuple[FleetPlan, list[FleetPlan]]:
    """Price every candidate, return (best feasible, all plans).

    objective "cost" minimizes fleet die-mm² (power breaks ties);
    "energy" minimizes joules per token.
    """
    plans = [plan_candidate(model, c, envelope, slo, headroom=headroom)
             for c in candidates]
    feasible = [p for p in plans if p.feasible]
    if not feasible:
        raise DeploymentError(
            "no candidate meets the SLO: "
            + "; ".join(f"{p.name}: {p.reason}" for p in plans))
    if objective == "energy":
        key = lambda p: (p.energy_j_per_token, p.die_mm2)
    else:
        key = lambda p: (p.die_mm2, p.power_w)
    best = min(feasible, key=key)
    return best, plans


# ---------------------------------------------------------------------------
# disaggregated planning: phase-specialized SKUs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DisaggFleetPlan:
    """One (prefill SKU, decode SKU) pairing, priced per phase.

    Prefill replicas are sized against peak **prompt** tokens/s on the
    prefill-phase resolve (compute ceiling); decode replicas against
    peak **decode** tokens/s on the decode-phase resolve (bandwidth
    ceiling).  TTFT is chunk compute plus the KV handoff; TPOT is a pure
    decode step — no chunk interleave, which is the modeled win over
    ``plan_candidate``'s colocated ``2.0 * chunks`` interference term.
    """
    prefill: FleetPlan
    decode: FleetPlan
    feasible: bool
    reason: str = ""
    ttft_est_s: float = 0.0
    tpot_est_s: float = 0.0
    handoff_s: float = 0.0
    prompt_demand_tokens_per_s: float = 0.0
    decode_demand_tokens_per_s: float = 0.0

    @property
    def name(self) -> str:
        return f"{self.prefill.name} + {self.decode.name}"

    @property
    def power_w(self) -> float:
        return self.prefill.power_w + self.decode.power_w

    @property
    def die_mm2(self) -> float:
        return self.prefill.die_mm2 + self.decode.die_mm2

    @property
    def energy_j_per_token(self) -> float:
        """Joules per output token at the demand point: each tier burns
        TDP times its utilization (its demand over its fleet ceiling),
        charged to the decode-output stream.  For a colocated plan the
        same convention collapses to ``plan_candidate``'s
        ``power / per_replica_tokens_per_s``, so the numbers compare."""
        util_p = min(self.prompt_demand_tokens_per_s
                     / max(self.prefill.fleet_tokens_per_s, 1e-9), 1.0)
        util_d = min(self.decode_demand_tokens_per_s
                     / max(self.decode.fleet_tokens_per_s, 1e-9), 1.0)
        burn = self.prefill.power_w * util_p + self.decode.power_w * util_d
        return burn / max(self.decode_demand_tokens_per_s, 1e-9)

    def as_dict(self) -> dict:
        return {"prefill_sku": self.prefill.name,
                "decode_sku": self.decode.name,
                "prefill_replicas": self.prefill.replicas,
                "decode_replicas": self.decode.replicas,
                "feasible": self.feasible, "reason": self.reason,
                "ttft_est_s": round(self.ttft_est_s, 4),
                "tpot_est_s": round(self.tpot_est_s, 5),
                "handoff_s": round(self.handoff_s, 5),
                "power_w": round(self.power_w, 1),
                "die_mm2": round(self.die_mm2, 1),
                "energy_j_per_token": round(self.energy_j_per_token, 6)}


def plan_disagg_candidate(model, prefill_spec: DeploymentSpec,
                          decode_spec: DeploymentSpec,
                          envelope: TrafficEnvelope, slo: SLO, *,
                          headroom: float = 1.25,
                          handoff_gbs: float = 64.0) -> DisaggFleetPlan:
    def infeasible(reason, rp=None, rd=None):
        empty = lambda s, r: FleetPlan(spec=s, resolved=r, replicas=0,
                                       feasible=False, reason=reason)
        return DisaggFleetPlan(prefill=empty(prefill_spec, rp),
                               decode=empty(decode_spec, rd),
                               feasible=False, reason=reason)

    try:
        rp = prefill_spec.resolve(model, phase="prefill")
    except (DeploymentError, NotImplementedError) as e:
        return infeasible(f"prefill: {e}")
    try:
        rd = decode_spec.resolve(model, phase="decode")
    except (DeploymentError, NotImplementedError) as e:
        return infeasible(f"decode: {e}", rp)
    chunks = math.ceil(envelope.mean_prompt / rp.prefill_chunk)
    handoff_s = envelope.mean_prompt * rd.kv_token_bytes / (handoff_gbs * 1e9)
    ttft_est = chunks * rp.step_seconds + handoff_s
    tpot_est = rd.step_seconds
    feasible, reason = True, ""
    if tpot_est > slo.tpot_s:
        feasible, reason = False, (f"modeled TPOT {tpot_est:.4f}s exceeds "
                                   f"SLO {slo.tpot_s}s")
    elif ttft_est > slo.ttft_s:
        feasible, reason = False, (f"modeled TTFT {ttft_est:.3f}s exceeds "
                                   f"SLO {slo.ttft_s}s")
    prompt_demand = envelope.peak_rate * envelope.mean_prompt * headroom
    per_p = rp.tokens_per_s_ceiling
    n_p = max(1, math.ceil(prompt_demand / per_p))
    decode_demand = envelope.peak_decode_tokens_per_s * headroom
    per_d = rd.tokens_per_s_ceiling
    n_d = max(1, math.ceil(decode_demand / per_d))
    pw_p = replica_power_w(prefill_spec, rp.tp)
    pw_d = replica_power_w(decode_spec, rd.tp)
    pre = FleetPlan(
        spec=prefill_spec, resolved=rp, replicas=n_p, feasible=feasible,
        reason=reason, per_replica_tokens_per_s=per_p,
        fleet_tokens_per_s=per_p * n_p, ttft_est_s=ttft_est,
        power_w=pw_p * n_p, die_mm2=replica_die_mm2(prefill_spec, rp.tp) * n_p,
        energy_j_per_token=pw_p / per_p)
    dec = FleetPlan(
        spec=decode_spec, resolved=rd, replicas=n_d, feasible=feasible,
        reason=reason, per_replica_tokens_per_s=per_d,
        fleet_tokens_per_s=per_d * n_d, tpot_est_s=tpot_est,
        power_w=pw_d * n_d, die_mm2=replica_die_mm2(decode_spec, rd.tp) * n_d,
        energy_j_per_token=pw_d / per_d)
    return DisaggFleetPlan(prefill=pre, decode=dec, feasible=feasible,
                           reason=reason, ttft_est_s=ttft_est,
                           tpot_est_s=tpot_est, handoff_s=handoff_s,
                           prompt_demand_tokens_per_s=prompt_demand,
                           decode_demand_tokens_per_s=decode_demand)


def plan_disagg_fleet(model, envelope: TrafficEnvelope, slo: SLO,
                      prefill_candidates: list[DeploymentSpec],
                      decode_candidates: list[DeploymentSpec], *,
                      headroom: float = 1.25, handoff_gbs: float = 64.0,
                      objective: str = "cost"
                      ) -> tuple[DisaggFleetPlan, list[DisaggFleetPlan]]:
    """Cross the phase candidate lists, price each pairing, return
    (best feasible, all).  Pass ``default_candidates`` for both lists
    and the planner discovers the phase-specialized split itself —
    compute-dense SKUs win the prefill tier, bandwidth-dense HBM-CO
    stacks the decode tier.  Objectives match :func:`plan_fleet`.
    """
    plans = [plan_disagg_candidate(model, p, d, envelope, slo,
                                   headroom=headroom,
                                   handoff_gbs=handoff_gbs)
             for p in prefill_candidates for d in decode_candidates]
    feasible = [p for p in plans if p.feasible]
    if not feasible:
        raise DeploymentError(
            "no disaggregated pairing meets the SLO: "
            + "; ".join(f"{p.name}: {p.reason}" for p in plans[:8]))
    if objective == "energy":
        key = lambda p: (p.energy_j_per_token, p.die_mm2)
    else:
        key = lambda p: (p.die_mm2, p.power_w)
    best = min(feasible, key=key)
    return best, plans


# ---------------------------------------------------------------------------
# closed loop
# ---------------------------------------------------------------------------


class ReactiveAutoscaler:
    """Queue-pressure scaler the simulator polls every ``interval_s``.

    Scale up when mean queue depth per slot crosses ``high`` or requests
    were shed since the last tick; scale down when it falls under
    ``low``.  Changes are bounded to ``max_step`` replicas per tick so
    the loop stays stable under bursty arrivals.
    """

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 64,
                 interval_s: float = 1.0, low: float = 0.35,
                 high: float = 0.9, max_step: int = 2):
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.interval_s = interval_s
        self.low = low
        self.high = high
        self.max_step = max_step
        self.decisions: list[tuple[float, int]] = []
        self._last_shed = 0

    def desired(self, now: float, sim) -> int:
        active = [r for r in sim.replicas if not r.draining]
        n = len(active)
        load = float(np.mean([r.load() for r in active])) if active else 1e9
        shed = getattr(sim.router, "shed", 0)
        shed_delta = shed - self._last_shed
        self._last_shed = shed
        want = n
        if shed_delta > 0 or load > self.high:
            want = n + min(self.max_step,
                           max(1, math.ceil(n * (load - self.high))))
        elif load < self.low and n > self.min_replicas:
            want = n - 1
        want = int(np.clip(want, self.min_replicas, self.max_replicas))
        if want != n:
            self.decisions.append((now, want))
        return want
