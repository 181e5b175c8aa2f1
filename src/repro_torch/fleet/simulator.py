"""Discrete-event fleet simulator over calibrated engine replicas.

The per-replica service model mirrors one ``ContinuousServeEngine``
iteration exactly as ``engine.step()`` executes it: admit from the
queue into free slots, advance every prefilling request by one chunk,
run one fused decode step over the decoding slots.  An iteration's cost
comes from a :class:`LatencyTable` — either **calibrated** by timing a
real engine (:func:`calibrate`) or derived analytically from a
``ResolvedDeployment``'s memory roofline
(:meth:`LatencyTable.from_roofline`) — so CI can push fleet-scale
traffic through the simulator in seconds and still speak in measured
units.

Scale comes from *jump batching*: when a replica's composition (who is
prefilling, who is decoding) cannot change for the next ``k``
iterations, the simulator advances all ``k`` at once — one heap event
per composition change, not per token.  ``k`` is capped by the nearest
prefill completion, the nearest decode finish, a context-refresh bound
(decode cost drifts as contexts grow), and a small admission-poll bound
while free slots remain, so arrivals are picked up promptly.

:func:`cross_check` closes the loop: calibrate a table from a real
engine, replay the same seeded trace through the simulator and the
engine, and compare throughput — the tolerance band every CI gate is
stated against.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import time
from collections import OrderedDict, deque
from typing import Sequence

import numpy as np

from repro_torch.fleet import traffic as tr
from repro_torch.fleet.router import SLO, PrefixAffinityRouter, RouteDecision

# ---------------------------------------------------------------------------
# latency table
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LatencyTable:
    """Per-iteration engine costs keyed by (decode batch, context).

    ``decode_s[i, j]`` is one fused decode-step latency at
    ``batches[i]`` decoding slots and ``contexts[j]`` tokens of context;
    ``prefill_chunk_s`` is the cost of advancing one prefilling request
    by one chunk (per request — the engine batches rows, the table
    prices them linearly).  Lookup clamps + bilinearly interpolates, so
    any (b, ctx) inside or outside the grid resolves.
    """
    batches: tuple
    contexts: tuple
    decode_s: np.ndarray            # (len(batches), len(contexts))
    prefill_chunk_s: float
    prefill_chunk: int
    overhead_s: float = 0.0         # host bookkeeping per iteration

    def __post_init__(self):
        self.decode_s = np.asarray(self.decode_s, np.float64)
        if self.decode_s.shape != (len(self.batches), len(self.contexts)):
            raise ValueError("decode_s grid does not match batches/contexts")

    @staticmethod
    def _frac(grid: Sequence[float], x: float) -> tuple[int, int, float]:
        """Clamped linear-interpolation coordinates of x on a sorted grid."""
        if x <= grid[0] or len(grid) == 1:
            return 0, 0, 0.0
        if x >= grid[-1]:
            return len(grid) - 1, len(grid) - 1, 0.0
        import bisect
        hi = bisect.bisect_right(grid, x)
        lo = hi - 1
        return lo, hi, (x - grid[lo]) / (grid[hi] - grid[lo])

    def decode_step_s(self, batch: float, ctx: float) -> float:
        b0, b1, fb = self._frac(self.batches, batch)
        c0, c1, fc = self._frac(self.contexts, ctx)
        d = self.decode_s
        lo = d[b0, c0] * (1 - fc) + d[b0, c1] * fc
        hi = d[b1, c0] * (1 - fc) + d[b1, c1] * fc
        return float(lo * (1 - fb) + hi * fb)

    def iteration_s(self, n_prefill: int, n_decode: int, ctx: float) -> float:
        """One engine iteration at this composition (see ``step()``)."""
        s = self.overhead_s
        if n_prefill:
            s += self.prefill_chunk_s * n_prefill
        if n_decode:
            s += self.decode_step_s(n_decode, ctx)
        return s

    def as_dict(self) -> dict:
        return {"batches": list(self.batches),
                "contexts": list(self.contexts),
                "decode_s": self.decode_s.tolist(),
                "prefill_chunk_s": self.prefill_chunk_s,
                "prefill_chunk": self.prefill_chunk,
                "overhead_s": self.overhead_s}

    @classmethod
    def from_dict(cls, d: dict) -> "LatencyTable":
        return cls(batches=tuple(d["batches"]),
                   contexts=tuple(d["contexts"]),
                   decode_s=np.asarray(d["decode_s"]),
                   prefill_chunk_s=d["prefill_chunk_s"],
                   prefill_chunk=d["prefill_chunk"],
                   overhead_s=d.get("overhead_s", 0.0))

    def save(self, path: str) -> None:
        """Persist to JSON (``experiments/calibration/`` convention)."""
        import json
        import os
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "LatencyTable":
        import json
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_roofline(cls, resolved, *, batches=(1, 8, 32),
                      contexts=(64, 512, 2048)) -> "LatencyTable":
        """Analytic table from a ``ResolvedDeployment`` memory roofline.

        A decode step streams the active weights once plus every decoding
        slot's KV up to its context; a prefill chunk is priced at the
        same bandwidth over the chunk's KV writes (prefill is really
        compute-bound — this floor is deliberately optimistic, the
        calibrated path is the accurate one).  The active-weight stream
        is recovered from the deployment's own roofline:
        ``step_seconds = (active + slots*kv*ctx) / bw``.
        """
        bw = resolved.device.decode_bw
        kv = resolved.kv_token_bytes
        act = max(resolved.step_seconds * bw
                  - resolved.num_slots * kv * resolved.mean_context, 0.0)
        grid = np.empty((len(batches), len(contexts)))
        for i, b in enumerate(batches):
            for j, c in enumerate(contexts):
                grid[i, j] = (act + b * kv * c) / bw
        chunk_s = resolved.prefill_chunk * kv / bw
        return cls(batches=tuple(batches), contexts=tuple(contexts),
                   decode_s=grid, prefill_chunk_s=float(chunk_s),
                   prefill_chunk=int(resolved.prefill_chunk))


def calibrate(eng, *, batches=None, contexts=None, n_steps: int = 6,
              seed: int = 0) -> LatencyTable:
    """Time a real ``ContinuousServeEngine`` into a :class:`LatencyTable`.

    For each grid point the engine serves ``b`` fresh prompts of ``ctx``
    tokens: the prefill phase times chunk advancement, then ``n_steps``
    pure decode iterations are timed at that exact composition.  The grid
    is driven twice — the first pass exists only to compile every
    bucketed prefill/decode shape, the second pass is the one measured —
    so compile time never leaks into the table.  The engine is reset
    (not rebuilt) between points and is left reset afterwards.
    """
    from repro_torch.runtime.scheduler import Request
    from repro_torch.runtime.sampling import SamplingParams

    slots = eng.num_slots
    batches = tuple(batches) if batches else tuple(sorted(
        {1, max(1, slots // 2), slots}))
    max_ctx = eng.max_len - n_steps - 2
    contexts = tuple(contexts) if contexts else tuple(sorted(
        {eng.page_size, max(eng.page_size, max_ctx // 2)}))
    rng = np.random.default_rng(seed)
    grid = np.empty((len(batches), len(contexts)))
    chunk_times: list[float] = []

    def mk(b: int, plen: int) -> list[Request]:
        return [Request(rid=i, prompt=rng.integers(
                            0, eng.model.cfg.vocab_size, size=plen,
                            dtype=np.int64).astype(np.int32),
                        max_new_tokens=n_steps + 2,
                        sampling=SamplingParams(max_tokens=n_steps + 2))
                for i in range(b)]

    if eng.has_unfinished():
        raise RuntimeError("calibrate() needs an idle engine")
    for measured in (False, True):
        for i, b in enumerate(batches):
            for j, ctx in enumerate(contexts):
                plen = max(int(ctx) - 1, 2)
                eng.reset()
                for r in mk(b, plen):
                    eng.add_request(r)
                # drive + time the prefill phase: every step advances
                # each prefilling request by one chunk (one bucketed
                # batch), so per-row cost is measured/row-count
                while eng._sched.prefilling() or eng._sched.waiting:
                    npre = len(eng._sched.prefilling()) or b
                    t0 = time.perf_counter()
                    eng.step()
                    if measured:
                        chunk_times.append(
                            (time.perf_counter() - t0) / npre)
                # timed decode steps at exactly (b, ctx)
                ts = []
                for _ in range(n_steps):
                    t0 = time.perf_counter()
                    eng.step()
                    ts.append(time.perf_counter() - t0)
                if measured:
                    grid[i, j] = float(np.median(ts))
                while eng.has_unfinished():   # drain the margin tokens
                    eng.step()
                eng.reset()
    chunk_s = float(np.median(chunk_times)) if chunk_times else 0.0
    return LatencyTable(batches=batches, contexts=contexts, decode_s=grid,
                        prefill_chunk_s=chunk_s,
                        prefill_chunk=eng.prefill_chunk)


# ---------------------------------------------------------------------------
# simulated replica
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """Capacity + service model of one simulated engine replica."""
    latency: LatencyTable
    num_slots: int = 8
    max_queue: int = 16             # admitted-but-unscheduled bound
    page_size: int = 16
    prefix_blocks: int = 64         # prefix-index capacity (LRU, blocks)
    ctx_refresh: int = 64           # max iterations per jump
    admit_poll: int = 4             # jump cap while slots are free
    power_w: float | None = None    # TDP for energy accounting
    energy_j_per_token: float | None = None   # modeled override


class SimRequest:
    """Mutable per-request simulation state."""
    __slots__ = ("req", "chain", "arrival", "admit_t", "first_tok_t",
                 "finish_t", "replica", "hit_tokens", "remaining_prefill",
                 "emitted", "retries", "shed_reason")

    def __init__(self, req: tr.FleetRequest, chain: tuple):
        self.req = req
        self.chain = chain
        self.arrival = req.arrival
        self.admit_t = None
        self.first_tok_t = None
        self.finish_t = None
        self.replica = None
        self.hit_tokens = 0
        self.remaining_prefill = req.prompt_len
        self.emitted = 0
        self.retries = 0
        self.shed_reason = None

    @property
    def ttft(self):
        if self.first_tok_t is None:
            return None
        return self.first_tok_t - self.arrival

    @property
    def tpot(self):
        if self.finish_t is None or self.first_tok_t is None \
                or self.req.output_len <= 1:
            return None
        return (self.finish_t - self.first_tok_t) / (self.req.output_len - 1)


class SimReplica:
    """One engine replica: slots, queue, prefix index, iteration plan."""

    def __init__(self, spec: ReplicaSpec):
        self.spec = spec
        self.queue: deque[SimRequest] = deque()
        self.running: list[SimRequest] = []
        self.prefix: OrderedDict = OrderedDict()    # block hash -> None
        self.t = 0.0                # simulated up to here
        self.plan = None            # (t_end, k, iter_s) when a jump is active
        self.busy_s = 0.0
        self.iterations = 0
        self.tokens_out = 0
        self.draining = False

    # ---- ReplicaView protocol (router-facing) ----
    def queue_depth(self) -> int:
        return len(self.running) + len(self.queue)

    def load(self) -> float:
        return self.queue_depth() / max(self.spec.num_slots, 1)

    def saturated(self) -> bool:
        return self.draining or len(self.queue) >= self.spec.max_queue

    def match_tokens(self, chain: Sequence[bytes]) -> int:
        n = 0
        for h in chain:
            if h not in self.prefix:
                break
            self.prefix.move_to_end(h)
            n += 1
        return n * self.spec.page_size

    def _mean_ctx(self) -> float:
        dec = [r for r in self.running if r.remaining_prefill == 0]
        if not dec:
            return float(self.spec.latency.contexts[0])
        return float(np.mean([r.req.prompt_len + r.emitted for r in dec]))

    def predicted_ttft(self, now: float, prompt_len: int,
                       hit_tokens: int) -> float:
        lt = self.spec.latency
        chunk = lt.prefill_chunk
        own = -(-(max(prompt_len - hit_tokens, 1)) // chunk)
        ahead = sum(-(-r.remaining_prefill // chunk)
                    for r in self.running if r.remaining_prefill > 0)
        ahead += sum(-(-r.req.prompt_len // chunk) for r in self.queue)
        n_dec = sum(1 for r in self.running if r.remaining_prefill == 0)
        iter_est = lt.iteration_s(1, max(n_dec, 1), self._mean_ctx())
        # queue overflow waits for running requests to finish and free slots
        overflow = max(0, self.queue_depth() + 1 - self.spec.num_slots)
        slot_wait = 0.0
        if overflow:
            rem = sorted(max(r.req.output_len - r.emitted, 1)
                         for r in self.running)
            mean_rem = float(np.mean(rem)) if rem else 1.0
            slot_wait = mean_rem * iter_est * \
                (overflow / max(self.spec.num_slots, 1) + 0.5)
        return slot_wait + (own + ahead) * iter_est

    def predicted_tpot(self) -> float:
        lt = self.spec.latency
        b = min(self.spec.num_slots, self.queue_depth() + 1)
        s = lt.decode_step_s(max(b, 1), self._mean_ctx()) + lt.overhead_s
        if any(r.remaining_prefill > 0 for r in self.running) or self.queue:
            s += lt.prefill_chunk_s       # interleaved chunks slow decode
        return s

    # ---- admission into slots (mirrors Scheduler.admit) ----
    def _admit(self, now: float):
        while self.queue and len(self.running) < self.spec.num_slots:
            sr = self.queue.popleft()
            hit = min(self.match_tokens(sr.chain),
                      max(sr.req.prompt_len - 1, 0))
            sr.hit_tokens = hit
            sr.remaining_prefill = sr.req.prompt_len - hit
            sr.admit_t = now
            # the request's own blocks become resident (LRU, bounded)
            for h in sr.chain:
                self.prefix[h] = None
                self.prefix.move_to_end(h)
            while len(self.prefix) > self.spec.prefix_blocks:
                self.prefix.popitem(last=False)
            self.running.append(sr)


# ---------------------------------------------------------------------------
# fleet stats
# ---------------------------------------------------------------------------


def _quantiles(vals: Sequence[float]) -> dict | None:
    ts = sorted(vals)
    if not ts:
        return None
    def pct(q):
        return ts[min(len(ts) - 1, int(len(ts) * q))]
    return {"p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99),
            "mean": sum(ts) / len(ts)}


@dataclasses.dataclass
class FleetStats:
    """Outcome of one simulated run."""
    served: list                      # finished SimRequests
    shed: list                        # SimRequests rejected at the door
    duration: float
    replicas: int
    busy_s: list
    iterations: int
    retries: int
    energy_j: float | None
    handoffs: int = 0                 # disaggregated runs only
    handoff_bytes: float = 0.0
    handoff_shared_tokens: int = 0
    prefill_replicas: int = 0

    @property
    def total_tokens(self) -> int:
        return sum(s.req.output_len for s in self.served)

    @property
    def tokens_per_s(self) -> float:
        return self.total_tokens / max(self.duration, 1e-9)

    def ttft_quantiles(self) -> dict | None:
        return _quantiles([s.ttft for s in self.served
                           if s.ttft is not None])

    def tpot_quantiles(self) -> dict | None:
        return _quantiles([s.tpot for s in self.served
                           if s.tpot is not None])

    def slo_attainment(self, slo: SLO) -> float:
        """Fraction of ALL arrivals (served + shed) that met the SLO."""
        n = len(self.served) + len(self.shed)
        if n == 0:
            return 0.0
        met = sum(1 for s in self.served if slo.met(s.ttft, s.tpot))
        return met / n

    def goodput_tokens_per_s(self, slo: SLO) -> float:
        """Output tokens of SLO-met requests per second — the metric the
        router is judged on (shed + SLO-missed tokens don't count)."""
        good = sum(s.req.output_len for s in self.served
                   if slo.met(s.ttft, s.tpot))
        return good / max(self.duration, 1e-9)

    @property
    def utilization(self) -> list:
        return [b / max(self.duration, 1e-9) for b in self.busy_s]

    def energy_j_per_token(self) -> float | None:
        if self.energy_j is None:
            return None
        return self.energy_j / max(self.total_tokens, 1)

    def summary(self, slo: SLO | None = None) -> dict:
        out = {
            "requests": len(self.served) + len(self.shed),
            "served": len(self.served),
            "shed": len(self.shed),
            "retries": self.retries,
            "duration_s": round(self.duration, 4),
            "replicas": self.replicas,
            "tokens_per_s": round(self.tokens_per_s, 2),
            "iterations": self.iterations,
            "mean_utilization": round(float(np.mean(self.utilization)), 4)
            if self.busy_s else 0.0,
            "ttft": self.ttft_quantiles(),
            "tpot": self.tpot_quantiles(),
        }
        if slo is not None:
            out["slo_attainment"] = round(self.slo_attainment(slo), 4)
            out["goodput_tokens_per_s"] = round(
                self.goodput_tokens_per_s(slo), 2)
        if self.prefill_replicas:
            out["prefill_replicas"] = self.prefill_replicas
            out["handoffs"] = self.handoffs
            out["handoff_bytes"] = round(self.handoff_bytes, 1)
            out["handoff_shared_tokens"] = self.handoff_shared_tokens
        if self.energy_j is not None:
            out["energy_j"] = round(self.energy_j, 2)
            out["energy_j_per_token"] = round(self.energy_j_per_token(), 6)
        return out


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

_ARRIVE, _WAKE, _SCALE = 0, 1, 2


class FleetSimulator:
    """Route a trace over simulated replicas and collect fleet stats.

    Events are (time, seq, kind, payload) on one heap; replicas advance
    by composition-constant iteration jumps (module docstring).  An
    optional :class:`~repro_torch.fleet.autoscaler.ReactiveAutoscaler` is
    polled on a fixed interval and may add replicas or drain existing
    ones mid-run.
    """

    def __init__(self, spec: ReplicaSpec, n_replicas: int, router, *,
                 autoscaler=None):
        self.spec = spec
        self.router = router
        self.replicas = [SimReplica(spec) for _ in range(n_replicas)]
        self.autoscaler = autoscaler
        self._heap: list = []
        self._seq = 0
        self._retries = 0

    def _push(self, t: float, kind: int, payload):
        heapq.heappush(self._heap, (t, self._seq, kind, payload))
        self._seq += 1

    def run(self, trace: tr.Trace) -> FleetStats:
        chains = tr.tenant_chains(trace, self.spec.page_size)
        served: list[SimRequest] = []
        shed: list[SimRequest] = []
        for r in trace.requests:
            self._push(r.arrival, _ARRIVE, SimRequest(r, chains[r.tenant]))
        if self.autoscaler is not None:
            self._push(self.autoscaler.interval_s, _SCALE, None)
        t_end = 0.0
        while self._heap:
            t, _, kind, payload = heapq.heappop(self._heap)
            t_end = max(t_end, t)
            if kind == _ARRIVE:
                self._route(t, payload, shed)
            elif kind == _WAKE:
                rep = payload
                if rep.plan is not None and rep.plan[0] <= t + 1e-12:
                    self._apply_jump(t, rep, served)
                    self._plan(t, rep)
            else:   # _SCALE
                if any(h[2] != _SCALE for h in self._heap):
                    self._autoscale(t)
                    self._push(t + self.autoscaler.interval_s, _SCALE, None)
        duration = max(t_end, trace.duration)
        active = [r for r in self.replicas]
        return FleetStats(
            served=served, shed=shed, duration=duration,
            replicas=len(active), busy_s=[r.busy_s for r in active],
            iterations=sum(r.iterations for r in active),
            retries=self._retries,
            energy_j=self._energy(duration))

    def _energy(self, duration: float) -> float | None:
        sp = self.spec
        if sp.energy_j_per_token is not None:
            toks = sum(r.tokens_out for r in self.replicas)
            return sp.energy_j_per_token * toks
        if sp.power_w is not None:
            return sp.power_w * sum(r.busy_s for r in self.replicas)
        return None

    # ---- routing ----
    def _route(self, now: float, sr: SimRequest, shed: list):
        cand = [r for r in self.replicas if not r.draining] or self.replicas
        d: RouteDecision = self.router.route(
            now, sr.req.prompt_len, sr.chain, cand, retries=sr.retries)
        if d.action == "admit":
            rep = cand[d.replica]
            sr.replica = self.replicas.index(rep)
            rep.queue.append(sr)
            if rep.plan is None:
                self._plan(now, rep)
        elif d.action == "retry":
            sr.retries += 1
            self._retries += 1
            self._push(now + d.delay_s, _ARRIVE, sr)
        else:
            sr.shed_reason = d.reason
            shed.append(sr)

    # ---- the iteration-jump engine model ----
    def _plan(self, now: float, rep: SimReplica):
        rep.plan = None
        rep.t = max(rep.t, now)
        rep._admit(rep.t)
        if not rep.running:
            return
        lt = rep.spec.latency
        chunk = lt.prefill_chunk
        pre = [r for r in rep.running if r.remaining_prefill > 0]
        dec = [r for r in rep.running if r.remaining_prefill == 0]
        k = rep.spec.ctx_refresh
        if pre:
            k = min(k, min(-(-r.remaining_prefill // chunk) for r in pre))
        if dec:
            k = min(k, min(r.req.output_len - r.emitted for r in dec))
        if len(rep.running) < rep.spec.num_slots:
            k = min(k, rep.spec.admit_poll)
        k = max(k, 1)
        ctx = rep._mean_ctx() + k / 2.0
        iter_s = lt.iteration_s(len(pre), len(dec), ctx)
        rep.plan = (rep.t + k * iter_s, k, iter_s)
        self._push(rep.plan[0], _WAKE, rep)

    def _apply_jump(self, now: float, rep: SimReplica, served: list):
        _, k, iter_s = rep.plan
        rep.plan = None
        rep.t = now
        rep.busy_s += k * iter_s
        rep.iterations += k
        finished = []
        for r in rep.running:
            if r.remaining_prefill > 0:
                chunk = rep.spec.latency.prefill_chunk
                r.remaining_prefill = max(
                    r.remaining_prefill - k * chunk, 0)
                if r.remaining_prefill == 0:
                    # the final chunk's step samples the first token
                    r.first_tok_t = now
                    r.emitted = 1
                    rep.tokens_out += 1
                    if r.emitted >= r.req.output_len:
                        r.finish_t = now
                        finished.append(r)
            else:
                r.emitted += k
                rep.tokens_out += k
                if r.emitted >= r.req.output_len:
                    r.finish_t = now
                    finished.append(r)
        for r in finished:
            rep.running.remove(r)
            served.append(r)

    # ---- autoscaling ----
    def _autoscale(self, now: float):
        desired = self.autoscaler.desired(now, self)
        active = [r for r in self.replicas if not r.draining]
        if desired > len(active):
            for _ in range(desired - len(active)):
                self.replicas.append(SimReplica(self.spec))
        elif desired < len(active):
            # drain the least-loaded replicas; they stop taking traffic
            # and disappear from routing once empty.  A victim's prefix
            # heat is adopted into the router's placement map pointing at
            # the coldest survivor, so tenant affinity survives the
            # scale-down instead of scattering to cold replicas.
            victims = sorted(active, key=lambda r: r.queue_depth())
            n_drop = len(active) - desired
            survivors = [r for r in active if r not in victims[:n_drop]]
            for r in victims[:n_drop]:
                r.draining = True
                if survivors and r.prefix and \
                        hasattr(self.router, "adopt_placement"):
                    target = min(survivors, key=lambda s: s.queue_depth())
                    self.router.adopt_placement(list(r.prefix), target)


# ---------------------------------------------------------------------------
# disaggregated fleet: prefill-class + decode-class replicas
# ---------------------------------------------------------------------------

_HANDOFF = 3


class _DecodeReplica(SimReplica):
    """Decode-class replica: admission installs the transferred chain
    into the prefix index (the handoff moved the pages here) but never
    re-runs prefill — ``remaining_prefill`` arrives already at zero."""

    def _admit(self, now: float):
        while self.queue and len(self.running) < self.spec.num_slots:
            sr = self.queue.popleft()
            if sr.admit_t is None:
                sr.admit_t = now
            for h in sr.chain:
                self.prefix[h] = None
                self.prefix.move_to_end(h)
            while len(self.prefix) > self.spec.prefix_blocks:
                self.prefix.popitem(last=False)
            self.running.append(sr)


def disagg_replica_specs(resolved_prefill, resolved_decode, *,
                         prefix_blocks: int = 64,
                         max_queue: int | None = None
                         ) -> tuple[ReplicaSpec, ReplicaSpec]:
    """Two :class:`ReplicaSpec` classes from phase-resolved deployments.

    The prefill class prices chunk advancement off the prefill-phase
    roofline (one step advances every slot by one chunk, so per-row cost
    is ``step_seconds / num_slots``) and carries a negligible decode
    grid; the decode class is the decode-phase memory roofline with
    ``prefill_chunk_s = 0`` — decode steps never interleave with chunks,
    which is exactly the interference disaggregation removes.
    """
    dt = LatencyTable.from_roofline(resolved_decode)
    dt = dataclasses.replace(dt, prefill_chunk_s=0.0)
    chunk_s = resolved_prefill.step_seconds \
        / max(resolved_prefill.num_slots, 1)
    pt = LatencyTable(
        batches=dt.batches, contexts=dt.contexts,
        decode_s=np.full_like(np.asarray(dt.decode_s), 1e-9),
        prefill_chunk_s=float(chunk_s),
        prefill_chunk=int(resolved_prefill.prefill_chunk))
    mk = lambda lat, res: ReplicaSpec(
        latency=lat, num_slots=res.num_slots,
        max_queue=max_queue if max_queue is not None else 2 * res.num_slots,
        page_size=res.page_size, prefix_blocks=prefix_blocks)
    return mk(pt, resolved_prefill), mk(dt, resolved_decode)


class DisaggFleetSimulator(FleetSimulator):
    """Fleet of prefill-class and decode-class replicas with KV handoff.

    Arrivals route to prefill replicas (prefix affinity applies there —
    a hit skips chunk compute).  When a request's prefill completes, a
    decode replica is chosen **KV-aware** via the router's scoring over
    the decode class: a replica already holding leading blocks of the
    chain (from an earlier handoff of the same tenant) both scores
    higher and shrinks the transfer.  The handoff itself costs
    ``handoff_latency_s + moved_tokens * kv_token_bytes / bandwidth``
    before the request joins the decode replica's queue.  TTFT lands at
    prefill completion (the final chunk samples the first token, as in
    the real engine); TPOT absorbs the transfer delay.

    ``self.replicas`` is the decode class, so the inherited autoscaler
    path (including drain-heat adoption) scales decode capacity.
    """

    def __init__(self, prefill_spec: ReplicaSpec, n_prefill: int,
                 decode_spec: ReplicaSpec, n_decode: int, router, *,
                 kv_token_bytes: float, handoff_gbs: float = 64.0,
                 handoff_latency_s: float = 0.0005, autoscaler=None,
                 prefill_power_w: float | None = None):
        super().__init__(decode_spec, 0, router, autoscaler=autoscaler)
        self.replicas = [_DecodeReplica(decode_spec)
                         for _ in range(n_decode)]
        self.prefill_spec = prefill_spec
        self.prefill_replicas = [SimReplica(prefill_spec)
                                 for _ in range(n_prefill)]
        self.kv_token_bytes = float(kv_token_bytes)
        self.handoff_gbs = float(handoff_gbs)
        self.handoff_latency_s = float(handoff_latency_s)
        self.prefill_power_w = prefill_power_w
        self.handoffs = 0
        self.handoff_bytes = 0.0
        self.handoff_shared_tokens = 0

    def run(self, trace: tr.Trace) -> FleetStats:
        chains = tr.tenant_chains(trace, self.spec.page_size)
        served: list[SimRequest] = []
        shed: list[SimRequest] = []
        for r in trace.requests:
            self._push(r.arrival, _ARRIVE, SimRequest(r, chains[r.tenant]))
        if self.autoscaler is not None:
            self._push(self.autoscaler.interval_s, _SCALE, None)
        t_end = 0.0
        while self._heap:
            t, _, kind, payload = heapq.heappop(self._heap)
            t_end = max(t_end, t)
            if kind == _ARRIVE:
                self._route(t, payload, shed)
            elif kind == _WAKE:
                rep = payload
                if rep.plan is not None and rep.plan[0] <= t + 1e-12:
                    self._apply_jump(t, rep, served)
                    self._plan(t, rep)
            elif kind == _HANDOFF:
                sr, rep = payload
                rep.queue.append(sr)
                if rep.plan is None:
                    self._plan(t, rep)
            else:   # _SCALE
                if any(h[2] != _SCALE for h in self._heap):
                    self._autoscale(t)
                    self._push(t + self.autoscaler.interval_s, _SCALE, None)
        duration = max(t_end, trace.duration)
        reps = self.prefill_replicas + self.replicas
        return FleetStats(
            served=served, shed=shed, duration=duration,
            replicas=len(reps), busy_s=[r.busy_s for r in reps],
            iterations=sum(r.iterations for r in reps),
            retries=self._retries, energy_j=self._energy(duration),
            handoffs=self.handoffs, handoff_bytes=self.handoff_bytes,
            handoff_shared_tokens=self.handoff_shared_tokens,
            prefill_replicas=len(self.prefill_replicas))

    def _energy(self, duration: float) -> float | None:
        dec = None
        if self.spec.energy_j_per_token is not None:
            dec = self.spec.energy_j_per_token \
                * sum(r.tokens_out for r in self.replicas)
        elif self.spec.power_w is not None:
            dec = self.spec.power_w \
                * sum(r.busy_s for r in self.replicas)
        pre = None
        if self.prefill_power_w is not None:
            pre = self.prefill_power_w \
                * sum(r.busy_s for r in self.prefill_replicas)
        if dec is None and pre is None:
            return None
        return (dec or 0.0) + (pre or 0.0)

    # arrivals go to the prefill class
    def _route(self, now: float, sr: SimRequest, shed: list):
        cand = [r for r in self.prefill_replicas if not r.draining] \
            or self.prefill_replicas
        d: RouteDecision = self.router.route(
            now, sr.req.prompt_len, sr.chain, cand, retries=sr.retries)
        if d.action == "admit":
            rep = cand[d.replica]
            sr.replica = self.prefill_replicas.index(rep)
            rep.queue.append(sr)
            if rep.plan is None:
                self._plan(now, rep)
        elif d.action == "retry":
            sr.retries += 1
            self._retries += 1
            self._push(now + d.delay_s, _ARRIVE, sr)
        else:
            sr.shed_reason = d.reason
            shed.append(sr)

    def _apply_jump(self, now: float, rep, served: list):
        super()._apply_jump(now, rep, served)
        if isinstance(rep, _DecodeReplica):
            return
        # prefill class: completed prompts leave for the decode tier
        # instead of decoding in place (single-token outputs already
        # finished inside the jump, exactly like the real engine)
        done = [r for r in rep.running if r.remaining_prefill == 0]
        for r in done:
            rep.running.remove(r)
            self._dispatch(now, r)

    def _dispatch(self, now: float, sr: SimRequest):
        """KV-aware decode placement at prefill-completion time."""
        cand = [r for r in self.replicas if not r.draining] or self.replicas
        order = self.router.order(now, sr.req.prompt_len, sr.chain, cand)
        pick = next((e for e in order if not cand[e[2]].saturated()),
                    order[0])
        _, hit, i = pick
        rep = cand[i]
        sr.replica = self.replicas.index(rep)
        hit = min(hit, sr.req.prompt_len)
        moved = max(sr.req.prompt_len - hit, 0) * self.kv_token_bytes
        delay = self.handoff_latency_s + moved / (self.handoff_gbs * 1e9)
        self.handoffs += 1
        self.handoff_bytes += moved
        self.handoff_shared_tokens += hit
        self._push(now + delay, _HANDOFF, (sr, rep))


# ---------------------------------------------------------------------------
# cross-check against a real engine
# ---------------------------------------------------------------------------


def cross_check(eng, trace: tr.Trace, *, table: LatencyTable | None = None,
                time_scale: float = 1.0) -> dict:
    """Replay ``trace`` through a real engine AND the simulator; compare.

    The engine serves the trace's materialized prompts with its real
    arrival times (scaled by ``time_scale`` to keep wall time sane);
    the simulator runs one replica whose table was calibrated from that
    same engine.  The engine replay runs twice and the second run is the
    measured one — the trace's ragged prompt lengths hit bucketed
    prefill shapes the calibration grid never compiled, and a mid-replay
    compile would be charged to serving.  Returns measured vs simulated
    throughput and TTFT and their ratio — the number the CI tolerance
    band is asserted on.
    """
    from repro_torch.runtime.scheduler import Request
    from repro_torch.runtime.sampling import SamplingParams

    if table is None:
        table = calibrate(eng)

    def mk_requests() -> list[Request]:
        out = []
        for r in trace.requests:
            toks = tr.materialize_prompt(trace, r)
            out.append(Request(
                rid=r.rid, prompt=toks, max_new_tokens=r.output_len,
                arrival_time=r.arrival * time_scale,
                sampling=SamplingParams(max_tokens=r.output_len)))
        return out

    eng.run(mk_requests())          # warmup: compile every bucket shape
    stats = eng.run(mk_requests())
    real_tps = stats.total_tokens / max(stats.wall, 1e-9)
    real_ttft = stats.latency_quantiles("ttft")

    # the real engine queues without bound and never sheds — mirror that
    spec = ReplicaSpec(
        latency=table, num_slots=eng.num_slots,
        max_queue=1 << 30, page_size=eng.page_size,
        prefix_blocks=eng.num_pages if eng.enable_prefix_cache else 0)
    scaled = dataclasses.replace(trace) if time_scale == 1.0 else None
    if time_scale != 1.0:
        reqs2 = [dataclasses.replace(r, arrival=r.arrival * time_scale)
                 for r in trace.requests]
        scaled = dataclasses.replace(trace, requests=reqs2)
    sim = FleetSimulator(spec, 1, PrefixAffinityRouter())
    fs = sim.run(scaled)
    sim_dur = max((s.finish_t for s in fs.served), default=fs.duration)
    sim_tps = fs.total_tokens / max(sim_dur, 1e-9)
    sim_ttft = fs.ttft_quantiles()
    return {
        "real_tokens_per_s": real_tps,
        "sim_tokens_per_s": sim_tps,
        "throughput_ratio": sim_tps / max(real_tps, 1e-9),
        "real_ttft_p50": real_ttft["p50"] if real_ttft else None,
        "sim_ttft_p50": sim_ttft["p50"] if sim_ttft else None,
        "real_tokens": stats.total_tokens,
        "sim_tokens": fs.total_tokens,
        "table": table.as_dict(),
    }
