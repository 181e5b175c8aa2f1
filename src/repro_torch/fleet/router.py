"""Replica routing: prefix affinity x load, SLO admission, retry/shed.

The router sees a fleet of replica *views* — anything exposing the small
protocol below (the discrete-event simulator's replicas implement it; a
live serving tier would back it with engine telemetry) — and returns a
:class:`RouteDecision` per request:

- ``admit``: send to the chosen replica.
- ``retry``: every replica is saturated; come back after a backoff
  (bounded — after ``max_retries`` the request is shed instead).
- ``shed``: predicted TTFT or TPOT exceeds the SLO on every candidate,
  or retries ran out.  Shedding at the door is what protects the SLO of
  requests already admitted.

Scoring.  Each candidate replica gets

    score = affinity_weight * (matched_prefix_tokens / prompt_len)
          - load_weight * normalized_load

where ``matched_prefix_tokens`` comes from the replica's view of its
prefix-cache index keyed by the chained block hashes of
``runtime.kv_cache`` (the router hands it the request's hash chain, the
replica reports how many leading blocks it still holds).  Affinity
concentrates a tenant's shared prefix on one replica — one cold prefill
per tenant instead of one per replica — while the load term keeps a hot
tenant from melting its favourite replica.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Protocol, Sequence


@dataclasses.dataclass(frozen=True)
class SLO:
    """Latency targets a served request must meet."""
    ttft_s: float = 2.0       # arrival -> first token
    tpot_s: float = 0.25      # mean inter-token gap after the first

    def met(self, ttft: float | None, tpot: float | None) -> bool:
        """True when a finished request hit both targets (a request with
        no measurable TPOT — single-token output — only needs TTFT)."""
        if ttft is None or ttft > self.ttft_s:
            return False
        return tpot is None or tpot <= self.tpot_s


class ReplicaView(Protocol):
    """What a router needs to know about one replica."""

    def queue_depth(self) -> int:
        """Requests admitted but not finished (running + queued)."""
        ...

    def load(self) -> float:
        """queue_depth normalized by decode slots (1.0 = slots full)."""
        ...

    def saturated(self) -> bool:
        """Admission would exceed the replica's queue bound."""
        ...

    def match_tokens(self, chain: Sequence[bytes]) -> int:
        """Prompt tokens covered by the longest *leading* run of the hash
        chain present in this replica's prefix index."""
        ...

    def predicted_ttft(self, now: float, prompt_len: int,
                       hit_tokens: int) -> float:
        """Estimated arrival->first-token if admitted now."""
        ...

    def predicted_tpot(self) -> float:
        """Estimated steady-state inter-token seconds at current load."""
        ...


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    action: str                    # "admit" | "retry" | "shed"
    replica: int | None = None     # index into the replica list (admit)
    hit_tokens: int = 0            # predicted prefix-cache hit (admit)
    predicted_ttft: float | None = None
    predicted_tpot: float | None = None
    delay_s: float = 0.0           # backoff before re-routing (retry)
    reason: str = ""


class PrefixAffinityRouter:
    """Score replicas by prefix affinity minus load; admit under SLO."""

    def __init__(self, *, slo: SLO | None = None,
                 affinity_weight: float = 1.0, load_weight: float = 0.5,
                 slo_slack: float = 1.0, retry_backoff_s: float = 0.05,
                 max_retries: int = 3):
        self.slo = slo
        self.affinity_weight = affinity_weight
        self.load_weight = load_weight
        self.slo_slack = slo_slack          # admit while pred <= slo*slack
        self.retry_backoff_s = retry_backoff_s
        self.max_retries = max_retries
        self.admitted = 0
        self.retried = 0
        self.shed = 0
        # drain handoff: block hash -> replica view adopted as the new
        # home for that prefix when its old replica was scaled down.
        # Entries give a partial affinity bonus until the adoptive
        # replica's own index warms up; the LRU cap bounds staleness.
        self.placement: OrderedDict = OrderedDict()
        self.placement_cap = 4096

    def adopt_placement(self, keys: Sequence[bytes], replica) -> int:
        """Point a draining replica's prefix heat at ``replica`` so
        tenant affinity survives the scale-down (simulator calls this
        when it marks a victim draining). Returns entries adopted."""
        n = 0
        for h in keys:
            self.placement[h] = replica
            self.placement.move_to_end(h)
            n += 1
        while len(self.placement) > self.placement_cap:
            self.placement.popitem(last=False)
        return n

    def _adopted_frac(self, chain: Sequence[bytes], rep) -> float:
        """Leading fraction of the chain whose adopted home is ``rep``."""
        n = 0
        for h in chain:
            if self.placement.get(h) is not rep:
                break
            n += 1
        return n / max(len(chain), 1)

    # -- scoring (overridable) --
    def order(self, now: float, prompt_len: int, chain: Sequence[bytes],
              replicas: Sequence[ReplicaView]) -> list[tuple[float, int, int]]:
        """(score, hit_tokens, index) per replica, best first."""
        scored = []
        for i, rep in enumerate(replicas):
            hit = rep.match_tokens(chain)
            score = (self.affinity_weight * hit / max(prompt_len, 1)
                     - self.load_weight * rep.load())
            if self.placement:
                # half-strength credit: the blocks were promised to this
                # replica at drain time but may not be resident yet
                score += 0.5 * self.affinity_weight \
                    * self._adopted_frac(chain, rep)
            scored.append((score, hit, i))
        scored.sort(key=lambda t: (-t[0], t[2]))
        return scored

    def route(self, now: float, prompt_len: int, chain: Sequence[bytes],
              replicas: Sequence[ReplicaView], *,
              retries: int = 0) -> RouteDecision:
        best_over_slo = None
        for score, hit, i in self.order(now, prompt_len, chain, replicas):
            rep = replicas[i]
            if rep.saturated():
                continue
            ttft = rep.predicted_ttft(now, prompt_len, hit)
            tpot = rep.predicted_tpot()
            if self.slo is not None:
                if ttft > self.slo.ttft_s * self.slo_slack or \
                        tpot > self.slo.tpot_s * self.slo_slack:
                    if best_over_slo is None:
                        best_over_slo = (i, ttft, tpot)
                    continue
            self.admitted += 1
            return RouteDecision("admit", replica=i, hit_tokens=hit,
                                 predicted_ttft=ttft, predicted_tpot=tpot)
        if best_over_slo is not None:
            i, ttft, tpot = best_over_slo
            self.shed += 1
            return RouteDecision("shed", predicted_ttft=ttft,
                                 predicted_tpot=tpot,
                                 reason="predicted SLO violation")
        # every replica saturated: bounded retry with backoff, then shed
        if retries < self.max_retries:
            self.retried += 1
            return RouteDecision("retry",
                                 delay_s=self.retry_backoff_s * (2 ** retries),
                                 reason="all replicas saturated")
        self.shed += 1
        return RouteDecision("shed", reason="retries exhausted")


class RoundRobinRouter(PrefixAffinityRouter):
    """Baseline: same SLO admission and retry/shed policy, but candidate
    order cycles round-robin and ignores prefix affinity entirely."""

    def __init__(self, **kw):
        kw.setdefault("affinity_weight", 0.0)
        super().__init__(**kw)
        self._next = 0

    def order(self, now, prompt_len, chain, replicas):
        n = len(replicas)
        start = self._next
        self._next = (self._next + 1) % n
        return [(0.0, 0, (start + k) % n) for k in range(n)]
