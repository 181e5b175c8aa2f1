"""Iteration-level request scheduler for continuous batching.

Request lifecycle:  PENDING --admit--> PREFILL --chunks done--> RUNNING
                        ^                 |                        |
                        +----preempt------+------------------------+
                                                RUNNING --finish--> FINISHED

Disaggregated serving splits the lifecycle across two engines: on a
prefill-phase engine, chunk completion parks the request in HANDOFF
(pages held, no decode) until the ``KVHandoff`` seam transfers its page
chain into a decode-phase engine, where it enters RUNNING directly via
``admit_handoff``.  A decode-side preemption re-queues the victim as
PENDING; the disaggregated driver drains it back to the prefill engine
(``drain_preempted``), whose re-prefill reproduces the identical chain.

The scheduler owns admission policy only; the engine drives the loop
(run one prefill **chunk** for each admitted-but-unfilled request, run one
fused decode step over every decoding slot, retire finished slots).
Admission is slot-based: the jitted decode step has a fixed batch of
``num_slots`` rows, and a request occupies one slot from admission to
finish.  Freed slots are refilled from the arrival queue on the **next
iteration** without recompiling — page tables and positions are data, not
shapes.

Admission allocates pages for the whole prompt up front, consulting the
prefix index: matching leading blocks are shared read-only and skipped by
prefill, so ``req.pos`` starts at the first *unseen* token.  Long prompts
then prefill in fixed-size chunks interleaved with decode iterations, so
admission never stalls the running batch.

Preemption (when the page pool is exhausted) is restart-style: the victim
loses its pages and generated tokens and re-queues at the front.  A
restart reproduces the same tokens — greedy trivially, and sampled
requests because every token's PRNG key is ``fold_in(seed, pos)`` (a
function of the request's seed and the token's sequence index only, see
``runtime.sampling``) — so preemption is invisible in the output stream.
The ``emitted`` counter is the one field a restart must NOT reset: it
marks how much of the stream the client has already seen, so the engine
re-emits nothing twice.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Iterable

import numpy as np

from repro_torch.runtime.kv_cache import PagedKVCache
from repro_torch.runtime.sampling import SamplingParams

PENDING, PREFILL, RUNNING, FINISHED = "pending", "prefill", "running", "finished"
# disaggregated serving: prefill finished, page chain awaiting transfer
HANDOFF = "handoff"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (plen,) int32 token ids
    max_new_tokens: int
    arrival_time: float = 0.0          # seconds relative to serve start
    sampling: SamplingParams | None = None   # engine default when None
    # -- mutable lifecycle state --
    state: str = PENDING
    slot: int = -1
    pos: int = 0                       # next cache write/prefill position
    tokens: list[int] = dataclasses.field(default_factory=list)
    logprobs: list[float] = dataclasses.field(default_factory=list)
    emitted: int = 0                   # tokens already streamed to the client
    finish_reason: str | None = None   # "stop" | "length" once finished
    admit_time: float | None = None
    first_token_time: float | None = None
    finish_time: float | None = None
    preemptions: int = 0
    chunks: int = 0                    # prefill chunks executed (all attempts)
    shared_tokens: int = 0             # prefix-cache tokens at last admission
    # -- speculative decoding (cumulative across preemption restarts:
    # re-run windows are real work, and their wasted draft tokens real
    # waste, so the per-request acceptance stats keep counting) --
    spec_windows: int = 0              # draft/verify windows run
    spec_accepted: int = 0             # draft proposals accepted (<= gamma/win)
    # -- prompt scoring (SamplingParams.prompt_logprobs) --
    prompt_logprobs: list[float] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def check_finish(self) -> str | None:
        """The finish reason the current token stream implies, or None —
        the single source of the stop/length rule (the engine applies it
        between steps)."""
        if (self.sampling and self.sampling.stop_token_ids and self.tokens
                and self.tokens[-1] in self.sampling.stop_token_ids):
            return "stop"
        if len(self.tokens) >= self.max_new_tokens:
            return "length"
        return None

    @property
    def done(self) -> bool:
        return self.check_finish() is not None

    @property
    def ttft(self) -> float | None:
        """Arrival -> first generated token (None until it exists)."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def tpot(self) -> float | None:
        """Mean seconds per generated token after the first.

        None until the request finishes, and None for single-token outputs
        (there is no inter-token gap to measure).
        """
        if self.finish_time is None or self.first_token_time is None:
            return None
        n = len(self.tokens) - 1
        if n <= 0:
            return None
        return (self.finish_time - self.first_token_time) / n


class Scheduler:
    """Slot-based admission over a paged KV cache."""

    def __init__(self, cache: PagedKVCache,
                 on_release: Callable[[int], None] | None = None,
                 max_running: int | None = None):
        self.cache = cache
        self.num_slots = cache.num_slots
        self.waiting: deque[Request] = deque()
        self.running: dict[int, Request] = {}
        self._free_slots: list[int] = list(range(self.num_slots))[::-1]
        # engine hook: a slot's per-slot sampling tensors are cleared the
        # moment the slot frees (preempt/finish), alongside its page rows
        self.on_release = on_release
        # bandwidth-model admission hint (``DeploymentSpec``): cap the
        # concurrently-admitted requests below ``num_slots`` when the
        # roofline says extra slots only stretch the decode step (the KV
        # stream already dominates the weight stream)
        self.max_running = min(self.num_slots,
                               max_running or self.num_slots)

    # -- queries ------------------------------------------------------------
    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.running)

    def next_arrival(self) -> float | None:
        # ``submit`` keeps the whole deque arrival-sorted (re-sorting when
        # a later batch arrives out of order) and ``preempt`` only
        # re-queues already-arrived requests at the front, so the head is
        # the minimum — no O(n) scan.
        return self.waiting[0].arrival_time if self.waiting else None

    @property
    def num_running(self) -> int:
        return len(self.running)

    def prefilling(self) -> list[Request]:
        return sorted((r for r in self.running.values() if r.state == PREFILL),
                      key=lambda r: r.rid)

    def decoding(self) -> list[Request]:
        return sorted((r for r in self.running.values() if r.state == RUNNING),
                      key=lambda r: r.rid)

    # -- lifecycle ----------------------------------------------------------
    def submit(self, requests: Iterable[Request]) -> None:
        reqs = sorted(requests, key=lambda r: r.arrival_time)
        if self.waiting and reqs \
                and reqs[0].arrival_time < self.waiting[-1].arrival_time:
            # a later submit with earlier arrivals: merge to keep the
            # deque sorted (next_arrival/admit read only the head)
            self.waiting = deque(sorted(
                list(self.waiting) + reqs, key=lambda r: r.arrival_time))
        else:
            self.waiting.extend(reqs)

    def admit(self, now: float) -> list[Request]:
        """Admit arrived requests into free slots while pages last.

        Admitted requests enter PREFILL with ``pos`` at the first token the
        prefix cache could not supply; the engine drives their chunks."""
        admitted: list[Request] = []
        while (self.waiting and self._free_slots
               and len(self.running) < self.max_running
               and self.waiting[0].arrival_time <= now):
            req = self.waiting[0]
            slot = self._free_slots[-1]
            # prompt-scoring requests skip prefix sharing: a shared prefix
            # would skip exactly the chunk positions whose logprobs were
            # asked for (their pages may still be shared FROM, once filled)
            plp = bool(req.sampling and req.sampling.prompt_logprobs)
            shared = self.cache.admit(slot, req.prompt_len,
                                      tokens=None if plp else req.prompt)
            if shared is None:
                break                      # pool exhausted: wait for frees
            self.waiting.popleft()
            self._free_slots.pop()
            req.state, req.slot = PREFILL, slot
            req.pos = shared               # skip straight past shared pages
            req.shared_tokens = shared
            req.admit_time = now
            self.running[slot] = req
            admitted.append(req)
        return admitted

    # -- disaggregated handoff ---------------------------------------------
    def handoff_ready(self) -> list[Request]:
        """Requests whose prefill finished and whose page chain is parked
        awaiting transfer to a decode-phase engine."""
        return sorted((r for r in self.running.values()
                       if r.state == HANDOFF),
                      key=lambda r: r.rid)

    def admit_handoff(self, req: Request, now: float) -> int | None:
        """Admit a prefilled request straight into RUNNING (decode phase).

        Allocates the prompt's page chain in THIS scheduler's cache —
        consulting the local prefix index, so previously-transferred
        tenant chains are shared instead of re-copied — and returns the
        shared token count, or None when no slot/pages are available
        (the transfer stays queued on the prefill side)."""
        if not self._free_slots or len(self.running) >= self.max_running:
            return None
        slot = self._free_slots[-1]
        plp = bool(req.sampling and req.sampling.prompt_logprobs)
        shared = self.cache.admit(slot, req.prompt_len,
                                  tokens=None if plp else req.prompt)
        if shared is None:
            return None
        self._free_slots.pop()
        req.state, req.slot = RUNNING, slot
        req.admit_time = now
        self.running[slot] = req
        return shared

    def release_handoff(self, slot: int) -> None:
        """Free a HANDOFF request's slot after its chain was transferred.

        Slot-keyed (not request-keyed): by transfer time the request's
        ``slot`` field already points at its decode-side slot.  The
        request is NOT finished — ownership moved to the decode engine.
        Pages shared into the prefix index keep their refs, so later
        prompts with the same prefix skip recompute on this side."""
        self.cache.release(slot)
        self.running.pop(slot)
        self._free_slots.append(slot)
        if self.on_release:
            self.on_release(slot)

    def drain_preempted(self) -> list[Request]:
        """Pop every preempted (PENDING) request off the waiting queue.

        A decode-phase engine cannot re-prefill a preemption victim; the
        disaggregated driver drains them back to the prefill engine."""
        out = [r for r in self.waiting if r.state == PENDING]
        if out:
            self.waiting = deque(r for r in self.waiting
                                 if r.state != PENDING)
        return out

    def requeue(self, req: Request) -> None:
        """Front-queue a preemption victim returned by the decode engine
        (mirrors ``preempt``'s appendleft priority on this side)."""
        req.state = PENDING
        self.waiting.appendleft(req)

    def ensure_capacity(self, req: Request, upto: int | None = None) -> bool:
        """Back ``req``'s write positions through ``upto`` (default: just
        ``req.pos``) with pages, evicting the youngest running request —
        INCLUDING ``req`` itself — while the pool is exhausted.  Returns
        False if ``req`` was preempted.  The speculative engine passes
        ``upto=req.pos + gamma`` so a whole draft/verify window's KV
        writes are backed before the window starts (windows never
        preempt midway — the capacity barrier is at window boundaries).

        A request never evicts one admitted before it: letting a
        freshly-admitted request evict an older one livelocks a pool too
        small for two working sets (each admission grabs the last free
        page, then its first growth evicts the other request, forever —
        the oldest request must be allowed to run to completion so its
        pages come back)."""
        while not self.cache.ensure(req.slot,
                                    req.pos if upto is None else upto):
            victim = max(self.running.values(),
                         key=lambda r: (r.admit_time, r.rid))
            self.preempt(victim)
            if victim is req:
                return False
        return True

    def preempt(self, req: Request) -> None:
        slot = req.slot
        self.cache.release(slot)
        self.running.pop(slot)
        self._free_slots.append(slot)
        req.preemptions += 1
        req.state, req.slot, req.pos = PENDING, -1, 0
        # restart re-derives the identical tokens (fold_in(seed, pos)
        # streams); ``emitted`` survives so nothing is streamed twice
        req.tokens.clear()
        req.logprobs.clear()
        req.prompt_logprobs.clear()
        self.waiting.appendleft(req)
        if self.on_release:
            self.on_release(slot)

    def finish(self, req: Request, now: float) -> None:
        slot = req.slot
        self.cache.release(slot)
        self.running.pop(slot)
        self._free_slots.append(slot)
        req.state, req.finish_time = FINISHED, now
        req.slot = -1
        if self.on_release:
            self.on_release(slot)
