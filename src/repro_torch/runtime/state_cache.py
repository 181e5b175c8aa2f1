"""Stateful cache layouts: SSM/hybrid state pools and ring-page spaces.

The paged-KV engine (``runtime/engine.py``) was built for one residency
model: every layer streams full-context KV through ref-counted pages.
The paper's capacity/bandwidth trade (RPU §II-III) has two limiting
cases that model cannot serve:

  * **constant state** — SSM blocks keep a fixed-size recurrent state
    per sequence (conv tail + SSD state, ``models/ssm.py``) and write no
    token-indexed pages at all;
  * **O(window) residency** — sliding-window attention only ever reads
    the last ``window`` keys, so pages wholly behind the window are dead
    weight (the mask skips them; PR 4 landed the mask, this module lands
    the capacity half).

This module is the host-side bookkeeping for both:

  * ``SegmentCacheLayout`` / ``ModelCacheLayout`` — classify each scanned
    segment of a model plan by what it keeps resident (``full`` pages,
    ``ring`` pages, per-slot ``state``), derived from the per-kind
    ``CacheLayout`` registry in ``models/attention_backends.py`` plus the
    segment's window.  The engine uses this one classification everywhere
    it must treat spaces differently (page walkers, defrag, prefix
    scoping, deployment accounting).
  * ``RingPageSpace`` — a second ``PageAllocator`` + page table whose
    blocks are reclaimed as the window slides past them.  Ring pages are
    per-slot private (never shared, CoW'd, prefix-indexed, or
    defragged), so the space is a strict simplification of the full
    space: monotone block indices per slot, dead blocks repointed at the
    scratch page (the sliding mask already excludes those positions, so
    reclamation cannot change logits).

State pools themselves are device pytrees built by
``Model.init_state_pools`` (slot-indexed leaves, mirroring the page-pool
pytree structure); this module stays JAX-free so the invariants are
testable without compiles.

A verbatim copy of ``repro/runtime/state_cache.py`` with its imports
redirected to the port.  ``DeploymentSpec.resolve`` prices with
``model_cache_layout``, ``ring_pages_needed`` and ``state_bytes_per_slot``;
the continuous engine keeps sliding-window layers' pages in a
``RingPageSpace`` and SSM state in ``Model.init_state_pools``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.attention_backends import layout_for_kind
from repro_torch.runtime.kv_cache import SCRATCH_PAGE, PageAllocator


# ---------------------------------------------------------------------------
# Residency classification
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SegmentCacheLayout:
    """What one scanned segment keeps resident per slot.

    ``paged``: ``"full"`` (full-context KV pages), ``"ring"``
    (window-reclaimed KV pages), or None (no token-indexed pages).
    ``state``: the segment carries per-slot recurrent state.
    """
    paged: str | None
    state: bool
    window: int | None
    reps: int


@dataclasses.dataclass(frozen=True)
class ModelCacheLayout:
    """Per-segment residency of a whole model plan."""
    segments: tuple[SegmentCacheLayout, ...]

    @property
    def has_full(self) -> bool:
        return any(s.paged == "full" for s in self.segments)

    @property
    def has_ring(self) -> bool:
        return any(s.paged == "ring" for s in self.segments)

    @property
    def has_state(self) -> bool:
        return any(s.state for s in self.segments)

    @property
    def stateful(self) -> bool:
        """Anything beyond the classic all-full-KV layout."""
        return self.has_ring or self.has_state

    @property
    def ring_window(self) -> int | None:
        """The reclamation window: ring blocks are shared across ring
        segments through ONE ring table, so reclamation must respect the
        widest window any ring segment still reads."""
        ws = [s.window for s in self.segments if s.paged == "ring"]
        return max(ws) if ws else None

    def ring_layers(self) -> int:
        return sum(s.reps for s in self.segments if s.paged == "ring")

    def full_layers(self) -> int:
        return sum(s.reps for s in self.segments if s.paged == "full")


def model_cache_layout(segments, cfg=None) -> ModelCacheLayout:
    """Classify a model plan's segments (``models.model.Segment`` list).

    A segment pages KV iff any of its kinds has a KV half; it is ring iff
    additionally the segment carries a sliding window (global-attention
    layers of the same hybrid model land in separate ``window=None``
    segments, so the split is exact)."""
    out = []
    for seg in segments:
        layouts = [layout_for_kind(k) for k in seg.kinds]
        kv = any(l.kv for l in layouts)
        state = any(l.state for l in layouts)
        paged = None if not kv else ("ring" if seg.window is not None
                                     else "full")
        out.append(SegmentCacheLayout(paged=paged, state=state,
                                      window=seg.window, reps=seg.reps))
    return ModelCacheLayout(segments=tuple(out))


# ---------------------------------------------------------------------------
# Ring-page space
# ---------------------------------------------------------------------------


def ring_blocks_cap(window: int, page_size: int) -> int:
    """Steady-state decode residency bound: a slot's live ring blocks
    never exceed ``ceil(window/page_size) + 1`` (the +1 is the write
    frontier straddling a block boundary)."""
    return -(-window // page_size) + 1


def ring_pages_needed(*, num_slots: int, window: int, page_size: int,
                      max_blocks: int, prefill_chunk: int = 1) -> int:
    """Pool size (incl. scratch) at which ring ``ensure`` can never fail.

    The transient bound is wider than the decode bound: a prefill chunk
    writes ``prefill_chunk`` positions in one dispatch, with reclamation
    only possible between dispatches, so a slot briefly holds
    ``ceil((window + prefill_chunk)/page) + 1`` blocks."""
    cap = min(max_blocks,
              -(-(window + max(prefill_chunk, 1)) // page_size) + 1)
    return 1 + num_slots * cap


class RingPageSpace:
    """Per-slot ring-page tables over a private ``PageAllocator``.

    Block indices are **logical and monotone**: block ``b`` of a slot
    always covers absolute positions ``[b*page, (b+1)*page)``; the ring
    reclaims the PHYSICAL page behind an out-of-window block and repoints
    the table entry at scratch, it never renumbers.  Per slot:

        ``_low``  — first block still backed by a live page
        ``_next`` — first block never allocated (the write frontier)

    so ``[_low, _next)`` are the live blocks and everything below
    ``_low`` reads as scratch (masked out by the sliding window).
    Ring pages are exclusively owned — no sharing, no CoW, no prefix
    index, no defrag — which keeps every allocator rc at exactly 1.
    """

    def __init__(self, *, num_slots: int, num_pages: int, page_size: int,
                 max_blocks: int, window: int):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.num_slots = num_slots
        self.page_size = page_size
        self.max_blocks = max_blocks
        self.window = window
        self.allocator = PageAllocator(num_pages, page_size)
        self._table = np.zeros((num_slots, max_blocks), np.int32)
        self._low = [0] * num_slots
        self._next = [0] * num_slots

    # -- queries ------------------------------------------------------------
    def table(self) -> np.ndarray:
        return self._table

    def live_blocks(self, slot: int) -> int:
        return self._next[slot] - self._low[slot]

    @property
    def decode_cap(self) -> int:
        return ring_blocks_cap(self.window, self.page_size)

    # -- lifecycle ----------------------------------------------------------
    def ensure(self, slot: int, pos: int) -> bool:
        """Back position ``pos`` (and everything since the window's low
        edge) with ring pages.  All-or-nothing, like the full space."""
        need = pos // self.page_size + 1
        if need > self.max_blocks:
            return False
        have = self._next[slot]
        if need <= have:
            return True
        pages = self.allocator.alloc(("ring", slot), need - have)
        if pages is None:
            return False
        self._table[slot, have:need] = pages
        self._next[slot] = need
        return True

    def reclaim(self, slot: int, pos_next: int) -> int:
        """Free every block wholly behind the window of the NEXT query
        position; returns pages freed.  Conservative by one position
        (``first_needed = pos_next - window`` rather than ``- window +
        1``) so the reclamation is correct under either inclusive or
        exclusive window conventions."""
        first_needed = pos_next - self.window
        dead = max(0, first_needed // self.page_size)
        dead = min(dead, self._next[slot])
        freed = 0
        owner = ("ring", slot)
        for b in range(self._low[slot], dead):
            page = int(self._table[slot, b])
            assert page != SCRATCH_PAGE
            self.allocator.drop_page(owner, page)
            self._table[slot, b] = SCRATCH_PAGE
            freed += 1
        self._low[slot] = max(self._low[slot], dead)
        return freed

    def release(self, slot: int) -> int:
        freed = self.allocator.free_owner(("ring", slot))
        self._table[slot, :] = SCRATCH_PAGE
        self._low[slot] = 0
        self._next[slot] = 0
        return freed

    # -- invariants ---------------------------------------------------------
    def check(self) -> None:
        self.allocator.check()
        for slot in range(self.num_slots):
            lo, nx = self._low[slot], self._next[slot]
            assert 0 <= lo <= nx <= self.max_blocks
            row = self._table[slot]
            live = sorted(int(p) for p in row[lo:nx])
            assert SCRATCH_PAGE not in live, "live ring block on scratch"
            assert live == sorted(self.allocator.pages_of(("ring", slot))), \
                "ring table out of sync with allocator"
            assert all(int(p) == SCRATCH_PAGE for p in row[:lo]), \
                "reclaimed ring block not repointed at scratch"
            assert all(int(p) == SCRATCH_PAGE for p in row[nx:])
            assert all(self.allocator.refcount(p) == 1 for p in live), \
                "ring pages are never shared"


# ---------------------------------------------------------------------------
# State-pool accounting (DeploymentSpec.resolve pricing)
# ---------------------------------------------------------------------------


def state_bytes_per_slot(cfg) -> int:
    """Exact per-slot bytes of one layer-stack's SSM state pools.

    Mirrors ``models/ssm.py init_ssm_state``: conv tail
    ``(K-1, conv_dim)`` bf16 + SSD state ``(H, P, N)`` f32, summed over
    every state-carrying layer of the plan (ssm and hybrid kinds)."""
    from repro_torch.models.model import build_plan
    layers = 0
    for seg in build_plan(cfg):
        if any(layout_for_kind(k).state for k in seg.kinds):
            layers += seg.reps
    if not layers:
        return 0
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    conv = (cfg.conv_kernel - 1) * conv_dim * 2          # bf16
    ssd = cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4  # f32
    return (conv + ssd) * layers
