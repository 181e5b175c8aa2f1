"""Block-paged KV cache for continuous-batching serve: a **ref-counted**
page pool with a prompt-prefix index and copy-on-write.

Layout (vLLM-style): every attention layer owns a **page pool** — an array
``(num_pages, page_size, ...)`` — and all layers share ONE logical page id
space, so a single host-side allocator manages the whole model.  A request's
token at absolute position ``t`` lives at
``pool[page_table[slot, t // page_size], t % page_size]`` in every layer.

The host side is split in two:

  * ``PageAllocator`` — a pure-python free-list allocator with per-owner
    page lists and **per-page reference counts**: a physical page may be
    named by several owners at once (prompt-prefix sharing), and is freed
    only when its last reference drops.  Physical page 0 is **reserved as a
    scratch page**: every unallocated page-table entry (and every inactive
    decode slot) points at it, so the jitted decode step can scatter/gather
    unconditionally — dead slots write garbage into scratch instead of
    corrupting live pages.
  * ``PagedKVCache`` — the per-slot page tables over that allocator, plus
    admission / growth / release / defrag bookkeeping, the
    **prompt-prefix index** (chained hash of full token blocks -> resident
    read-only page, LRU-evicted under pool pressure), and **copy-on-write**
    for the pathological case of a write landing in a shared page.

Prefix sharing only ever covers *full* prompt blocks, capped so at least
the final prompt token is always recomputed (its logits seed generation),
which means divergence naturally lands in request-private pages; CoW is
the defensive backstop, and the invariant tests pin its semantics (the
donor page stays byte-identical).

Device pools themselves live in the engine (they are model-shaped pytrees
built by ``Model.init_paged_cache``); this module is deliberately
JAX-light so the allocator invariants are testable without compiles.

Tensor-parallel serving shards the pool arrays over the mesh's model axis
(per the owning backend's ``paged_partition_spec`` — e.g. GQA pools split
their KV-head axis), but the page-id space stays LOGICAL and shared: every
shard holds its slice of the same physical page, so one host-side
allocator + one page table drive all shards, and admission / growth /
CoW / defrag bookkeeping is unchanged.  The allocator itself is
sharding-agnostic; per-device capacity accounting (pool bytes divide by
the shard degree for sharded leaves) lives in
``parallel.plan.paged_kv_token_bytes``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np

SCRATCH_PAGE = 0

PREFIX_OWNER = ("prefix",)      # the index's own reference on cached pages


class PageAllocator:
    """Free-list page allocator with ref-counted, shareable ownership.

    Invariants (asserted by ``check()`` and tests/test_kv_cache.py):
      * page 0 is never handed out (scratch);
      * ``rc[p] >= 1`` for every live page and equals the number of
        owner-list entries naming ``p`` (ref-counts can never go negative:
        the last ``drop`` frees the page and deletes the count);
      * ``len(free) + len(unique live) + 1 == num_pages`` (conservation).
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is scratch)")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list: low page ids handed out first (helps locality)
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self._rc: dict[int, int] = {}
        self._owned: dict[object, list[int]] = {}

    # -- queries ------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        """Unique live pages (shared pages count once)."""
        return len(self._rc)

    def pages_of(self, owner) -> list[int]:
        return list(self._owned.get(owner, ()))

    def refcount(self, page: int) -> int:
        return self._rc.get(page, 0)

    # -- alloc / share / free ----------------------------------------------
    def alloc(self, owner, n: int = 1) -> list[int] | None:
        """Allocate ``n`` exclusive pages for ``owner`` (all-or-nothing)."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        self._owned.setdefault(owner, []).extend(pages)
        return pages

    def share(self, owner, pages: list[int]) -> None:
        """Add a reference from ``owner`` to already-live ``pages``."""
        for p in pages:
            if p not in self._rc:
                raise ValueError(f"cannot share dead page {p}")
            self._rc[p] += 1
        self._owned.setdefault(owner, []).extend(pages)

    def _drop_ref(self, page: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        rc = self._rc.get(page, 0)
        assert rc > 0, f"ref-count underflow on page {page}"
        if rc == 1:
            del self._rc[page]
            self._free.append(page)
            return True
        self._rc[page] = rc - 1
        return False

    def drop_page(self, owner, page: int) -> bool:
        """Remove ONE of ``owner``'s references to ``page``."""
        pages = self._owned.get(owner, [])
        pages.remove(page)                       # ValueError if not an owner
        if not pages:
            self._owned.pop(owner, None)
        return self._drop_ref(page)

    def free_owner(self, owner) -> int:
        """Release every reference of ``owner``; returns pages actually
        freed (shared pages survive under their remaining references)."""
        pages = self._owned.pop(owner, [])
        return sum(self._drop_ref(p) for p in pages)

    # -- defrag -------------------------------------------------------------
    def defrag(self) -> dict[int, int]:
        """Compact live pages into the lowest physical ids.

        Returns the ``{old_page: new_page}`` mapping for moved pages (empty
        when already compact).  A shared page moves once and every owner's
        reference follows it, so aliasing is preserved; the caller only has
        to (a) permute the device pools with the mapping and (b) rewrite
        its page tables (and prefix index) through it.
        """
        live = sorted(self._rc)
        mapping: dict[int, int] = {}
        for target, p in enumerate(live, start=1):   # page 0 stays scratch
            if p != target:
                mapping[p] = target
        if mapping:
            self._rc = {mapping.get(p, p): rc for p, rc in self._rc.items()}
            for owner, pages in self._owned.items():
                self._owned[owner] = [mapping.get(p, p) for p in pages]
            self._free = list(range(self.num_pages - 1, len(live), -1))
        return mapping

    # -- invariants ---------------------------------------------------------
    def check(self) -> None:
        counts: dict[int, int] = {}
        for owner, pages in self._owned.items():
            for p in pages:
                assert p != SCRATCH_PAGE, f"{owner} owns the scratch page"
                counts[p] = counts.get(p, 0) + 1
        assert counts == self._rc, "ref-counts out of sync with owner lists"
        assert all(rc >= 1 for rc in self._rc.values()), "dead page counted"
        assert not (set(self._rc) & set(self._free)), "page both free and live"
        assert len(self._free) + len(self._rc) + 1 == self.num_pages, \
            "free-list conservation violated"


@dataclasses.dataclass
class SlotView:
    """Host view of one decode slot's cache occupancy."""
    owner: object
    num_tokens: int = 0        # absolute positions written so far


def _chain_key(prev: bytes, block_tokens: np.ndarray) -> bytes:
    """Position-dependent content hash of one full token block."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.ascontiguousarray(block_tokens, np.int32).tobytes())
    return h.digest()


class PagedKVCache:
    """Per-slot page tables over a ``PageAllocator``, with prefix caching.

    ``table()`` materializes the ``(num_slots, max_blocks)`` int32 page
    table the jitted decode step consumes; rows of inactive slots (and the
    unallocated tail of active rows) point at the scratch page.

    Prefix caching (``enable_prefix_cache=True``): after a request's
    prompt is fully prefilled, its full blocks are inserted into an LRU
    index keyed by the chained block hash; a later ``admit`` with matching
    leading blocks **shares** those pages read-only instead of allocating
    and recomputing them.  The index holds its own reference on each cached
    page, so pages outlive their request until pool pressure reclaims them
    (LRU, index-only pages first).
    """

    def __init__(self, *, num_slots: int, num_pages: int, page_size: int,
                 max_blocks: int, enable_prefix_cache: bool = False,
                 has_full: bool = True, ring=None,
                 recompute_shared: bool = False):
        self.num_slots = num_slots
        self.max_blocks = max_blocks
        self.page_size = page_size
        self.enable_prefix_cache = enable_prefix_cache
        # -- stateful cache layouts (runtime.state_cache) --
        # has_full=False: no segment streams full-context KV (pure
        # SSM / pure sliding-window models) — admission is slot-based
        # only, the full table stays parked on scratch.
        # ring: a RingPageSpace for the model's sliding-window segments,
        # grown with ``ensure`` and pruned with ``reclaim`` alongside
        # the full space so eviction moves both together.
        # recompute_shared: prefix hits share pages for CAPACITY but
        # report 0 shared tokens, so prefill recomputes from position 0
        # (hybrid models must replay the whole prompt to rebuild SSM
        # state and ring pages; the rewrites into shared attention
        # pages are byte-identical, so donors are unaffected).
        self.has_full = has_full
        self.ring = ring
        self.recompute_shared = recompute_shared
        if enable_prefix_cache and not has_full:
            raise ValueError("prefix cache requires full-KV pages")
        self.allocator = PageAllocator(num_pages, page_size)
        self._table = np.zeros((num_slots, max_blocks), np.int32)
        self._slots: dict[int, SlotView] = {}
        self._prefix: OrderedDict[bytes, int] = OrderedDict()  # key -> page
        self._prefix_pages: dict[int, bytes] = {}              # page -> key
        # counters for serve stats
        self.hit_tokens = 0          # prompt tokens satisfied from the index
        self.lookup_tokens = 0       # prompt tokens admitted in total
        self.cow_events = 0

    # -- queries ------------------------------------------------------------
    def table(self) -> np.ndarray:
        return self._table

    def blocks_of(self, slot: int) -> int:
        return len(self.allocator.pages_of(("slot", slot)))

    def chain(self, slot: int, n_tokens: int) -> list[int]:
        """The page ids backing ``slot``'s first ``n_tokens`` positions, in
        block order — the unit the disaggregated ``KVHandoff`` transfers
        between engines (every id is live and owned/shared by the slot)."""
        return [int(p) for p in
                self._table[slot, :self._needed_blocks(n_tokens)]]

    @property
    def occupancy(self) -> float:
        """Fraction of non-scratch pages currently live."""
        return self.allocator.num_live / (self.allocator.num_pages - 1)

    @property
    def prefix_hit_rate(self) -> float:
        return self.hit_tokens / max(self.lookup_tokens, 1)

    def _needed_blocks(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    # -- prefix index -------------------------------------------------------
    def _shareable_blocks(self, n_tokens: int) -> int:
        """Full blocks eligible for sharing: always leave >= 1 prompt token
        to recompute, so the admitting request still produces first-token
        logits (and divergence lands in its own pages)."""
        return (n_tokens - 1) // self.page_size

    def _match_prefix(self, tokens: np.ndarray) -> list[int]:
        pages: list[int] = []
        key = b""
        ps = self.page_size
        for i in range(self._shareable_blocks(len(tokens))):
            key = _chain_key(key, tokens[i * ps:(i + 1) * ps])
            page = self._prefix.get(key)
            if page is None:
                break
            self._prefix.move_to_end(key)              # LRU touch
            pages.append(page)
        return pages

    def index_prompt(self, slot: int, tokens: np.ndarray) -> int:
        """Insert ``slot``'s fully-written prompt blocks into the index.

        Call only after prefill completed — a block must be resident before
        another request may share it.  Returns blocks newly indexed."""
        if not self.enable_prefix_cache:
            return 0
        added = 0
        key = b""
        ps = self.page_size
        for i in range(self._shareable_blocks(len(tokens))):
            key = _chain_key(key, tokens[i * ps:(i + 1) * ps])
            page = int(self._table[slot, i])
            if key in self._prefix or page == SCRATCH_PAGE \
                    or page in self._prefix_pages:
                continue
            self.allocator.share(PREFIX_OWNER, [page])
            self._prefix[key] = page
            self._prefix_pages[page] = key
            added += 1
        return added

    def _reclaim(self, n: int) -> int:
        """Drop up to ``n`` LRU index entries whose page would free."""
        freed = 0
        for key in list(self._prefix):
            if freed >= n:
                break
            page = self._prefix[key]
            if self.allocator.refcount(page) == 1:     # index-only page
                del self._prefix[key]
                del self._prefix_pages[page]
                self.allocator.drop_page(PREFIX_OWNER, page)
                freed += 1
        return freed

    def _alloc_with_reclaim(self, owner, n: int) -> list[int] | None:
        short = n - self.allocator.num_free
        if short > 0 and self._reclaim(short) < short:
            return None
        return self.allocator.alloc(owner, n)

    # -- lifecycle ----------------------------------------------------------
    def admit(self, slot: int, n_tokens: int,
              tokens: np.ndarray | None = None) -> int | None:
        """Back ``n_tokens`` positions for ``slot``; returns the number of
        leading prompt tokens satisfied by shared prefix pages (0 without a
        hit), or None when the pool cannot back the request."""
        assert slot not in self._slots, f"slot {slot} already live"
        n_blocks = self._needed_blocks(n_tokens)
        if n_blocks > self.max_blocks:
            raise ValueError(
                f"request needs {n_blocks} blocks > max_blocks={self.max_blocks}")
        owner = ("slot", slot)
        if not self.has_full:
            # slot-based admission only: ring pages (and state-pool rows)
            # are backed lazily by ``ensure`` as prefill advances
            self._slots[slot] = SlotView(owner=owner, num_tokens=n_tokens)
            self.lookup_tokens += n_tokens
            return 0
        shared: list[int] = []
        if self.enable_prefix_cache and tokens is not None:
            shared = self._match_prefix(np.asarray(tokens))
            # pin the matched pages BEFORE allocating: the fresh allocation
            # may reclaim LRU index-only pages, and an unpinned match (rc=1,
            # donor request already gone) would be freed and handed straight
            # back as a writable "fresh" page — aliasing two table entries
            self.allocator.share(owner, shared)
        fresh = self._alloc_with_reclaim(owner, n_blocks - len(shared))
        if fresh is None:
            for p in shared:
                self.allocator.drop_page(owner, p)
            return None
        self._slots[slot] = SlotView(owner=owner, num_tokens=n_tokens)
        self._table[slot, :len(shared)] = shared
        self._table[slot, len(shared):n_blocks] = fresh
        self.lookup_tokens += n_tokens
        self.hit_tokens += len(shared) * self.page_size
        return 0 if self.recompute_shared else len(shared) * self.page_size

    def ensure(self, slot: int, pos: int) -> bool:
        """Grow ``slot`` so position ``pos`` has a backing page (in every
        page space the model uses — full and ring grow together, so one
        preemption decision covers both)."""
        view = self._slots[slot]
        need = self._needed_blocks(pos + 1)
        if need > self.max_blocks:
            return False
        if self.has_full:
            have = self.blocks_of(slot)
            if need > have:
                pages = self._alloc_with_reclaim(view.owner, need - have)
                if pages is None:
                    return False
                self._table[slot, have:need] = pages
        if self.ring is not None and not self.ring.ensure(slot, pos):
            return False
        view.num_tokens = max(view.num_tokens, pos + 1)
        return True

    def reclaim(self, slot: int, pos_next: int) -> int:
        """Return ``slot``'s out-of-window ring pages to the ring
        allocator (no-op for pure full-KV layouts); returns pages freed.
        The engine calls this after every prefill chunk and decode step
        with the NEXT query position, keeping windowed residency at
        O(window) per slot."""
        if self.ring is None:
            return 0
        return self.ring.reclaim(slot, pos_next)

    def ring_table(self) -> np.ndarray | None:
        return None if self.ring is None else self.ring.table()

    def release(self, slot: int) -> int:
        """Drop every reference of ``slot`` (finish or eviction); returns
        pages actually freed (shared/indexed pages stay resident).
        Releases every space the slot owns — full pages, ring pages —
        together (the engine separately resets the slot's state-pool
        rows at its next admission)."""
        self._slots.pop(slot, None)
        freed = self.allocator.free_owner(("slot", slot))
        self._table[slot, :] = SCRATCH_PAGE
        if self.ring is not None:
            freed += self.ring.release(slot)
        return freed

    # -- copy-on-write ------------------------------------------------------
    def page_shared(self, slot: int, block: int) -> bool:
        return self.allocator.refcount(int(self._table[slot, block])) > 1

    def cow(self, slot: int, block: int) -> tuple[int, int] | None:
        """Detach ``slot``'s ``block`` from a shared page before a write.

        Allocates a private page and repoints the table entry; returns
        ``(donor_page, private_page)`` so the engine can copy the device
        contents, or None when the page was already exclusive.  The donor
        page (and every other table pointing at it) is untouched."""
        view = self._slots[slot]
        old = int(self._table[slot, block])
        if self.allocator.refcount(old) <= 1:
            return None
        fresh = self._alloc_with_reclaim(view.owner, 1)
        if fresh is None:
            raise RuntimeError("page pool exhausted during copy-on-write")
        self.allocator.drop_page(view.owner, old)
        self._table[slot, block] = fresh[0]
        self.cow_events += 1
        return old, fresh[0]

    # -- defrag -------------------------------------------------------------
    def defrag(self) -> np.ndarray | None:
        """Compact live pages; returns the pool gather index or None.

        The gather index ``g`` satisfies ``new_pool[i] = old_pool[g[i]]``
        for every page pool; page tables and the prefix index are rewritten
        in place (shared pages move once, so aliasing is preserved).
        """
        mapping = self.allocator.defrag()
        if not mapping:
            return None
        lut = np.arange(self.allocator.num_pages, dtype=np.int32)
        for old, new in mapping.items():
            lut[old] = new
        self._table = lut[self._table]
        self._prefix = OrderedDict(
            (k, int(lut[p])) for k, p in self._prefix.items())
        self._prefix_pages = {p: k for k, p in self._prefix.items()}
        gather = np.arange(self.allocator.num_pages, dtype=np.int32)
        for old, new in mapping.items():
            gather[new] = old
        return gather
