"""Model assembly for the serve paths (the ``attn_dense``, ``attn_moe``,
``mla_dense`` and ``mla_moe`` plans of ``repro/models/model.py``).

``Model`` is an ``nn.Module`` that owns its weights: an embedding table, an
``nn.ModuleList`` of ``Block``s, the final norm and the head.  A block is
pre-norm attention through its kind's backend (GQA, or MLA's latent
attention) and a pre-norm FFN: the SwiGLU MLP, or for ``*_moe`` kinds the
routed and shared experts (``models/moe.py``, ``moe_impl``).  The
reference stacks each segment's layer weights along a leading axis and
scans; eager PyTorch loops over the list instead (``bridge.py`` converts
between the two layouts).

Serve entry points mirror the reference's.  Continuous (paged):
``init_paged_cache`` builds one page pool per layer (GQA: K/V leaves;
MLA: latent and rope-key leaves), ``prefill_chunk_paged`` runs one chunk
of prompt tokens per slot into the pools (``prefill_chunk_scored_paged``
also keeps every position's logits, for prompt scoring),
``decode_step_paged`` one token per slot (or, in its 2-D form, the C
already-chosen tokens of a speculative verify step, with logits at every
position).  Static (dense cache): ``init_cache`` builds one dense cache
per layer, ``prefill`` runs the whole prompt into it, ``decode_step`` one
token per row at a shared position.  ``forward`` scores a whole sequence
without a cache.  Caches and pools are written in place, so these return
only the logits.

Sliding-window layers (h2o-danube) keep their pages in a ring space of
their own: ``init_paged_cache(ring_pages=)`` sizes their pools, and the
paged entries read them through ``ring_table`` (pages behind the window
point at the scratch page and are masked), as the reference does.  SSM
and hybrid plans and per-slot state pools raise ``NotImplementedError``
naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention_backends as ab
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (
    NORM_DTYPE, PARAM_DTYPE, ModelConfig, dense_init, embed_init, rmsnorm,
    span,
)
from repro_torch.quant.linear import packed_leaves

ITEM_STATEFUL = layers.ITEM_STATEFUL


@dataclasses.dataclass(frozen=True)
class Segment:
    kinds: tuple[str, ...]
    reps: int
    window: int | None = None     # attention window; None = full attention


def build_plan(cfg: ModelConfig) -> list[Segment]:
    """The reference's segment plan.  The port runs ``attn_dense``,
    ``attn_moe`` (GQA + MoE, llama4: every layer, or alternating with
    ``attn_dense`` in one multi-kind segment), ``mla_dense`` and
    ``mla_moe``; ``ssm`` and ``hybrid`` plans raise naming their ROADMAP
    item."""
    if cfg.family == "ssm":
        raise NotImplementedError(f"{cfg.name}: ssm plans — {ITEM_STATEFUL}")
    if cfg.family == "hybrid":
        raise NotImplementedError(f"{cfg.name}: hybrid plans — {ITEM_STATEFUL}")
    w = cfg.sliding_window
    if cfg.mla:
        segs = []
        nd = cfg.first_dense_layers
        if nd:
            segs.append(Segment(("mla_dense",), nd, w))
        segs.append(Segment(("mla_moe",), cfg.n_layers - nd, w))
        return segs
    if cfg.moe:
        if cfg.moe_layer_period == 1:
            segs = []
            nd = cfg.first_dense_layers
            if nd:
                segs.append(Segment(("attn_dense",), nd, w))
            segs.append(Segment(("attn_moe",), cfg.n_layers - nd, w))
            return segs
        assert cfg.n_layers % cfg.moe_layer_period == 0
        kinds = ("attn_dense",) * (cfg.moe_layer_period - 1) + ("attn_moe",)
        return [Segment(kinds, cfg.n_layers // cfg.moe_layer_period, w)]
    return [Segment(("attn_dense",), cfg.n_layers, w)]


class Block(nn.Module):
    """One layer of block kind ``kind``: pre-norm attention through the
    kind's backend (``attn``: GQA or MLA weights), then a pre-norm FFN
    (``mlp``: SwiGLU, of ``cfg.d_ff`` for ``mla_dense``; ``moe``: routed
    and shared experts for ``*_moe`` kinds)."""

    def __init__(self, kind: str, cfg: ModelConfig, device,
                 moe_impl: str = "auto"):
        super().__init__()
        self.kind = kind
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.empty((d,), dtype=NORM_DTYPE,
                                            device=device), requires_grad=False)
        # every layer of an MoE model writes its pages through
        # last_writes: the batch's rows couple through expert capacity
        self.attn = ab.backend_for_kind(kind).module(cfg, device,
                                                     coupled=cfg.moe)
        self.ln2 = nn.Parameter(torch.empty((d,), dtype=NORM_DTYPE,
                                            device=device), requires_grad=False)
        if self.is_moe:
            self.moe = moe_lib.MoE(cfg, device, impl=moe_impl)
        else:
            self.mlp = layers.MLP(cfg, device)

    @property
    def is_moe(self) -> bool:
        return self.kind.endswith("_moe")


def _ffn(p: Block, x, cfg: ModelConfig):
    if p.is_moe:
        return moe_lib.moe_forward(x, p.moe, cfg, impl=p.moe.impl)
    return layers.mlp_forward(p.mlp, x)


def _block_forward(p: Block, x, cfg: ModelConfig, window):
    """x: (B, S, D), no cache."""
    be = ab.backend_for_kind(p.kind)
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    x = x + be.forward(p.attn, h, cfg, window=window)
    return x + _ffn(p, rmsnorm(x, p.ln2, cfg.norm_eps), cfg)


def _block_prefill(p: Block, x, cfg: ModelConfig, window, cache):
    """x: (B, S, D) prompt representations; cache written in place."""
    be = ab.backend_for_kind(p.kind)
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    x = x + be.prefill(p.attn, h, cfg, cache, window=window)
    return x + _ffn(p, rmsnorm(x, p.ln2, cfg.norm_eps), cfg)


def _block_decode(p: Block, x, cfg: ModelConfig, window, cache, cur_pos,
                  positions, cur_len):
    """x: (B, D) single-token representations; cache written in place."""
    be = ab.backend_for_kind(p.kind)
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    x = x + be.decode(p.attn, h, cfg, cache, cur_pos, window=window,
                      positions=positions, cur_len=cur_len)
    return x + _ffn(p, rmsnorm(x[:, None, :], p.ln2, cfg.norm_eps), cfg)[:, 0]


def _block_decode_paged(p: Block, x, cfg: ModelConfig, window, pool,
                        page_table, pos):
    """x: (B, D) single-token representations; pool written in place."""
    be = ab.backend_for_kind(p.kind)
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    a = be.decode_paged(p.attn, h, cfg, pool, page_table, pos, window=window)
    x = x + a.to(x.dtype)
    f = _ffn(p, rmsnorm(x[:, None, :], p.ln2, cfg.norm_eps), cfg)[:, 0]
    return x + f.to(x.dtype)


def _block_prefill_chunk_paged(p: Block, x, cfg: ModelConfig, window, pool,
                               page_table, start, valid):
    """x: (B, C, D); start/valid: (B,) per-slot chunk offset and real-token
    count; pool written in place."""
    be = ab.backend_for_kind(p.kind)
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    a = be.prefill_chunk_paged(p.attn, h, cfg, pool, page_table, start,
                               valid, window=window)
    x = x + a.to(x.dtype)
    f = _ffn(p, rmsnorm(x, p.ln2, cfg.norm_eps), cfg)
    return x + f.to(x.dtype)


def _block_decode_multi_paged(p: Block, x, cfg: ModelConfig, window, pool,
                              page_table, start, valid):
    """Multi-token paged decode (speculative verify): x (B, C, D) chosen
    tokens at per-slot offsets ``start`` with ``valid`` real rows; the
    block of ``_block_prefill_chunk_paged`` through the backend's
    multi-query decode entry; pool written in place."""
    be = ab.backend_for_kind(p.kind)
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    a = be.decode_multi_paged(p.attn, h, cfg, pool, page_table, start,
                              valid, window=window)
    x = x + a.to(x.dtype)
    f = _ffn(p, rmsnorm(x, p.ln2, cfg.norm_eps), cfg)
    return x + f.to(x.dtype)


def _no_state(states) -> None:
    if states is not None:
        raise NotImplementedError(f"per-slot state pools — {ITEM_STATEFUL}")


def _table_for(window, page_table, ring_table):
    """A layer's page table: sliding-window layers index the ring space
    when the caller keeps one (``ring_table``), else the full space."""
    return ring_table if (window is not None
                          and ring_table is not None) else page_table


def dense_cache_dtype(dtype) -> torch.dtype:
    """The dense cache's dtype: a torch dtype, bf16 for None.  The
    quantized ``"fp8"``/``"int8"`` caches exist only as the continuous
    engine's page pools, and are refused."""
    if isinstance(dtype, str):
        raise NotImplementedError(
            f"cache dtype {dtype!r}: quantized KV caches are the paged pools "
            f"of the continuous engine; the dense cache stays a plain dtype")
    return torch.bfloat16 if dtype is None else dtype


class Model(nn.Module):
    """Executable model for one ``ModelConfig``, holding its weights on
    ``device`` (uninitialised until ``init`` or the bridge).  ``moe_impl``
    picks the MoE strategy of ``*_moe`` layers (``moe.moe_forward``:
    "auto", "dense" or "capacity")."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda",
                 moe_impl: str = "auto"):
        super().__init__()
        if cfg.frontend is not None:
            raise NotImplementedError(
                f"{cfg.name}: {cfg.frontend} frontends are not ported")
        self.cfg = cfg
        self.plan = build_plan(cfg)
        self.device = resolve_device(device)
        # per-layer block kind and attention window, in plan order
        kinds = [(kind, seg.window) for seg in self.plan
                 for _ in range(seg.reps) for kind in seg.kinds]
        self.windows = [win for _, win in kinds]
        dev = self.device
        self.embed = nn.Parameter(torch.empty(
            (cfg.padded_vocab, cfg.d_model), dtype=PARAM_DTYPE, device=dev),
            requires_grad=False)
        self.layers = nn.ModuleList(Block(kind, cfg, dev, moe_impl)
                                    for kind, _ in kinds)
        self.final_norm = nn.Parameter(torch.empty(
            (cfg.d_model,), dtype=NORM_DTYPE, device=dev), requires_grad=False)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(torch.empty(
                (cfg.d_model, cfg.padded_vocab), dtype=PARAM_DTYPE,
                device=dev), requires_grad=False)

    # ----- init -----
    @torch.no_grad()
    def init(self, seed: int) -> "Model":
        """Random weights from one seeded ``torch.Generator`` on the model's
        device (the reference's distributions; not its values — those come
        through ``bridge.params_from_jax``)."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for blk in self.layers:
            blk.ln1.fill_(1.0)
            blk.ln2.fill_(1.0)
            ab.backend_for_kind(blk.kind).init(blk.attn, gen, cfg)
            if blk.is_moe:
                moe_lib.init_moe(blk.moe, gen)
            else:
                layers.init_mlp(blk.mlp, gen)
        self.final_norm.fill_(1.0)
        self.embed.copy_(embed_init(gen, cfg.padded_vocab, cfg.d_model))
        if not cfg.tie_embeddings:
            self.head.copy_(dense_init(gen, cfg.d_model, cfg.padded_vocab))
        return self

    # ----- head -----
    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        with span("head"):
            x = rmsnorm(x, self.final_norm, cfg.norm_eps)
            w = self.embed.T if cfg.tie_embeddings else self.head
            logits = x @ w
            if cfg.padded_vocab != cfg.vocab_size:   # mask pad columns
                pad = (torch.arange(cfg.padded_vocab, device=x.device)
                       >= cfg.vocab_size)
                logits = logits.masked_fill(pad, -1e30)
        return logits

    # ----- forward (full-sequence scoring, no cache) -----
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) -> (B, S, V) logits; every layer attends causally
        over the whole sequence (the flash kernel on CUDA)."""
        cfg = self.cfg
        x = self.embed[tokens.long()]                       # (B, S, D)
        for win, blk in zip(self.windows, self.layers):
            x = _block_forward(blk, x, cfg, win)
        return self._head(x)

    # ----- dense cache (static-batch serve) -----
    def init_cache(self, batch: int, max_len: int, dtype=None) -> list[dict]:
        """One dense cache per layer from its backend (GQA: ``(B, w, KVH,
        HD)`` k/v leaves, w = max_len or the layer's window if shorter;
        MLA: ``(B, max_len, .)`` latent and rope-key leaves) and a
        ``slot_pos`` table.  ``dtype``: see ``dense_cache_dtype``."""
        dtype = dense_cache_dtype(dtype)
        return [ab.backend_for_kind(blk.kind).init_cache(
                    self.cfg, batch, max_len, win, dtype, device=self.device)
                for win, blk in zip(self.windows, self.layers)]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: list) -> torch.Tensor:
        """Run the full prompt (B, S), fill the cache in place; returns the
        (B, V) logits at the last prompt position."""
        cfg = self.cfg
        x = self.embed[tokens.long()]                       # (B, S, D)
        for win, blk, c in zip(self.windows, self.layers, cache):
            x = _block_prefill(blk, x, cfg, win, c)
        return self._head(x[:, -1:, :])[:, 0]

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: list,
                    cur_pos: int) -> torch.Tensor:
        """One static decode step: tokens (B,) sit at position ``cur_pos``
        (an int, shared by every row); the cache is written in place.
        Returns (B, V) logits."""
        cfg = self.cfg
        cur_pos = int(cur_pos)
        b = tokens.shape[0]
        dev = self.device
        positions = torch.full((b, 1), cur_pos, device=dev)
        # the dense kernel's per-row valid prefix of a w-entry cache:
        # min(cur_pos + 1, w) entries, built once per distinct w (a
        # wrapped ring of w = window entries holds exactly the window)
        cur_lens: dict[int, torch.Tensor] = {}
        if dev.type == "cuda":
            for c in cache:
                w = c["slot_pos"].shape[0]
                if w not in cur_lens:
                    cur_lens[w] = torch.full((b,), min(cur_pos + 1, w),
                                             dtype=torch.int32, device=dev)
        x = self.embed[tokens.long()]                       # (B, D)
        for win, blk, c in zip(self.windows, self.layers, cache):
            x = _block_decode(blk, x, cfg, win, c, cur_pos, positions,
                              cur_lens.get(c["slot_pos"].shape[0]))
        return self._head(x[:, None, :])[:, 0]

    # ----- paged cache (continuous-batching serve) -----
    def init_paged_cache(self, num_pages: int, page_size: int, dtype=None, *,
                         ring_pages: int | None = None) -> list[dict]:
        """One physical page pool per layer from its backend (GQA:
        ``(P, page, KVH, HD)`` k/v leaves; MLA: ``(P, page, r)`` latent and
        ``(P, page, rhd)`` rope-key leaves, which refuse fp8/int8); all
        layers share one logical page-id space.  ``dtype`` is
        a torch dtype or ``"fp8"``/``"int8"`` (code leaves plus per-token
        ``k_scale``/``v_scale`` leaves); another string raises
        ``ValueError``.

        ``ring_pages``: the pool size of sliding-window layers, which live
        in their own page-id space (``runtime.state_cache.RingPageSpace``,
        O(window) pages per slot); None puts them in the full space, where
        nothing is reclaimed."""
        dtype = torch.bfloat16 if dtype is None else dtype
        pools = []
        for seg in self.plan:
            if seg.window is not None and any(
                    "sliding" not in ab.backend_for_kind(k).paged_mask_families
                    for k in seg.kinds):
                raise NotImplementedError(
                    "continuous batching over sliding-window segments needs "
                    "a sliding-capable paged backend")
            size = (ring_pages if (seg.window is not None
                                   and ring_pages is not None) else num_pages)
            pools += [ab.backend_for_kind(kind).init_page_pool(
                          self.cfg, size, page_size, dtype, device=self.device)
                      for _ in range(seg.reps) for kind in seg.kinds]
        return pools

    @torch.no_grad()
    def prefill_chunk_paged(self, tokens: torch.Tensor, pools: list,
                            page_table: torch.Tensor, start: torch.Tensor,
                            valid: torch.Tensor, *, states=None,
                            ring_table=None, slot_idx=None) -> torch.Tensor:
        """One fixed-size prefill chunk over a slot batch, straight into the
        page pools.

        tokens: (B, C) chunk tokens (rows padded past ``valid``); start:
        (B,) absolute position of tokens[:, 0]; valid: (B,) real tokens per
        row (0 for padding rows, whose table rows point at the scratch
        page).  ``ring_table`` (B, n_blocks): the sliding-window layers'
        ring space, when the pools keep one.  Returns (B, V) logits at each
        row's last valid position."""
        x = self._prefill_chunk_body(tokens, pools, page_table, start, valid,
                                     states, ring_table)
        return self._last_logits(x, valid)

    @torch.no_grad()
    def prefill_chunk_scored_paged(self, tokens: torch.Tensor, pools: list,
                                   page_table: torch.Tensor,
                                   start: torch.Tensor, valid: torch.Tensor,
                                   *, states=None, ring_table=None,
                                   slot_idx=None):
        """``prefill_chunk_paged`` that also scores the chunk (prompt
        logprobs): returns (last_logits (B, V), full_logits (B, C, V)).
        ``last_logits`` come through exactly the head call of
        ``prefill_chunk_paged``, so a scored admission samples the same
        first token; ``full_logits`` feed the raw prompt-token scores."""
        x = self._prefill_chunk_body(tokens, pools, page_table, start, valid,
                                     states, ring_table)
        return self._last_logits(x, valid), self._head(x)

    def _prefill_chunk_body(self, tokens, pools, page_table, start, valid,
                            states, ring_table) -> torch.Tensor:
        _no_state(states)
        cfg = self.cfg
        x = self.embed[tokens.long()]                       # (B, C, D)
        for win, blk, pool in zip(self.windows, self.layers, pools):
            x = _block_prefill_chunk_paged(
                blk, x, cfg, win, pool, _table_for(win, page_table,
                                                   ring_table), start, valid)
        return x

    def _last_logits(self, x: torch.Tensor, valid) -> torch.Tensor:
        """(B, V) head logits at each row's last valid chunk position."""
        b, c = x.shape[:2]
        last = torch.clamp(valid.long() - 1, 0, c - 1)
        x_last = x[torch.arange(b, device=x.device), last]
        return self._head(x_last[:, None, :])[:, 0]

    @torch.no_grad()
    def decode_step_paged(self, tokens: torch.Tensor, pools: list,
                          page_table: torch.Tensor, pos: torch.Tensor,
                          valid=None, *, states=None, ring_table=None,
                          state_ok=None) -> torch.Tensor:
        """One continuous-batching decode step over the slot batch.

        tokens: (B,) (one per slot); pos: (B,) per-slot ragged positions;
        page_table: (B, n_blocks) int32, and ``ring_table`` for the
        sliding-window layers when the pools keep a ring space.  Inactive
        slots point at the scratch page.  Returns (B, V) logits.

        Multi-token form (speculative verify): tokens (B, C) of C already
        chosen tokens per slot starting at position ``pos`` with ``valid``
        (B,) real rows (default C; the rest scatter to the scratch page)
        returns (B, C, V) logits, one next-token distribution per fed
        position (``_decode_multi_paged``; not over a ring space:
        speculation is gated off for ring layouts, as in the reference)."""
        _no_state(states)
        if tokens.ndim == 2:
            if ring_table is not None:
                raise NotImplementedError(
                    "multi-token decode over ring pages (speculative verify)"
                    " is unsupported: reclaimed ring pages cannot rewind")
            return self._decode_multi_paged(tokens, pools, page_table, pos,
                                            valid)
        cfg = self.cfg
        x = self.embed[tokens.long()]                       # (B, D)
        for win, blk, pool in zip(self.windows, self.layers, pools):
            x = _block_decode_paged(blk, x, cfg, win, pool,
                                    _table_for(win, page_table, ring_table),
                                    pos)
        return self._head(x[:, None, :])[:, 0]

    def _decode_multi_paged(self, tokens: torch.Tensor, pools: list,
                            page_table: torch.Tensor, pos: torch.Tensor,
                            valid) -> torch.Tensor:
        """(B, C) tokens at per-slot offsets -> (B, C, V) logits; the head
        keeps every position (the verify step scores all gamma + 1).

        On CPU tensors the window is flattened into B*C virtual slots and
        run through the single-token decode step itself: each window token
        becomes its own decode row with its own position and a copy of its
        slot's page-table row, so every position's logits — and every KV
        write — are those of the non-speculative step (the greedy
        byte-identity contract).  Later window positions are already
        written when an earlier query reads the pool, but the causal mask
        gives them exactly zero weight.  On CUDA tensors the chunk-shaped
        path runs instead: each layer scatters the chunk and the exact
        multi-query kernel streams each slot's pages once per window."""
        b, c = tokens.shape
        dev = tokens.device
        ar = torch.arange(c, device=dev)
        if valid is None:
            valid = torch.full((b,), c, dtype=torch.int32, device=dev)
        if dev.type == "cpu":
            ok = (ar[None, :] < valid[:, None]).reshape(b * c)
            vpt = torch.where(ok[:, None],
                              page_table.repeat_interleave(c, dim=0), 0)
            vpos = pos.repeat_interleave(c) + ar.to(pos.dtype).repeat(b)
            vpos = torch.where(ok, vpos, 0)
            logits = self.decode_step_paged(tokens.reshape(b * c), pools,
                                            vpt.to(page_table.dtype), vpos)
            return logits.reshape(b, c, -1)
        return self._decode_multi_chunked(tokens, pools, page_table, pos,
                                          valid)

    def _decode_multi_chunked(self, tokens, pools, page_table, pos, valid):
        """The chunk-shaped multi-token decode: (B, C, D) through every
        layer, the multi-query decode attention (``impl="auto"``) on the
        scattered pools, the head at every position."""
        cfg = self.cfg
        x = self.embed[tokens.long()]                       # (B, C, D)
        for win, blk, pool in zip(self.windows, self.layers, pools):
            x = _block_decode_multi_paged(blk, x, cfg, win, pool, page_table,
                                          pos, valid)
        return self._head(x)

    def param_count(self) -> int:
        """Weights of the model; a packed weight of a quantized view counts
        by its logical shape."""
        return (sum(p.numel() for p in self.parameters())
                + sum(math.prod(w.shape) for _, w in packed_leaves(self)))
