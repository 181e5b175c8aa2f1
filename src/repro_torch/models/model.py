"""Model assembly for the serve paths (the ``attn_dense`` plan of
``repro/models/model.py``).

``Model`` is an ``nn.Module`` that owns its weights: an embedding table, an
``nn.ModuleList`` of ``Block``s (RMSNorm, GQA attention, RMSNorm, SwiGLU
MLP), the final norm and the head.  The reference stacks layer weights
along a leading axis and scans; eager PyTorch loops over the list instead
(``bridge.py`` converts between the two layouts).

Serve entry points mirror the reference's.  Continuous (paged):
``init_paged_cache`` builds one K/V page pool per layer,
``prefill_chunk_paged`` runs one chunk of prompt tokens per slot into the
pools, ``decode_step_paged`` one token per slot (or, in its 2-D form, the
C already-chosen tokens of a speculative verify step, with logits at every
position).  Static (dense cache):
``init_cache`` builds one ``(B, max_len, KVH, HD)`` cache per layer,
``prefill`` runs the whole prompt into it, ``decode_step`` one token per
row at a shared position.  ``forward`` scores a whole sequence without a
cache.  Caches and pools are written in place, so these return only the
logits.

Only the ``attn_dense`` block kind is ported; MoE, MLA, SSM and hybrid
plans, ring tables (sliding-window page spaces) and per-slot state pools
raise ``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention_backends as ab
from repro_torch.models import layers
from repro_torch.models.common import (
    NORM_DTYPE, PARAM_DTYPE, ModelConfig, dense_init, embed_init, rmsnorm,
)
from repro_torch.quant.linear import packed_leaves

ITEM_MOE_MLA = "ROADMAP Queue 1, 'MLA backend and MoE'"
ITEM_STATEFUL = layers.ITEM_STATEFUL


@dataclasses.dataclass(frozen=True)
class Segment:
    kinds: tuple[str, ...]
    reps: int
    window: int | None = None     # attention window; None = full attention


def build_plan(cfg: ModelConfig) -> list[Segment]:
    """The reference's segment plan; the port runs ``attn_dense`` only."""
    if cfg.family == "ssm":
        raise NotImplementedError(f"{cfg.name}: ssm plans — {ITEM_STATEFUL}")
    if cfg.family == "hybrid":
        raise NotImplementedError(f"{cfg.name}: hybrid plans — {ITEM_STATEFUL}")
    if cfg.mla or cfg.moe:
        raise NotImplementedError(f"{cfg.name}: MLA/MoE plans — {ITEM_MOE_MLA}")
    return [Segment(("attn_dense",), cfg.n_layers, cfg.sliding_window)]


class Block(nn.Module):
    """One ``attn_dense`` layer: pre-norm GQA attention + pre-norm SwiGLU."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.empty((d,), dtype=NORM_DTYPE,
                                            device=device), requires_grad=False)
        self.attn = layers.Attention(cfg, device)
        self.ln2 = nn.Parameter(torch.empty((d,), dtype=NORM_DTYPE,
                                            device=device), requires_grad=False)
        self.mlp = layers.MLP(cfg, device)


def _block_forward(p: Block, x, cfg: ModelConfig, window):
    """x: (B, S, D), no cache."""
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    x = x + layers.attn_forward(p.attn, h, cfg, window=window)
    return x + layers.mlp_forward(p.mlp, rmsnorm(x, p.ln2, cfg.norm_eps))


def _block_prefill(p: Block, x, cfg: ModelConfig, window, cache):
    """x: (B, S, D) prompt representations; cache written in place."""
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    x = x + layers.attn_prefill(p.attn, h, cfg, cache, window=window)
    return x + layers.mlp_forward(p.mlp, rmsnorm(x, p.ln2, cfg.norm_eps))


def _block_decode(p: Block, x, cfg: ModelConfig, window, cache, cur_pos,
                  positions, cur_len):
    """x: (B, D) single-token representations; cache written in place."""
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    x = x + layers.attn_decode(p.attn, h, cfg, cache, cur_pos, window=window,
                               positions=positions, cur_len=cur_len)
    f = layers.mlp_forward(p.mlp, rmsnorm(x[:, None, :], p.ln2,
                                          cfg.norm_eps))[:, 0]
    return x + f


def _block_decode_paged(p: Block, x, cfg: ModelConfig, window, pool,
                        page_table, pos):
    """x: (B, D) single-token representations; pool written in place."""
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    a = ab.attn_decode_paged(p.attn, h, cfg, pool, page_table, pos,
                             window=window)
    x = x + a.to(x.dtype)
    f = layers.mlp_forward(p.mlp, rmsnorm(x[:, None, :], p.ln2,
                                          cfg.norm_eps))[:, 0]
    return x + f.to(x.dtype)


def _block_prefill_chunk_paged(p: Block, x, cfg: ModelConfig, window, pool,
                               page_table, start, valid):
    """x: (B, C, D); start/valid: (B,) per-slot chunk offset and real-token
    count; pool written in place."""
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    a = ab.attn_prefill_chunk_paged(p.attn, h, cfg, pool, page_table, start,
                                    valid, window=window)
    x = x + a.to(x.dtype)
    f = layers.mlp_forward(p.mlp, rmsnorm(x, p.ln2, cfg.norm_eps))
    return x + f.to(x.dtype)


def _block_decode_multi_paged(p: Block, x, cfg: ModelConfig, window, pool,
                              page_table, start, valid):
    """Multi-token paged decode (speculative verify): x (B, C, D) chosen
    tokens at per-slot offsets ``start`` with ``valid`` real rows; the
    block of ``_block_prefill_chunk_paged`` with the multi-query decode
    attention; pool written in place."""
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    a = ab.attn_decode_multi_paged(p.attn, h, cfg, pool, page_table, start,
                                   valid, window=window)
    x = x + a.to(x.dtype)
    f = layers.mlp_forward(p.mlp, rmsnorm(x, p.ln2, cfg.norm_eps))
    return x + f.to(x.dtype)


def _no_state(states, ring_table) -> None:
    if states is not None:
        raise NotImplementedError(f"per-slot state pools — {ITEM_STATEFUL}")
    if ring_table is not None:
        raise NotImplementedError(f"ring page tables — {ITEM_STATEFUL}")


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
    """Executable ``attn_dense`` model for one ``ModelConfig``, holding its
    weights on ``device`` (uninitialised until ``init`` or the bridge)."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        super().__init__()
        if cfg.frontend is not None:
            raise NotImplementedError(
                f"{cfg.name}: {cfg.frontend} frontends are not ported")
        self.cfg = cfg
        self.plan = build_plan(cfg)
        self.device = resolve_device(device)
        # per-layer attention window (every layer is attn_dense)
        self.windows = [seg.window for seg in self.plan
                        for _ in range(seg.reps)]
        dev = self.device
        self.embed = nn.Parameter(torch.empty(
            (cfg.padded_vocab, cfg.d_model), dtype=PARAM_DTYPE, device=dev),
            requires_grad=False)
        self.layers = nn.ModuleList(Block(cfg, dev) for _ in self.windows)
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
            layers.init_attn(blk.attn, gen, cfg)
            layers.init_mlp(blk.mlp, gen)
        self.final_norm.fill_(1.0)
        self.embed.copy_(embed_init(gen, cfg.padded_vocab, cfg.d_model))
        if not cfg.tie_embeddings:
            self.head.copy_(dense_init(gen, cfg.d_model, cfg.padded_vocab))
        return self

    # ----- head -----
    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        w = self.embed.T if cfg.tie_embeddings else self.head
        logits = x @ w
        if cfg.padded_vocab != cfg.vocab_size:   # mask pad columns to -inf
            pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
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
        """One dense K/V cache per layer (``(B, w, KVH, HD)`` leaves and a
        ``slot_pos`` table; w = max_len, or the layer's window if
        shorter).  ``dtype``: see ``dense_cache_dtype``."""
        dtype = dense_cache_dtype(dtype)
        return [layers.init_attn_cache(self.cfg, batch, max_len, win, dtype,
                                       device=self.device)
                for win in self.windows]

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
        # the dense kernel's per-row valid prefix: positions 0 .. cur_pos
        cur_len = (torch.full((b,), cur_pos + 1, dtype=torch.int32,
                              device=dev) if dev.type == "cuda" else None)
        x = self.embed[tokens.long()]                       # (B, D)
        for win, blk, c in zip(self.windows, self.layers, cache):
            x = _block_decode(blk, x, cfg, win, c, cur_pos, positions,
                              cur_len)
        return self._head(x[:, None, :])[:, 0]

    # ----- paged cache (continuous-batching serve) -----
    def init_paged_cache(self, num_pages: int, page_size: int, dtype=None, *,
                         ring_pages: int | None = None) -> list[dict]:
        """One physical K/V page pool per layer (``(P, page, KVH, HD)``
        leaves); all layers share one logical page-id space.  ``dtype`` is
        a torch dtype or ``"fp8"``/``"int8"`` (code leaves plus per-token
        ``k_scale``/``v_scale`` leaves); another string raises
        ``ValueError``."""
        if ring_pages is not None:
            raise NotImplementedError(f"ring page spaces — {ITEM_STATEFUL}")
        dtype = torch.bfloat16 if dtype is None else dtype
        return [ab.init_attn_page_pool(self.cfg, num_pages, page_size, dtype,
                                       device=self.device)
                for _ in self.layers]

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
        page).  Returns (B, V) logits at each row's last valid position."""
        _no_state(states, ring_table)
        cfg = self.cfg
        x = self.embed[tokens.long()]                       # (B, C, D)
        for win, blk, pool in zip(self.windows, self.layers, pools):
            x = _block_prefill_chunk_paged(blk, x, cfg, win, pool, page_table,
                                           start, valid)
        b, c = tokens.shape
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
        page_table: (B, n_blocks) int32.  Inactive slots point at the
        scratch page.  Returns (B, V) logits.

        Multi-token form (speculative verify): tokens (B, C) of C already
        chosen tokens per slot starting at position ``pos`` with ``valid``
        (B,) real rows (default C; the rest scatter to the scratch page)
        returns (B, C, V) logits, one next-token distribution per fed
        position (``_decode_multi_paged``)."""
        _no_state(states, ring_table)
        if tokens.ndim == 2:
            return self._decode_multi_paged(tokens, pools, page_table, pos,
                                            valid)
        cfg = self.cfg
        x = self.embed[tokens.long()]                       # (B, D)
        for win, blk, pool in zip(self.windows, self.layers, pools):
            x = _block_decode_paged(blk, x, cfg, win, pool, page_table, pos)
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
