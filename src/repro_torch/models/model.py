"""Model assembly for the paged serve path (the ``attn_dense`` plan of
``repro/models/model.py``).

``Model`` is an ``nn.Module`` that owns its weights: an embedding table, an
``nn.ModuleList`` of ``Block``s (RMSNorm, GQA attention, RMSNorm, SwiGLU
MLP), the final norm and the head.  The reference stacks layer weights
along a leading axis and scans; eager PyTorch loops over the list instead
(``bridge.py`` converts between the two layouts).

Serve entry points mirror the reference's: ``init_paged_cache`` builds one
K/V page pool per layer, ``prefill_chunk_paged`` runs one chunk of prompt
tokens per slot into the pools, ``decode_step_paged`` one token per slot.
Pools are written in place, so both return only the logits.

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
ITEM_STATEFUL = "ROADMAP Queue 1, 'Stateful layouts'"
ITEM_SPEC = "ROADMAP Queue 1, 'Speculative decoding'"


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


def _no_state(states, ring_table) -> None:
    if states is not None:
        raise NotImplementedError(f"per-slot state pools — {ITEM_STATEFUL}")
    if ring_table is not None:
        raise NotImplementedError(f"ring page tables — {ITEM_STATEFUL}")


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
        scratch page.  Returns (B, V) logits."""
        _no_state(states, ring_table)
        if tokens.ndim == 2:
            raise NotImplementedError(
                f"multi-token decode (speculative verify) — {ITEM_SPEC}")
        cfg = self.cfg
        x = self.embed[tokens.long()]                       # (B, D)
        for win, blk, pool in zip(self.windows, self.layers, pools):
            x = _block_decode_paged(blk, x, cfg, win, pool, page_table, pos)
        return self._head(x[:, None, :])[:, 0]

    def param_count(self) -> int:
        """Weights of the model; a packed weight of a quantized view counts
        by its logical shape."""
        return (sum(p.numel() for p in self.parameters())
                + sum(math.prod(w.shape) for _, w in packed_leaves(self)))
