"""A draft/target pair for measuring speculative decoding: the draft is the
target's own first layers.

The measured half of ``benchmarks/spec_decode.py`` (``bench_config``,
``_damp_deep_blocks``, ``build_pair``).  The draft is the target's first
``draft_layers`` layers with the same embedding, final norm and head: the
very tensors, no copy, so its step costs ~``draft_layers / n_layers`` of a
target step and its weights take no memory of their own.  The target's
deeper blocks are damped (their residual out-projections ``wo`` and
``w_down`` scaled by ``damp``), so they barely move the hidden state and
the truncated draft's argmax tracks the target's: the high-acceptance
regime a trained draft gives, with no trained weights to download.

Where the reference builds and initialises the target itself (from
``bench_config`` and a seed), ``build_pair`` here takes the target
``Model`` the caller built (``Model(bench_config(12), device=...).init(0)``,
reference weights through ``bridge.params_from_jax``, or full-size
llama3-8b on the card) and damps it in place.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models.common import ModelConfig
from repro_torch.models.model import Model


def bench_config(n_layers: int) -> ModelConfig:
    """The reference benchmark's small dense model."""
    return ModelConfig(
        name="bench-spec", family="dense", n_layers=n_layers, d_model=384,
        n_heads=8, n_kv_heads=4, head_dim=48, d_ff=1024, vocab_size=2048)


@torch.no_grad()
def _damp_deep_blocks(model: Model, keep: int, eps: float) -> None:
    """Scale the residual out-projections (``wo``, ``w_down``) of blocks
    ``>= keep`` by ``eps``, in place."""
    for blk in model.layers[keep:]:
        blk.attn.wo.mul_(eps)
        blk.mlp.w_down.mul_(eps)


def truncated_draft(model: Model, draft_layers: int) -> Model:
    """A ``Model`` of ``model``'s first ``draft_layers`` layers sharing its
    tensors (embedding, blocks, final norm, head); nothing is allocated."""
    if not 1 <= draft_layers < model.cfg.n_layers:
        raise ValueError(f"draft_layers={draft_layers} must be in "
                         f"[1, {model.cfg.n_layers})")
    dcfg = dataclasses.replace(model.cfg, name=model.cfg.name + "-draft",
                               n_layers=draft_layers)
    draft = Model(dcfg, device="meta")          # shapes only, then rebound
    draft.device = model.device
    draft.embed = model.embed
    draft.layers = nn.ModuleList(list(model.layers)[:draft_layers])
    draft.final_norm = model.final_norm
    if not dcfg.tie_embeddings:
        draft.head = model.head
    return draft


def build_pair(model: Model, draft_layers: int,
               damp: float) -> tuple[Model, Model]:
    """Damp ``model``'s blocks past ``draft_layers`` in place and return
    (target, draft): the target is ``model``, the draft its first
    ``draft_layers`` layers (``truncated_draft``)."""
    _damp_deep_blocks(model, draft_layers, damp)
    return model, truncated_draft(model, draft_layers)
