"""Model assembly for the serve paths (the ``attn_dense``, ``attn_moe``,
``mla_dense``, ``mla_moe``, ``ssm`` and ``hybrid`` plans of
``repro/models/model.py``).

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
point at the scratch page and are masked), as the reference does.

Stateful kinds (mamba2's ``ssm``: the Mamba2 mixer alone; hymba's
``hybrid``: GQA attention and the mixer side by side, their normed
outputs averaged, then the MLP) carry recurrent state (``models/ssm.py``).
Statically it lives in the layer's cache dict and is replaced by each
call's new state.  Continuously it lives in per-slot pools
(``init_state_pools``) that the paged entries take as ``states=``:
``prefill_chunk_paged`` gathers each bucket row's slot (``slot_idx``),
zeroed where the chunk starts at 0, and scatters the rows of real rows
back; ``decode_step_paged`` commits the rows ``state_ok`` marks.  Both
write the pools in place.

Tensor parallelism (``parallel/hints.py``): the paged blocks close each
Megatron pair at the reference's marks, ``tp_row_dot`` on the ``wo`` and
``w_down`` products and ``tp_psum`` on the residual adds (not of MoE
outputs; the experts run with the marks off, ``no_manual_tp``).  Outside
a ``manual_tp_axis`` region they are plain single-device code.

Modality frontends (stubs, as in the reference: the features and image
embeddings are inputs).  An ``audio`` model (hubert-xlarge, encoder-only)
holds ``in_proj`` (d x d) and ``head`` instead of an embedding: its input
is ``features @ in_proj``, and it has no decode step.  A ``vision`` model
(internvl2-26b) puts a batch's ``image_embeds`` ahead of the token
embeddings.  ``forward``, ``prefill`` and ``loss`` take the reference's
batch dicts (``{"tokens"}``, ``{"tokens", "image_embeds"}``,
``{"features"[, "labels"]}``; a bare (B, S) token tensor for the first
two); the paged entries serve tokens only.

Training: ``forward`` runs under autograd when the weights require
gradients (``train.train_step`` binds trainable ones); ``remat=True``
keeps only each layer's input and recomputes the layer in the backward
pass (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of
a segment step).  ``loss`` is the reference's mean cross-entropy.  On a
training mesh the same ``loss`` runs under ``parallel.hints.train_layout``
(``parallel/train.py``): each layer computes with the rank's weights
(``TrainLayout.block``) and local head counts (``TrainLayout.local_cfg``),
the residual stream holds the rank's positions, each sub-layer's entry
and exit are the ``seq_enter`` / ``seq_leave`` marks, and the embedding,
head and cross-entropy are vocabulary-parallel.
Attention under autograd is the plain ``blocked_attention`` on every
device (``layers.attention_kernel_path``), so a training step launches no
hand-written kernel, as the reference's runs no Pallas one.

Static serving on a mesh (``parallel/serve.py``): ``prefill`` and
``decode_step`` run under ``parallel.hints.serve_layout``, each layer with
the rank's weights and local widths; a sub-layer's exit all-reduces a
split part's f32 partial sums (``seq_leave``), the embedding sums the
ranks' vocabulary blocks, the logits are gathered whole
(``vocab_gather``), and a layer's dense-kernel ``cur_len`` is clamped to
the rank's block of its cache (``cache_seq``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention_backends as ab
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (
    NORM_DTYPE, PARAM_DTYPE, ModelConfig, dense_init, embed_init, rmsnorm,
    span,
)
from repro_torch.parallel.hints import (
    active_layout, cache_seq, no_manual_tp, seq_enter, seq_leave, tp_psum,
    train_layout, vocab_gather,
)
from repro_torch.quant.linear import packed_leaves

@dataclasses.dataclass(frozen=True)
class Segment:
    kinds: tuple[str, ...]
    reps: int
    window: int | None = None     # attention window; None = full attention


def build_plan(cfg: ModelConfig) -> list[Segment]:
    """The reference's segment plan: ``ssm`` (mamba2: one segment),
    ``hybrid`` (hymba: global attention at layer 0, every
    ``global_attn_every``-th layer and the last, a sliding window
    elsewhere, one segment per run of equal windows), ``mla_dense`` /
    ``mla_moe``, ``attn_moe`` (every layer, or alternating with
    ``attn_dense`` in one multi-kind segment) and ``attn_dense``."""
    if cfg.family == "ssm":
        return [Segment(("ssm",), cfg.n_layers)]
    if cfg.family == "hybrid":
        segs: list[Segment] = []
        for i in range(cfg.n_layers):
            is_global = (cfg.global_attn_every and
                         (i % cfg.global_attn_every == 0
                          or i == cfg.n_layers - 1))
            w = None if is_global else cfg.sliding_window
            if segs and segs[-1].window == w:
                segs[-1] = dataclasses.replace(segs[-1],
                                               reps=segs[-1].reps + 1)
            else:
                segs.append(Segment(("hybrid",), 1, w))
        return segs
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
    """One layer of block kind ``kind``.  Attention kinds: pre-norm
    attention through the kind's backend (``attn``: GQA or MLA weights),
    then a pre-norm FFN (``mlp``: SwiGLU, of ``cfg.d_ff`` for
    ``mla_dense``; ``moe``: routed and shared experts for ``*_moe``
    kinds).  ``ssm``: pre-norm Mamba2 mixer only (``ln1``, ``ssm``).
    ``hybrid``: attention and the SSM mixer side by side on one pre-norm
    input, each output normed (``attn_out_norm``, ``ssm_out_norm``) and
    averaged, then the MLP."""

    def __init__(self, kind: str, cfg: ModelConfig, device,
                 moe_impl: str = "auto"):
        super().__init__()
        self.kind = kind
        d = cfg.d_model

        def norm():
            return nn.Parameter(torch.empty((d,), dtype=NORM_DTYPE,
                                            device=device),
                                requires_grad=False)
        self.ln1 = norm()
        if kind != "ssm":
            # every layer of an MoE model writes its pages through
            # last_writes: the batch's rows couple through expert capacity
            self.attn = ab.backend_for_kind(kind).module(cfg, device,
                                                         coupled=cfg.moe)
        if self.has_state:
            self.ssm = ssm_lib.SSM(cfg, device)
        if kind == "hybrid":
            self.attn_out_norm = norm()
            self.ssm_out_norm = norm()
        if kind == "ssm":
            return
        self.ln2 = norm()
        if self.is_moe:
            self.moe = moe_lib.MoE(cfg, device, impl=moe_impl)
        else:
            self.mlp = layers.MLP(cfg, device)

    @property
    def is_moe(self) -> bool:
        return self.kind.endswith("_moe")

    @property
    def has_state(self) -> bool:
        return self.kind in ("ssm", "hybrid")


def _ffn(p: Block, x, cfg: ModelConfig):
    if p.is_moe:
        # inside a tensor-parallel region the experts are replicated: every
        # expert matmul (shared experts too) is complete, so the subtree
        # runs with the marks off
        with no_manual_tp():
            return moe_lib.moe_forward(x, p.moe, cfg, impl=p.moe.impl)
    return layers.mlp_forward(p.mlp, x)



def _hybrid_out(p: Block, x, a, s, cfg: ModelConfig):
    """A hybrid block's tail: the normed attention and SSM outputs
    averaged into the residual, then the MLP."""
    eps = cfg.norm_eps
    x = x + 0.5 * (rmsnorm(a, p.attn_out_norm, eps)
                   + rmsnorm(s, p.ssm_out_norm, eps))
    h = seq_enter(rmsnorm(x, p.ln2, eps))
    return x + seq_leave(layers.mlp_forward(p.mlp, h), "mlp").to(x.dtype)


def _block_forward(p: Block, x, cfg: ModelConfig, window):
    """x: (B, S, D), no cache (on a training mesh the rank's positions:
    each sub-layer runs between the ``seq_enter`` and ``seq_leave``
    marks)."""
    h = seq_enter(rmsnorm(x, p.ln1, cfg.norm_eps))
    if p.kind == "ssm":
        return x + seq_leave(ssm_lib.ssm_forward(h, p.ssm, cfg)[0], "ssm")
    be = ab.backend_for_kind(p.kind)
    a = be.forward(p.attn, h, cfg, window=window)
    if p.kind == "hybrid":
        s, _ = ssm_lib.ssm_forward(h, p.ssm, cfg)
        return _hybrid_out(p, x, seq_leave(a.to(x.dtype), "attn"),
                           seq_leave(s, "ssm"), cfg)
    x = x + seq_leave(a, "attn").to(x.dtype)
    h = seq_enter(rmsnorm(x, p.ln2, cfg.norm_eps))
    return x + seq_leave(_ffn(p, h, cfg),
                         "moe" if p.is_moe else "mlp").to(x.dtype)


def _layer_forward(lay, i: int, p: Block, x, cfg: ModelConfig, window):
    """``_block_forward`` of layer ``i``; under the training layout
    ``lay`` (set again here: remat recomputes the layer in the backward
    pass) with the rank's weights and local widths."""
    if lay is None:
        return _block_forward(p, x, cfg, window)
    with train_layout(lay):
        return _block_forward(lay.block(i, p), x, lay.local_cfg, window)


def _rank_block(lay, i: int, p: Block, cfg: ModelConfig):
    """Layer ``i``'s weights and config: ``p`` and ``cfg`` off a mesh,
    the rank's regions and local widths under a layout."""
    return (p, cfg) if lay is None else (lay.block(i, p), lay.local_cfg)


def _block_prefill(p: Block, x, cfg: ModelConfig, window, cache):
    """x: (B, S, D) prompt representations; cache written in place (a
    state cache's leaves are replaced by the prompt's final state).  On a
    serving mesh each sub-layer's exit sums the ranks' partials
    (``seq_leave``)."""
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    if p.kind == "ssm":
        out, st = ssm_lib.ssm_forward(h, p.ssm, cfg)
        cache.update(st)
        return x + seq_leave(out, "ssm").to(x.dtype)
    be = ab.backend_for_kind(p.kind)
    if p.kind == "hybrid":
        a = be.prefill(p.attn, h, cfg, cache["attn"], window=window)
        s, st = ssm_lib.ssm_forward(h, p.ssm, cfg)
        cache["ssm"].update(st)
        return _hybrid_out(p, x, seq_leave(a, "attn").to(x.dtype),
                           seq_leave(s, "ssm").to(x.dtype), cfg)
    x = x + seq_leave(be.prefill(p.attn, h, cfg, cache, window=window),
                      "attn").to(x.dtype)
    f = _ffn(p, rmsnorm(x, p.ln2, cfg.norm_eps), cfg)
    return x + seq_leave(f, "moe" if p.is_moe else "mlp").to(x.dtype)


def _block_decode(p: Block, x, cfg: ModelConfig, window, cache, cur_pos,
                  positions, cur_len):
    """x: (B, D) single-token representations; cache written in place
    (exits as ``_block_prefill``'s)."""
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    if p.kind == "ssm":
        out, st = ssm_lib.ssm_decode_step(h, p.ssm, cfg, cache)
        cache.update(st)
        return x + seq_leave(out, "ssm").to(x.dtype)
    be = ab.backend_for_kind(p.kind)
    attn_cache = cache["attn"] if p.kind == "hybrid" else cache
    a = be.decode(p.attn, h, cfg, attn_cache, cur_pos, window=window,
                  positions=positions, cur_len=cur_len)
    if p.kind == "hybrid":
        s, st = ssm_lib.ssm_decode_step(h, p.ssm, cfg, cache["ssm"])
        cache["ssm"].update(st)
        return _hybrid_out(p, x, seq_leave(a, "attn").to(x.dtype),
                           seq_leave(s, "ssm").to(x.dtype), cfg)
    x = x + seq_leave(a, "attn").to(x.dtype)
    f = _ffn(p, rmsnorm(x[:, None, :], p.ln2, cfg.norm_eps), cfg)[:, 0]
    return x + seq_leave(f, "moe" if p.is_moe else "mlp").to(x.dtype)


# -- per-slot state pools (continuous serving of ssm / hybrid kinds) --------

def _gather_state_rows(state: dict, slot_idx, start) -> dict:
    """The state rows of a prefill chunk's bucket rows (``slot_idx``);
    rows whose chunk starts at position 0 read a zero state, inside the
    step: admission and a preemption restart both begin at ``start ==
    0``, so the host never resets a state row between tenants."""
    fresh = start == 0
    out = {}
    for key, a in state.items():
        rows = a[slot_idx.long()]
        m = fresh.reshape((-1,) + (1,) * (rows.ndim - 1))
        out[key] = torch.where(m, torch.zeros((), dtype=rows.dtype,
                                              device=rows.device), rows)
    return out


def _scatter_state_rows(state: dict, rows: dict, slot_idx, valid) -> None:
    """Write a chunk's updated rows back into the slot-indexed pools, in
    place; bucket padding rows (``valid == 0``) write nothing.

    Without a host wait and without a scratch row: each pool slot's
    writer is the last bucket row with ``valid > 0`` that names it (an
    ``amax`` scatter, which does not depend on the order its elements
    land in), and every bucket row writes its slot's value from the
    writer's row, or the slot's own value when no real row names it.  So
    rows that share a slot (a padding row on a real row's slot) write
    equal values, and the ``index_copy_`` may land them in any order."""
    idx = slot_idx.long()
    pool0 = next(iter(state.values()))
    b = idx.shape[0]
    ar = torch.arange(b, device=idx.device)
    writer = torch.full((pool0.shape[0],), -1, dtype=torch.long,
                        device=idx.device)
    writer.scatter_reduce_(0, idx, torch.where(valid > 0, ar, -1),
                           reduce="amax")
    w = writer[idx]                                  # (B,) -1: no writer
    src = w.clamp_min(0)
    for key, a in state.items():
        new = rows[key].to(a.dtype)[src]
        m = (w >= 0).reshape((-1,) + (1,) * (new.ndim - 1))
        a.index_copy_(0, idx, torch.where(m, new, a[idx]))


def _commit_state_rows(state: dict, new: dict, ok) -> None:
    """Decode-step commit, in place: only rows that decode this step
    (``ok``) take their new state; the others (mid-prefill, free) keep
    theirs."""
    for key, a in state.items():
        m = ok.reshape((-1,) + (1,) * (a.ndim - 1))
        a.copy_(torch.where(m, new[key].to(a.dtype), a))


def _block_decode_paged(p: Block, x, cfg: ModelConfig, window, pool,
                        page_table, pos, state=None, state_ok=None):
    """x: (B, D) single-token representations; pool written in place.
    Stateful kinds run the one-token recurrence over their slot-indexed
    ``state`` rows (B == slots) and commit the rows ``state_ok`` marks."""
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    if p.kind == "ssm":
        out, st = ssm_lib.ssm_decode_step(h, p.ssm, cfg, state)
        _commit_state_rows(state, st, state_ok)
        return x + out
    be = ab.backend_for_kind(p.kind)
    a = be.decode_paged(p.attn, h, cfg, pool, page_table, pos, window=window)
    if p.kind == "hybrid":
        s, st = ssm_lib.ssm_decode_step(h, p.ssm, cfg, state)
        _commit_state_rows(state, st, state_ok)
        return _hybrid_out(p, x, a.to(x.dtype), s, cfg)
    x = x + tp_psum(a).to(x.dtype)
    f = _ffn(p, rmsnorm(x[:, None, :], p.ln2, cfg.norm_eps), cfg)[:, 0]
    return x + (f if p.is_moe else tp_psum(f)).to(x.dtype)


def _block_prefill_chunk_paged(p: Block, x, cfg: ModelConfig, window, pool,
                               page_table, start, valid, state=None,
                               slot_idx=None):
    """x: (B, C, D); start/valid: (B,) per-slot chunk offset and real-token
    count; pool written in place.  Stateful kinds gather their
    ``slot_idx`` state rows (zero where ``start == 0``), run the chunked
    SSD with ``valid`` masking, so the carried state lands at the valid
    boundary, and scatter the rows back."""
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    if p.kind == "ssm":
        rows = _gather_state_rows(state, slot_idx, start)
        out, st = ssm_lib.ssm_forward(h, p.ssm, cfg, rows, valid=valid)
        _scatter_state_rows(state, st, slot_idx, valid)
        return x + out
    be = ab.backend_for_kind(p.kind)
    a = be.prefill_chunk_paged(p.attn, h, cfg, pool, page_table, start,
                               valid, window=window)
    if p.kind == "hybrid":
        rows = _gather_state_rows(state, slot_idx, start)
        s, st = ssm_lib.ssm_forward(h, p.ssm, cfg, rows, valid=valid)
        _scatter_state_rows(state, st, slot_idx, valid)
        return _hybrid_out(p, x, a.to(x.dtype), s, cfg)
    x = x + tp_psum(a).to(x.dtype)
    f = _ffn(p, rmsnorm(x, p.ln2, cfg.norm_eps), cfg)
    return x + (f if p.is_moe else tp_psum(f)).to(x.dtype)


def _block_decode_multi_paged(p: Block, x, cfg: ModelConfig, window, pool,
                              page_table, start, valid):
    """Multi-token paged decode (speculative verify): x (B, C, D) chosen
    tokens at per-slot offsets ``start`` with ``valid`` real rows; the
    block of ``_block_prefill_chunk_paged`` through the backend's
    multi-query decode entry; pool written in place."""
    be = ab.backend_for_kind(p.kind)
    if be is None or be.decode_multi_paged is None or p.kind == "hybrid":
        raise NotImplementedError(
            f"multi-token decode (speculative verify) over block kind "
            f"{p.kind!r}: state pools advance one token per step — the "
            f"engine gates speculation off for stateful layouts")
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    a = be.decode_multi_paged(p.attn, h, cfg, pool, page_table, start,
                              valid, window=window)
    x = x + tp_psum(a).to(x.dtype)
    f = _ffn(p, rmsnorm(x, p.ln2, cfg.norm_eps), cfg)
    return x + (f if p.is_moe else tp_psum(f)).to(x.dtype)


def _cache_width(cache: dict) -> int | None:
    """Entries of a layer's dense attention cache (a hybrid layer's
    ``attn`` half); None for a pure state cache."""
    slot_pos = cache.get("attn", cache).get("slot_pos")
    return None if slot_pos is None else slot_pos.shape[0]


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
        self.cfg = cfg
        self.plan = build_plan(cfg)
        self.device = resolve_device(device)
        # per-layer block kind and attention window, in plan order
        kinds = [(kind, seg.window) for seg in self.plan
                 for _ in range(seg.reps) for kind in seg.kinds]
        self.windows = [win for _, win in kinds]
        # stateful serving: a kind carrying per-slot recurrent state
        self.needs_state = any(ab.layout_for_kind(k).state for k, _ in kinds)
        dev = self.device

        def param(shape, dtype=PARAM_DTYPE):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=dev),
                                requires_grad=False)
        d, v = cfg.d_model, cfg.padded_vocab
        if cfg.frontend == "audio":
            self.in_proj = param((d, d))
        else:
            self.embed = param((v, d))
        self.layers = nn.ModuleList(Block(kind, cfg, dev, moe_impl)
                                    for kind, _ in kinds)
        self.final_norm = param((d,), NORM_DTYPE)
        if cfg.frontend == "audio" or not cfg.tie_embeddings:
            self.head = param((d, v))

    @property
    def moe_impl(self) -> str:
        """The MoE strategy of the ``*_moe`` layers ("auto" without any)."""
        return next((b.moe.impl for b in self.layers if b.is_moe), "auto")

    # ----- init -----
    @torch.no_grad()
    def init(self, seed: int) -> "Model":
        """Random weights from one seeded ``torch.Generator`` on the model's
        device (the reference's distributions; not its values — those come
        through ``bridge.params_from_jax``)."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for blk in self.layers:
            for norm in ("ln1", "ln2", "attn_out_norm", "ssm_out_norm"):
                if hasattr(blk, norm):
                    getattr(blk, norm).fill_(1.0)
            if blk.kind != "ssm":
                ab.backend_for_kind(blk.kind).init(blk.attn, gen, cfg)
            if blk.has_state:
                ssm_lib.init_ssm(blk.ssm, gen, cfg)
            if blk.is_moe:
                moe_lib.init_moe(blk.moe, gen)
            elif blk.kind != "ssm":
                layers.init_mlp(blk.mlp, gen)
        self.final_norm.fill_(1.0)
        if cfg.frontend == "audio":
            self.in_proj.copy_(dense_init(gen, cfg.d_model, cfg.d_model))
        else:
            self.embed.copy_(embed_init(gen, cfg.padded_vocab, cfg.d_model))
        if hasattr(self, "head"):
            self.head.copy_(dense_init(gen, cfg.d_model, cfg.padded_vocab))
        return self

    # ----- inputs -----
    def _weight(self, name: str) -> torch.Tensor:
        """A top-level weight; on a training mesh the rank's compute
        region of it (``TrainLayout.weight``)."""
        lay = active_layout()
        return getattr(self, name) if lay is None else lay.weight(name)

    def _embed_inputs(self, batch) -> torch.Tensor:
        """(B, S, D) inputs of a batch: ``features @ in_proj`` (audio, the
        features in bf16), the ``image_embeds`` ahead of the token
        embeddings (vision), or the token embeddings.  ``batch``: the
        reference's dict, or a bare (B, S) token tensor.  On a training
        mesh the rank's positions: its features, or the ranks' parts of
        the vocabulary-parallel lookup summed onto them (the image rows
        are the first model rank's part)."""
        if torch.is_tensor(batch):
            batch = {"tokens": batch}
        lay = active_layout()
        if self.cfg.frontend == "audio":
            feats = batch["features"].to(torch.bfloat16)
            w = self._weight("in_proj")
            if lay is not None:
                feats = lay.own_positions(feats)
            # an f32 model multiplies the bf16 features in f32, as jnp
            # promotes them
            return feats.to(torch.promote_types(feats.dtype, w.dtype)) @ w
        if lay is None:
            x = self.embed[batch["tokens"].long()]
        else:
            x = lay.lookup(self._weight("embed"), batch["tokens"])
        if self.cfg.frontend == "vision" and "image_embeds" in batch:
            img = batch["image_embeds"].to(x.dtype)
            if lay is not None and not lay.image_rank():
                img = torch.zeros_like(img)
            x = torch.cat([img, x], dim=1)
        return x if lay is None else lay.scatter_positions(x)

    def _tokens_only(self, what: str) -> None:
        """The paged entries serve token prompts only (the reference
        asserts it)."""
        if self.cfg.frontend is not None:
            raise NotImplementedError(what)

    def _no_encoder_decode(self) -> None:
        if self.cfg.frontend == "audio":
            raise NotImplementedError(
                "encoder-only models have no decode step")

    # ----- head -----
    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of every position; on a training mesh the rank's
        vocabulary columns of the gathered sequence."""
        cfg = self.cfg
        with span("head"):
            x = seq_enter(rmsnorm(x, self._weight("final_norm"),
                                  cfg.norm_eps))
            w = (self._weight("embed").T if cfg.tie_embeddings
                 else self._weight("head"))
            logits = x @ w
            if cfg.padded_vocab != cfg.vocab_size:   # mask pad columns
                lay, v = active_layout(), logits.shape[-1]
                v0 = 0 if lay is None else lay.vocab_offset(v)
                pad = (torch.arange(v0, v0 + v, device=x.device)
                       >= cfg.vocab_size)
                logits = logits.masked_fill(pad, -1e30)
        return logits

    # ----- forward (training / full-sequence scoring, no cache) -----
    def forward(self, batch, *, remat: bool = False) -> torch.Tensor:
        """batch (``_embed_inputs``) -> (B, S, V) logits, every layer over
        the whole sequence (causally unless the config is an encoder).
        Without gradients the flash kernel runs each layer's attention on
        CUDA; under autograd the plain ``blocked_attention`` does
        (``layers.attention_kernel_path``).  ``remat``: under autograd,
        keep only each layer's input and recompute the layer in the
        backward pass (``torch.utils.checkpoint``, non-reentrant)."""
        cfg, lay = self.cfg, active_layout()
        x = self._embed_inputs(batch)                       # (B, S, D)
        remat = remat and torch.is_grad_enabled()
        for i, (win, blk) in enumerate(zip(self.windows, self.layers)):
            if remat:
                x = checkpoint(_layer_forward, lay, i, blk, x, cfg, win,
                               use_reentrant=False)
            else:
                x = _layer_forward(lay, i, blk, x, cfg, win)
        return self._head(x)

    # ----- loss -----
    @staticmethod
    def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy, the vocab axis reduced in f32 (pad columns
        sit at -1e30, as ``_head`` leaves them); on a training mesh over
        the ranks' vocabulary columns (``TrainLayout.xent``)."""
        lay = active_layout()
        if lay is not None:
            return lay.xent(logits, targets)
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        tgt = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
        return torch.mean(lse - tgt)

    def loss(self, batch: dict, *, remat: bool = False) -> torch.Tensor:
        """The reference's three branches: audio against ``labels``; vision
        drops the image positions, then predicts each next token; tokens
        predict each next token."""
        logits = self.forward(batch, remat=remat)
        if self.cfg.frontend == "audio":
            return self._xent(logits, batch["labels"])
        tokens = batch["tokens"]
        if self.cfg.frontend == "vision":
            logits = logits[:, batch["image_embeds"].shape[1]:]
        return self._xent(logits[:, :-1], tokens[:, 1:])

    # ----- dense cache (static-batch serve) -----
    def init_cache(self, batch: int, max_len: int, dtype=None) -> list[dict]:
        """One dense cache per layer from its backend (GQA: ``(B, w, KVH,
        HD)`` k/v leaves, w = max_len or the layer's window if shorter;
        MLA: ``(B, max_len, .)`` latent and rope-key leaves) and a
        ``slot_pos`` table; an ``ssm`` layer's is its zero state
        (``ssm.init_ssm_state``), a ``hybrid`` layer's ``{"attn": ...,
        "ssm": ...}``.  ``dtype``: see ``dense_cache_dtype`` (the state
        keeps its own dtypes)."""
        dtype = dense_cache_dtype(dtype)
        cfg, dev = self.cfg, self.device
        caches = []
        for win, blk in zip(self.windows, self.layers):
            if blk.kind == "ssm":
                caches.append(ssm_lib.init_ssm_state(cfg, batch, device=dev))
                continue
            c = ab.backend_for_kind(blk.kind).init_cache(
                cfg, batch, max_len, win, dtype, device=dev)
            if blk.kind == "hybrid":
                c = {"attn": c,
                     "ssm": ssm_lib.init_ssm_state(cfg, batch, device=dev)}
            caches.append(c)
        return caches

    @torch.no_grad()
    def prefill(self, batch, cache: list) -> torch.Tensor:
        """Run the full prompt (a batch of ``_embed_inputs``; image
        positions first), fill the cache in place; returns the (B, V)
        logits at the last prompt position."""
        lay = active_layout()
        x = self._embed_inputs(batch)                       # (B, S, D)
        for i, (win, blk, c) in enumerate(zip(self.windows, self.layers,
                                              cache)):
            p, cfg = _rank_block(lay, i, blk, self.cfg)
            x = _block_prefill(p, x, cfg, win, c)
        return vocab_gather(self._head(x[:, -1:, :])[:, 0])

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: list,
                    cur_pos: int) -> torch.Tensor:
        """One static decode step: tokens (B,) sit at position ``cur_pos``
        (an int, shared by every row); the cache is written in place.
        Returns (B, V) logits."""
        self._no_encoder_decode()
        lay = active_layout()
        cur_pos = int(cur_pos)
        b = tokens.shape[0]
        dev = self.device
        positions = torch.full((b, 1), cur_pos, device=dev)
        # the dense kernel's per-row valid prefix of a w-entry cache:
        # min(cur_pos + 1, w) entries, built once per distinct w (a
        # wrapped ring of w = window entries holds exactly the window); on
        # a serving mesh clamped to the rank's block of the entries
        cur_lens: dict[int, torch.Tensor] = {}
        widths = [_cache_width(c) for c in cache]
        if layers.kernel_path(dev):
            for w in widths:
                if w is not None and w not in cur_lens:
                    n = min(cur_pos + 1, w)
                    sh = cache_seq(w)
                    if sh is not None:
                        n = min(max(n - sh.start, 0), sh.size)
                    cur_lens[w] = torch.full((b,), n, dtype=torch.int32,
                                             device=dev)
        x = self._embed_inputs(tokens[:, None])[:, 0]       # (B, D)
        for i, (win, blk, c, w) in enumerate(zip(self.windows, self.layers,
                                                 cache, widths)):
            p, cfg = _rank_block(lay, i, blk, self.cfg)
            x = _block_decode(p, x, cfg, win, c, cur_pos, positions,
                              cur_lens.get(w))
        return vocab_gather(self._head(x[:, None, :])[:, 0])

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
                    (be := ab.backend_for_kind(k)) is None
                    or "sliding" not in be.paged_mask_families
                    for k in seg.kinds):
                raise NotImplementedError(
                    "continuous batching over sliding-window segments needs "
                    "a sliding-capable paged backend")
            size = (ring_pages if (seg.window is not None
                                   and ring_pages is not None) else num_pages)
            for _ in range(seg.reps):
                for kind in seg.kinds:
                    be = ab.backend_for_kind(kind)
                    # pure-state kinds (ssm) write no token-indexed pages
                    pools.append({} if be is None else be.init_page_pool(
                        self.cfg, size, page_size, dtype, device=self.device))
        return pools

    def init_state_pools(self, num_slots: int) -> list[dict]:
        """Per-slot recurrent state pools, one per layer (the conv tail
        and SSD state of ``ssm`` / ``hybrid`` layers, ``num_slots`` rows
        each, from the kind's ``CacheLayout.init_state_pool``); ``{}`` for
        stateless layers."""
        out = []
        for blk in self.layers:
            lay = ab.layout_for_kind(blk.kind)
            out.append(lay.init_state_pool(self.cfg, num_slots,
                                           device=self.device)
                       if lay.state else {})
        return out

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
        ring space, when the pools keep one.  A stateful model (ssm,
        hybrid) also takes ``states`` (``init_state_pools``) and
        ``slot_idx`` (B,), each bucket row's slot: its rows are read (zero
        where ``start == 0``) and written back in place, padding rows
        not.  Returns (B, V) logits at each row's last valid position."""
        x = self._prefill_chunk_body(tokens, pools, page_table, start, valid,
                                     states, ring_table, slot_idx)
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
                                     states, ring_table, slot_idx)
        return self._last_logits(x, valid), self._head(x)

    def _check_states(self, states) -> list:
        """The per-layer state pools a call threads ({} per layer for a
        stateless model); a stateful model without them raises, in the
        reference's words."""
        if states is None:
            if self.needs_state:
                raise NotImplementedError(
                    f"{self.cfg.name}: ssm/hybrid serving needs per-slot "
                    f"state pools — pass states=init_state_pools(num_slots) "
                    f"(the continuous engine threads them automatically)")
            return [{}] * len(self.layers)
        return states

    def _prefill_chunk_body(self, tokens, pools, page_table, start, valid,
                            states, ring_table, slot_idx) -> torch.Tensor:
        self._tokens_only("chunked paged prefill serves tokens only")
        states = self._check_states(states)
        cfg = self.cfg
        x = self.embed[tokens.long()]                       # (B, C, D)
        for win, blk, pool, st in zip(self.windows, self.layers, pools,
                                      states):
            x = _block_prefill_chunk_paged(
                blk, x, cfg, win, pool, _table_for(win, page_table,
                                                   ring_table), start, valid,
                state=st, slot_idx=slot_idx)
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
        position (``_decode_multi_paged``; not over a ring space or state
        pools: speculation is gated off for those layouts, as in the
        reference).

        A stateful model threads ``states`` (``init_state_pools``, B ==
        slots) and ``state_ok`` (B,) bool, the slots that decode this
        step: only their state rows commit."""
        self._no_encoder_decode()
        self._tokens_only("continuous batching serves token frontends only")
        if tokens.ndim == 2:
            if states is not None:
                raise NotImplementedError(
                    "multi-token decode over state pools (speculative "
                    "verify) is unsupported — the engine gates it off")
            if ring_table is not None:
                raise NotImplementedError(
                    "multi-token decode over ring pages (speculative verify)"
                    " is unsupported: reclaimed ring pages cannot rewind")
            return self._decode_multi_paged(tokens, pools, page_table, pos,
                                            valid)
        states = self._check_states(states)
        cfg = self.cfg
        x = self.embed[tokens.long()]                       # (B, D)
        for win, blk, pool, st in zip(self.windows, self.layers, pools,
                                      states):
            x = _block_decode_paged(blk, x, cfg, win, pool,
                                    _table_for(win, page_table, ring_table),
                                    pos, state=st, state_ok=state_ok)
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
