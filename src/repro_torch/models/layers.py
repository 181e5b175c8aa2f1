"""GQA attention, MLA attention and dense MLP blocks (the pieces of
``repro/models/layers.py`` that the ``attn_dense``, ``mla_dense`` and
``mla_moe`` kinds use).

The static serve path's attention lives here, as in the reference (the
``gqa`` backend's ``forward``/``prefill``/``decode`` entries):
``attn_forward`` (full sequence, no cache), ``attn_prefill`` (full prompt
into a dense ``(B, S, KVH, HD)`` cache) and ``attn_decode`` (one token
against it).  On CPU tensors they call what the reference calls
(``blocked_attention``; ``decode_attention_ref`` under the ``slot_pos``
mask); on CUDA tensors the hand-written kernels' wrappers
(``flash_attention``, with the layer's sliding window; the dense
``decode_attention`` over the valid prefix ``min(cur_pos + 1, w)`` of the
layer's ``w``-entry cache: a windowed layer's ring cache of ``w`` =
window entries that has wrapped holds exactly the positions in the
window).  ``kernel_path`` makes that choice, once, for both.  The cache
is written in place.

On a serving mesh (``parallel/serve.py``) the same functions run a
rank's part, through marks that are the identity off it: a layer's cache
holds the rank's block of the sequence (``cache_seq``) with every KV head
and the whole ``slot_pos``; prefill writes the block of the gathered k / v
(``heads_gather``; ``_write_prefill``, a ring's slots by their
positions); decode gathers the new k / v and the query heads, the owner
of the slot writes, the dense kernel's partial mode (``return_lse``)
attends over the block (``cur_len`` clamped to it, 0 for an empty one),
``combine_partials`` merges the blocks in f32 and ``own_heads`` keeps the
rank's heads; the closing ``wo`` product is ``tp_row_dot`` (the rank's f32
partial of a row-split weight).  MLA's latent caches split the same way
(``mla_absorbed_attention(comm=)``).

Under autograd (a training step's forward, and its recompute under
``remat``) full-sequence attention is the plain ``blocked_attention`` on
every device, as the reference's training forward is: no Pallas kernel
there has a backward, and neither has the flash kernel here.
``attention_kernel_path`` is that rule, for GQA and MLA alike; each call
it sends to the plain path for autograd counts in ``AUTOGRAD_ATTENTION``,
so a training step's attention calls are counted beside the kernels'
launches.

Parameters live in ``nn.Module``s whose attribute names are the reference
pytree's keys (``wq``, ``bk``, ``q_norm``, ``w_gate`` ...), with the same
shapes and dtypes, so the weight bridge is a rename-free copy.  In a
quantized view (``quant.linear.quantize_params``) the projection
attributes hold packed tensors instead, and every projection goes through
``qdot`` (q/k/v together through ``qdot_group``).  The paged serve paths that use ``_qkv`` live in
``attention_backends.py``.

MLA (``MLA``, the ``mla`` backend's dense entries): ``mla_forward`` and
``mla_prefill`` expand the latent into per-head keys and values of head
dims ``hd + rope_head_dim`` (192) and ``v_hd`` (128) and run the flash
kernel on CUDA tensors (its (192, 128) pair), ``blocked_attention`` on the
CPU; the paged prefill chunk, which starts at a query offset, stays on
``blocked_attention`` on every device, as GQA's does.  ``mla_decode``
attends in the latent space by the absorbed-matmul einsums, as the
reference does.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels.decode_attention.kernel import decode_attention
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.models.common import (
    NEG_INF, NORM_DTYPE, PARAM_DTYPE, ModelConfig, apply_rope,
    blocked_attention, cache_update_at, decode_attention_ref, dense_init,
    rmsnorm, softmax_partial, span, swiglu,
)
from repro_torch.parallel.hints import (
    cache_seq, combine_partials, heads_gather, own_heads, tp_row_dot,
)
from repro_torch.quant.linear import qdot, qdot_group


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """GQA projections, optional qkv bias and per-head qk-norm weights.
    ``coupled``: the rows of a batch couple (an MoE model's expert
    capacity), so paged writes give each place its last writer's value
    (``attention_backends.last_writes``)."""

    def __init__(self, cfg: ModelConfig, device, coupled: bool = False):
        super().__init__()
        self.coupled = coupled
        d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = _param((d, h * hd), PARAM_DTYPE, device)
        self.wk = _param((d, kvh * hd), PARAM_DTYPE, device)
        self.wv = _param((d, kvh * hd), PARAM_DTYPE, device)
        self.wo = _param((h * hd, d), PARAM_DTYPE, device)
        if cfg.qkv_bias:
            self.bq = _param((h * hd,), PARAM_DTYPE, device)
            self.bk = _param((kvh * hd,), PARAM_DTYPE, device)
            self.bv = _param((kvh * hd,), PARAM_DTYPE, device)
        if cfg.qk_norm:
            self.q_norm = _param((hd,), NORM_DTYPE, device)
            self.k_norm = _param((hd,), NORM_DTYPE, device)


@torch.no_grad()
def init_attn(p: Attention, gen: torch.Generator, cfg: ModelConfig) -> None:
    """Fill ``p`` in place: scaled-normal projections, zero biases, unit
    qk-norm weights (the reference's ``init_attn`` values)."""
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p.wq.copy_(dense_init(gen, d, h * hd))
    p.wk.copy_(dense_init(gen, d, kvh * hd))
    p.wv.copy_(dense_init(gen, d, kvh * hd))
    p.wo.copy_(dense_init(gen, h * hd, d))
    if cfg.qkv_bias:
        for b in (p.bq, p.bk, p.bv):
            b.zero_()
    if cfg.qk_norm:
        p.q_norm.fill_(1.0)
        p.k_norm.fill_(1.0)


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = qdot_group(x, (p.wq, p.wk, p.wv))
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def kernel_path(device: torch.device) -> bool:
    """True when the static attention runs the CUDA kernels (tensors on a
    CUDA device), windowed layers included.  ``meta`` tensors (the
    dry-run's count) take the card's path: there each kernel's wrapper
    reports its work instead of launching."""
    return device.type in ("cuda", "meta")


# full-sequence attention calls that ran the plain path because autograd
# records through them (the training forward and its recompute), by family
AUTOGRAD_ATTENTION = {"gqa": 0, "mla": 0}


def attention_kernel_path(family: str, q, k, v) -> bool:
    """The dispatch rule of full-sequence attention (``attn_forward``,
    ``attn_prefill``, MLA's expanded form): the flash kernel on CUDA
    tensors when no autograd graph records through q, k or v; the plain
    ``blocked_attention`` on the CPU, and under autograd on every device
    (counted in ``AUTOGRAD_ATTENTION[family]``), as the reference's
    training forward runs plain attention under ``jax.value_and_grad``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        AUTOGRAD_ATTENTION[family] += 1
        return False
    return kernel_path(q.device)


def _full_attention(q, k, v, cfg: ModelConfig, window):
    if attention_kernel_path("gqa", q, k, v):
        return flash_attention(q, k, v, causal=cfg.causal, window=window)
    return blocked_attention(q, k, v, causal=cfg.causal, window=window)


def attn_forward(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                 window=None, positions=None) -> torch.Tensor:
    """Full-sequence attention (prompt scoring); x: (B, S, D)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    with span("gqa_attention"):
        q, k, v = _qkv(p, x, cfg, positions)
        out = _full_attention(q, k, v, cfg, window)
    return tp_row_dot(out.reshape(b, s, cfg.n_heads * cfg.hd), p.wo)


def _write_prefill(cache: dict, new: dict, s: int) -> None:
    """Write a prompt's ``new`` entries ((B, s, ...) per cache key) into a
    dense cache in place: entry j holds position j (j < s), or, where the
    cache's ``w`` entries are fewer than the prompt (a sliding-window
    ring), the tail position congruent to j mod w.  ``slot_pos`` (w,)
    records every entry's position (-1 empty); on a serving mesh the
    rank's block of the entries (``cache_seq``) is all it writes of the
    rest."""
    slot_pos = cache["slot_pos"]
    w, dev = slot_pos.shape[0], slot_pos.device
    j = torch.arange(w, device=dev)
    if w >= s:
        pos = torch.where(j < s, j, -1)
    else:
        pos = (s - w) + torch.remainder(j - (s - w), w)
    slot_pos.copy_(pos.to(slot_pos.dtype))
    sh = cache_seq(w)
    if sh is not None:
        pos = pos[sh.start:sh.start + sh.size]
    elif w >= s:                        # one device: the prompt's prefix
        for key, val in new.items():
            cache[key][:, :s] = val.to(cache[key].dtype)
        return
    ok = pos >= 0
    for key, val in new.items():
        got = val.index_select(1, pos.clamp_min(0))
        ok_b = ok.reshape((1, -1) + (1,) * (got.ndim - 2))
        cache[key].copy_(torch.where(ok_b, got, torch.zeros(
            (), dtype=got.dtype, device=got.device)).to(cache[key].dtype))


def attn_prefill(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 cache: dict, *, window=None) -> torch.Tensor:
    """Prefill: run attention over the prompt and write its k/v into the
    cache at [0, s) in place (a windowed cache shorter than the prompt
    keeps the tail in ring order)."""
    b, s, _ = x.shape
    dev = x.device
    with span("gqa_attention"):
        q, k, v = _qkv(p, x, cfg, torch.arange(s, device=dev)[None, :])
        out = _full_attention(q, k, v, cfg, window)
    out = tp_row_dot(out.reshape(b, s, cfg.n_heads * cfg.hd), p.wo)
    # on a serving mesh every KV head of the rank's block of positions
    _write_prefill(cache, {"k": heads_gather(k, 2, kv=True),
                           "v": heads_gather(v, 2, kv=True)}, s)
    return out


def attn_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                cur_pos: int, *, window=None, positions: torch.Tensor,
                cur_len: torch.Tensor | None) -> torch.Tensor:
    """One-token step; x: (B, D); cur_pos: the position index of the
    token, the same for every row, with ``positions`` (B, 1) holding it
    and ``cur_len`` (B,) int32 = ``min(cur_pos + 1, w)`` for this layer's
    ``w``-entry cache (CUDA only; None on the CPU), built once per model
    step for all layers of one ``w``.  The new k/v is written at slot
    ``cur_pos % w`` first, then the token attends: on the card over the
    cache's first ``cur_len`` entries, which once a ring of ``w`` = window
    entries has wrapped are exactly the positions in the window."""
    b, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    w = cache["slot_pos"].shape[0]
    sh = cache_seq(w)                    # the rank's block on a mesh
    start, size = (0, w) if sh is None else (sh.start, sh.size)
    on_card = kernel_path(x.device)
    with span("gqa_attention"):
        q, k, v = _qkv(p, x[:, None, :], cfg, positions)
        slot = cur_pos % w
        k, v = heads_gather(k, 2, kv=True), heads_gather(v, 2, kv=True)
        if start <= slot < start + size:          # the slot's owner writes
            cache_update_at(cache["k"], k, slot - start)
            cache_update_at(cache["v"], v, slot - start)
        # fill_ takes the scalar as a kernel argument; an indexed
        # assignment would copy it from host memory and wait for the device
        cache["slot_pos"][slot:slot + 1].fill_(cur_pos)
        qa = heads_gather(q[:, 0], 1)
        partial = sh is not None
        if on_card:
            res = decode_attention(qa, cache["k"], cache["v"], cur_len,
                                   return_lse=partial)
        else:
            slot_pos = cache["slot_pos"][start:start + size]
            valid = (slot_pos >= 0) & (slot_pos <= cur_pos)
            if window is not None:
                valid = valid & (slot_pos > cur_pos - window)
            res = decode_attention_ref(qa, cache["k"], cache["v"], None,
                                       valid=valid[None, :].expand(b, -1),
                                       return_lse=partial)
        # the shards' partials merged, then the rank's heads again
        out = own_heads(combine_partials(*res, sh.comm).to(q.dtype), 1) \
            if partial else res
    return tp_row_dot(out.reshape(b, h * hd), p.wo)


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    window: int | None = None, dtype=torch.bfloat16, *,
                    device) -> dict:
    """Dense K/V cache of one layer: ``(B, w, KVH, HD)`` leaves, w =
    max_len (or the window, if shorter), and ``slot_pos`` (w,) int32, the
    absolute position each slot holds (-1 = empty)."""
    w = min(max_len, window) if window else max_len
    shape = (batch, w, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((w,), -1, dtype=torch.int32,
                                   device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """MLA projections: ``wq`` (per-head nope + rope queries), ``w_dkv``
    (the latent plus the shared rope key), the f32 ``kv_norm`` of the
    latent, the up-projections ``w_uk``/``w_uv`` and ``wo``; ``coupled``
    as for ``Attention``."""

    def __init__(self, cfg: ModelConfig, device, coupled: bool = False):
        super().__init__()
        self.coupled = coupled
        d, h = cfg.d_model, cfg.n_heads
        hd, rhd, vhd, r = cfg.hd, cfg.rope_head_dim, cfg.v_hd, cfg.kv_lora_rank
        self.wq = _param((d, h * (hd + rhd)), PARAM_DTYPE, device)
        self.w_dkv = _param((d, r + rhd), PARAM_DTYPE, device)
        self.kv_norm = _param((r,), NORM_DTYPE, device)
        self.w_uk = _param((r, h * hd), PARAM_DTYPE, device)
        self.w_uv = _param((r, h * vhd), PARAM_DTYPE, device)
        self.wo = _param((h * vhd, d), PARAM_DTYPE, device)


@torch.no_grad()
def init_mla(p: MLA, gen: torch.Generator, cfg: ModelConfig) -> None:
    """Fill ``p`` in place: scaled-normal projections, a unit latent norm
    (the reference's ``init_mla`` distributions)."""
    for w in (p.wq, p.w_dkv, p.w_uk, p.w_uv, p.wo):
        w.copy_(dense_init(gen, *w.shape))
    p.kv_norm.fill_(1.0)


def _mla_qc(p: MLA, x: torch.Tensor, cfg: ModelConfig, positions):
    """Shared q / latent computation.  Returns q_nope, q_rope, c_kv,
    k_rope."""
    b, s, _ = x.shape
    h, hd, rhd, r = cfg.n_heads, cfg.hd, cfg.rope_head_dim, cfg.kv_lora_rank
    q = qdot(x, p.wq).reshape(b, s, h, hd + rhd)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckr = x @ p.w_dkv
    c_kv = rmsnorm(ckr[..., :r], p.kv_norm, cfg.norm_eps)
    k_rope = apply_rope(ckr[..., None, r:], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def mla_expanded_attention(p: MLA, q_nope, q_rope, c_kv, k_rope,
                           cfg: ModelConfig, q_offset=0) -> torch.Tensor:
    """Per-head expansion of the latent keys/values (the prefill path):
    attention over q/k of ``hd + rhd`` and v of ``v_hd``.  q_*: (B, Sq, H,
    .); c_kv (B, Skv, r), k_rope (B, Skv, rhd).  With ``q_offset`` 0 on a
    CUDA device (static prefill, ``Model.forward``) the flash kernel runs
    it (D 192 / Dv 128, the expanded heads as H = KVH); a query offset
    (the paged chunk), the CPU and autograd (``attention_kernel_path``)
    take the plain ``blocked_attention``, which is what the reference
    runs."""
    b, s_kv, _ = c_kv.shape
    h, hd, rhd, vhd = cfg.n_heads, cfg.hd, cfg.rope_head_dim, cfg.v_hd
    # a pool of another dtype than the weights multiplies in the wider one
    dt = torch.promote_types(c_kv.dtype, p.w_uk.dtype)
    c_kv = c_kv.to(dt)
    k_nope = (c_kv @ p.w_uk.to(dt)).reshape(b, s_kv, h, hd)
    v = (c_kv @ p.w_uv.to(dt)).reshape(b, s_kv, h, vhd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s_kv, h, rhd)],
                  dim=-1)
    if (not torch.is_tensor(q_offset) and q_offset == 0
            and attention_kernel_path("mla", q, k, v)):
        # one dtype for the kernel: the pool-wider k/v round to q's
        return flash_attention(q, k.to(q.dtype), v.to(q.dtype),
                               causal=cfg.causal)
    return blocked_attention(q, k, v, causal=cfg.causal, q_offset=q_offset,
                             scale=1.0 / math.sqrt(hd + rhd))


def mla_absorbed_attention(p: MLA, q_nope, q_rope, c_d, kr_d, valid,
                           cfg: ModelConfig, comm=None) -> torch.Tensor:
    """Absorbed-matmul attention in the latent space, f32 throughout:

        score_h(t) = q_nope_h . (W_uk^T)_h c_t + q_rope_h . k_rope_t
        out_h      = (sum_t p_t c_t) @ (W_uv)_h

    q_*: (B, C, H, .) queries; c_d (B, S, r), kr_d (B, S, rhd) the
    latent stream; valid (B, C, S) the visible positions.  Returns
    (B, C, H * v_hd) f32.  ``comm``: on a serving mesh, the
    ``cache_seq`` group whose ranks hold the other blocks of the
    stream."""
    b, c = q_nope.shape[:2]
    h, hd, rhd, vhd, r = (cfg.n_heads, cfg.hd, cfg.rope_head_dim, cfg.v_hd,
                          cfg.kv_lora_rank)
    w_uk = p.w_uk.reshape(r, h, hd).float()
    q_lat = torch.einsum("bchd,rhd->bchr", q_nope.float(), w_uk)
    q_eff = torch.cat([q_lat, q_rope.float()], dim=-1)
    c_f = c_d.float()
    k_eff = torch.cat([c_f, kr_d.float()], dim=-1)                # (B,S,r+rhd)
    if comm is not None:
        # a serving rank's block of the latents: every head's scores over
        # it, the shards' partials merged, then the rank's heads again
        s_ = torch.einsum("bchr,bsr->bchs", heads_gather(q_eff, 2),
                          k_eff) * (1.0 / math.sqrt(hd + rhd))
        ctx, lse = softmax_partial(s_, valid[:, :, None, :], c_f,
                                   "bchs,bsr->bchr")
        ctx = own_heads(combine_partials(ctx, lse, comm), 2)
    else:
        s_ = torch.einsum("bchr,bsr->bchs", q_eff, k_eff) * (
            1.0 / math.sqrt(hd + rhd))
        s_ = torch.where(valid[:, :, None, :], s_, NEG_INF)
        pattn = torch.softmax(s_, dim=-1)
        ctx = torch.einsum("bchs,bsr->bchr", pattn, c_f)           # latent ctx
    w_uv = p.w_uv.reshape(r, h, vhd).float()
    out = torch.einsum("bchr,rhv->bchv", ctx, w_uv)
    return out.reshape(b, c, h * vhd)


def mla_forward(p: MLA, x: torch.Tensor, cfg: ModelConfig, *,
                positions=None) -> torch.Tensor:
    """Full-sequence MLA (prompt scoring); x: (B, S, D)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    with span("mla_attention"):
        q_nope, q_rope, c_kv, k_rope = _mla_qc(p, x, cfg, positions)
        out = mla_expanded_attention(p, q_nope, q_rope, c_kv, k_rope, cfg)
    return tp_row_dot(out.reshape(b, s, cfg.n_heads * cfg.v_hd), p.wo)


def mla_prefill(p: MLA, x: torch.Tensor, cfg: ModelConfig,
                cache: dict) -> torch.Tensor:
    """Prefill: MLA over the prompt, its latents and rope keys written
    into the cache at [0, s) in place."""
    b, s, _ = x.shape
    dev = x.device
    positions = torch.arange(s, device=dev)[None, :]
    with span("mla_attention"):
        q_nope, q_rope, c_kv, k_rope = _mla_qc(p, x, cfg, positions)
        out = mla_expanded_attention(p, q_nope, q_rope, c_kv, k_rope, cfg)
    out = tp_row_dot(out.reshape(b, s, cfg.n_heads * cfg.v_hd), p.wo)
    _write_prefill(cache, {"c_kv": c_kv, "k_rope": k_rope}, s)
    return out


def mla_decode(p: MLA, x: torch.Tensor, cfg: ModelConfig, cache: dict,
               cur_pos: int, *, positions: torch.Tensor) -> torch.Tensor:
    """Absorbed-matmul decode of one token per row at the shared position
    ``cur_pos`` (``positions`` (B, 1) holds it) over the dense latent
    cache, written first at slot ``cur_pos`` (MLA layers attend over the
    full context: no ring)."""
    b, _ = x.shape
    w = cache["slot_pos"].shape[0]
    if cur_pos >= w:
        raise ValueError(f"position {cur_pos} is past the {w}-token cache")
    sh = cache_seq(w)                    # the rank's block on a mesh
    start, size = (0, w) if sh is None else (sh.start, sh.size)
    with span("mla_attention"):
        q_nope, q_rope, c_kv, k_rope = _mla_qc(p, x[:, None, :], cfg,
                                               positions)
        if start <= cur_pos < start + size:       # the slot's owner writes
            cache_update_at(cache["c_kv"], c_kv, cur_pos - start)
            cache_update_at(cache["k_rope"], k_rope, cur_pos - start)
        cache["slot_pos"][cur_pos:cur_pos + 1].fill_(cur_pos)
        slot_pos = cache["slot_pos"][start:start + size]
        valid = (slot_pos >= 0) & (slot_pos <= cur_pos)
        out = mla_absorbed_attention(p, q_nope, q_rope, cache["c_kv"],
                                     cache["k_rope"],
                                     valid[None, None, :].expand(b, 1, -1),
                                     cfg, None if sh is None else sh.comm)
    return tp_row_dot(out[:, 0].to(x.dtype), p.wo)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, *, device) -> dict:
    """Dense latent cache of one MLA layer: ``c_kv`` (B, max_len, r),
    ``k_rope`` (B, max_len, rhd) and ``slot_pos`` (max_len,) int32."""
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.rope_head_dim),
                                  dtype=dtype, device=device),
            "slot_pos": torch.full((max_len,), -1, dtype=torch.int32,
                                   device=device)}


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device, d_ff: int | None = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.w_gate = _param((d, f), PARAM_DTYPE, device)
        self.w_up = _param((d, f), PARAM_DTYPE, device)
        self.w_down = _param((f, d), PARAM_DTYPE, device)


@torch.no_grad()
def init_mlp(p: MLP, gen: torch.Generator) -> None:
    d, f = p.w_gate.shape
    p.w_gate.copy_(dense_init(gen, d, f))
    p.w_up.copy_(dense_init(gen, d, f))
    p.w_down.copy_(dense_init(gen, f, d))


def mlp_forward(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p.w_gate, p.w_up, p.w_down)
