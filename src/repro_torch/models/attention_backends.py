"""Attention-backend registry and the paged GQA and MLA serve paths.

The port of ``repro/models/attention_backends.py``.  The registry
(``AttentionBackend``, ``register_backend``, ``backend_for_kind``) and the
per-kind cache layouts (``CacheLayout``, ``layout_for_kind``) are the
reference's; ``Model``, ``runtime.state_cache.model_cache_layout`` and the
pool pricing of ``parallel/plan.py`` walk them.  The ``gqa`` and ``mla``
backends are registered; ``ssm``/``hybrid`` kinds keep per-slot SSM
state pools (``ssm.init_ssm_state``: a bf16 conv tail and an f32 SSD
state a slot).

The GQA serve paths follow.  One difference in
kind: the reference returns new pool arrays (``.at[].set``); here every
scatter writes the pool **in place** (``index_put_``), with the page
indices computed once per layer for all of the pool's leaves.  At llama3-8b size a
32-layer pool copied on every step would cost more than the step itself.

The decode attention goes through ``ops.paged_gqa_decode_attention``
(``impl="auto"``): the plain version for CPU tensors, the CUDA kernel for
CUDA tensors.  Chunked prefill gathers the pages and runs
``blocked_attention`` (``impl="blocked"``), as the reference does.  The
multi-token decode of the speculative verify step
(``attn_decode_multi_paged``) goes through
``ops.paged_gqa_multi_attention`` with ``impl="auto"``: the plain
multi-query oracle for CPU tensors, the exact-accumulator CUDA kernel for
CUDA tensors.  fp8/int8 pools quantize on
write (codes plus per-token scales, ``quant/kv.py``) and hand their scale
leaves to the attention; the o projection goes through ``tp_row_dot``
(``parallel/hints.py``: ``qdot`` outside a tensor-parallel region, the
closure of the rank's column shard inside one).

The MLA serve paths keep one latent stream per layer (``c_kv`` and the
shared ``k_rope``, bf16 or f32 pools only), scattered in place like the
GQA pools.  No Pallas kernel carries them in the reference, and none
here: decode and the speculative verify run the absorbed-matmul einsums,
chunked prefill the per-head expansion through ``blocked_attention``, on
every device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.kernels.decode_attention.ops import (
    paged_gqa_decode_attention, paged_gqa_multi_attention,
)
from repro_torch.kernels.decode_attention.ref import (
    gather_pages, paged_valid_mask,
)
from repro_torch.models import layers
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import ModelConfig, span
from repro_torch.parallel.hints import tp_row_dot
from repro_torch.quant import kv as kvq


def token_slots(page_table, pos, page: int):
    """(physical page, offset) of each slot's position ``pos`` (B,)."""
    pos = pos.long()
    rows = torch.arange(pos.shape[0], device=pos.device)
    return page_table[rows, pos // page].long(), pos % page


def chunk_slots(page_table, positions, ok, page: int):
    """(physical page, offset) of each chunk token, flattened to (B*C,).

    positions: (B, C) absolute; ok: (B, C) — entries with ``ok=False``
    (padding rows / the tail of a short last chunk) are redirected to the
    scratch page so live pages are never corrupted."""
    b, c = positions.shape
    okf = ok.reshape(-1)
    pos_f = torch.where(okf, positions.reshape(-1).long(), 0)
    bidx = torch.arange(b, device=positions.device).repeat_interleave(c)
    phys = torch.where(okf, page_table[bidx, pos_f // page].long(), 0)
    return phys, torch.where(okf, pos_f % page, 0)


def _put(pool_leaf: torch.Tensor, slots, vals: torch.Tensor) -> None:
    """pool_leaf[slots] = vals, in place (fp8 codes as their bytes)."""
    kvq.raw_view(pool_leaf).index_put_(
        slots, kvq.raw_view(vals.to(pool_leaf.dtype)))


def init_attn_page_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                        dtype=torch.bfloat16, *, device) -> dict:
    """Physical K/V page pool for one layer: ``(P, page, KVH, HD)``.

    bf16 on the card; f32 for CPU parity runs.  The string dtypes
    ``"fp8"`` / ``"int8"`` build quantized pools: narrow code leaves plus
    per-token f32 ``k_scale``/``v_scale`` leaves of shape ``(P, page,
    KVH)``."""
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.hd)
    if kvq.is_quantized_cache_dtype(dtype):
        store = kvq.cache_storage_dtype(dtype)
        ones = dict(dtype=kvq.SCALE_DTYPE, device=device)
        return {"k": torch.zeros(shape, dtype=store, device=device),
                "v": torch.zeros(shape, dtype=store, device=device),
                "k_scale": torch.ones(shape[:3], **ones),
                "v_scale": torch.ones(shape[:3], **ones)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _scatter_kv(pool: dict, k, v, slots, coupled: bool) -> None:
    """Write k/v (N, KVH, HD) at ``slots`` into every leaf of the pool,
    quantizing on write for fp8/int8 pools (scale = amax of the token's
    head vector, fixed at write time).  When the batch's rows couple (an
    MoE model: they compete for expert capacity), what an idle or padding
    row reads back from the scratch page reaches the live rows, so each
    write takes the value of the last writer of its place
    (``last_writes``), scales included."""
    if coupled:
        src = last_writes(slots, pool["k"].shape[1])
        k, v = k[src], v[src]
    leaves = {"k": k, "v": v}
    fmt = kvq.pool_cache_format(pool)
    if fmt is not None:
        leaves["k"], leaves["k_scale"] = kvq.kv_quantize(k, fmt)
        leaves["v"], leaves["v_scale"] = kvq.kv_quantize(v, fmt)
    for name, vals in leaves.items():
        _put(pool[name], slots, vals)


def attn_decode_paged(p: layers.Attention, x: torch.Tensor, cfg: ModelConfig,
                      pool: dict, page_table, pos, *, window=None) -> torch.Tensor:
    """One-token step against a paged cache.

    x: (B, D) slot tokens; pos: (B,) int per-slot positions (ragged);
    page_table: (B, n_blocks) int32.  The new k/v is scattered into the
    slot's current page before the attention (write-then-attend), then the
    attention streams the live pages through the decode kernel."""
    b, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    with span("gqa_attention"):
        q, k, v = layers._qkv(p, x[:, None, :], cfg, pos[:, None])
        page = pool["k"].shape[1]
        _scatter_kv(pool, k[:, 0], v[:, 0],
                    token_slots(page_table, pos, page), p.coupled)
        out = paged_gqa_decode_attention(
            q[:, 0], pool["k"], pool["v"], page_table, pos,
            k_scales=pool.get("k_scale"), v_scales=pool.get("v_scale"),
            window=window)
    return tp_row_dot(out.reshape(b, h * hd), p.wo)


def attn_prefill_chunk_paged(p: layers.Attention, x: torch.Tensor,
                             cfg: ModelConfig, pool: dict, page_table, start,
                             valid, *, window=None) -> torch.Tensor:
    """One prefill chunk against the paged cache.

    x: (B, C, D) chunk hidden states; start: (B,) absolute position of
    x[:, 0]; valid: (B,) number of real tokens in the chunk (the rest are
    padding).  The chunk's k/v is scattered into the slot's pages, then the
    chunk queries attend over the gathered view — earlier chunks and shared
    prefix pages are already resident."""
    b, c, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    ar = torch.arange(c, device=x.device)
    positions = start[:, None].long() + ar[None, :]
    with span("gqa_attention"):
        q, k, v = layers._qkv(p, x, cfg, positions)
        ok = ar[None, :] < valid[:, None]
        slots = chunk_slots(page_table, positions, ok, pool["k"].shape[1])
        _scatter_kv(pool, k.flatten(0, 1), v.flatten(0, 1), slots,
                    p.coupled)
        out = paged_gqa_multi_attention(
            q, pool["k"], pool["v"], page_table, start,
            k_scales=pool.get("k_scale"), v_scales=pool.get("v_scale"),
            causal=cfg.causal, window=window, impl="blocked")
    return tp_row_dot(out.reshape(b, c, h * hd), p.wo)


def attn_decode_multi_paged(p: layers.Attention, x: torch.Tensor,
                            cfg: ModelConfig, pool: dict, page_table, start,
                            valid, *, window=None) -> torch.Tensor:
    """C-token decode step (speculative verify): x (B, C, D) holds tokens
    already chosen, at per-slot offsets ``start`` with ``valid`` (B,) real
    rows (the rest scatter to the scratch page).  Chunk-shaped
    scatter-then-attend, through the multi-query decode dispatch
    (``impl="auto"``): the plain oracle on CPU, the exact kernel on CUDA,
    which reads each slot's pages once for all C queries."""
    b, c, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    ar = torch.arange(c, device=x.device)
    positions = start[:, None].long() + ar[None, :]
    with span("gqa_attention"):
        q, k, v = layers._qkv(p, x, cfg, positions)
        ok = ar[None, :] < valid[:, None]
        slots = chunk_slots(page_table, positions, ok, pool["k"].shape[1])
        _scatter_kv(pool, k.flatten(0, 1), v.flatten(0, 1), slots,
                    p.coupled)
        out = paged_gqa_multi_attention(
            q, pool["k"], pool["v"], page_table, start,
            k_scales=pool.get("k_scale"), v_scales=pool.get("v_scale"),
            window=window)
    return tp_row_dot(out.reshape(b, c, h * hd), p.wo)


# ---------------------------------------------------------------------------
# MLA backend: absorbed-matmul latent decode + chunked paged prefill
# ---------------------------------------------------------------------------


def init_mla_page_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                       dtype=torch.bfloat16, *, device) -> dict:
    """Latent page pool for one MLA layer: ``c_kv`` (P, page, r) and the
    shared ``k_rope`` (P, page, rhd).  Quantized (fp8/int8) pools raise,
    as the reference's do."""
    if kvq.is_quantized_cache_dtype(dtype):
        raise NotImplementedError(
            f"cache_dtype={dtype!r} is not implemented for MLA latent page "
            f"pools: the absorbed-matmul decode consumes latent pages "
            f"directly and has no dequant seam yet.  Quantized KV "
            f"({'/'.join(sorted(kvq.KV_FORMATS))}) is only available for "
            f"GQA-family page pools; for MLA models use a dense cache_dtype "
            f"(None, torch.bfloat16, torch.float32) instead.")
    return {"c_kv": torch.zeros((num_pages, page_size, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((num_pages, page_size, cfg.rope_head_dim),
                                  dtype=dtype, device=device)}


def last_writes(slots, page: int) -> torch.Tensor:
    """For each of N writes at ``slots`` (physical page, offset), the index
    of the last write to the same place.  Idle and padding rows all write
    the scratch page, so writes collide there: the CPU applies them in
    order (the last one wins, in the reference too), CUDA in any order.
    Taking every write's value from the last writer of its place leaves
    the pool as the CPU does on every device and every run.  A stable sort
    of the N places groups the writes (O(N log N), whatever the pool's
    size, and no shape that waits on the device)."""
    phys, off = slots
    key, order = torch.sort(phys.long() * page + off, stable=True)
    group = torch.ones_like(key)
    group[0] = 0
    group[1:] = key[1:] != key[:-1]
    group = group.cumsum(0)                   # sorted position -> its place
    last = torch.full_like(order, -1).scatter_reduce_(0, group, order, "amax")
    return torch.empty_like(order).index_put_((order,), last[group])


def _scatter_latent(pool: dict, c_kv, k_rope, slots, coupled: bool) -> None:
    """Write the latents (N, r) and rope keys (N, rhd) at ``slots``,
    through ``last_writes`` when the batch's rows couple, as
    ``_scatter_kv`` writes."""
    if coupled:
        src = last_writes(slots, pool["c_kv"].shape[1])
        c_kv, k_rope = c_kv[src], k_rope[src]
    _put(pool["c_kv"], slots, c_kv)
    _put(pool["k_rope"], slots, k_rope)


def mla_decode_paged(p: layers.MLA, x: torch.Tensor, cfg: ModelConfig,
                     pool: dict, page_table, pos, *, window=None
                     ) -> torch.Tensor:
    """Absorbed-matmul MLA decode against a paged latent cache: the math
    of ``layers.mla_decode`` with the latent and rope-key streams gathered
    through the page table and a per-slot (ragged) position vector.
    x: (B, D); pos: (B,)."""
    assert window is None, "MLA layers are full-attention"
    b, _ = x.shape
    with span("mla_attention"):
        q_nope, q_rope, c_kv, k_rope = layers._mla_qc(
            p, x[:, None, :], cfg, pos[:, None])
        page = pool["c_kv"].shape[1]
        _scatter_latent(pool, c_kv[:, 0], k_rope[:, 0],
                        token_slots(page_table, pos, page), p.coupled)
        c_d = gather_pages(pool["c_kv"], page_table)           # (B, S, r)
        kr_d = gather_pages(pool["k_rope"], page_table)        # (B, S, rhd)
        valid = paged_valid_mask(page_table, page, pos)        # (B, S)
        out = layers.mla_absorbed_attention(p, q_nope, q_rope, c_d, kr_d,
                                            valid[:, None, :], cfg)
    return tp_row_dot(out[:, 0].to(x.dtype), p.wo)


def mla_decode_multi_paged(p: layers.MLA, x: torch.Tensor, cfg: ModelConfig,
                           pool: dict, page_table, start, valid, *,
                           window=None) -> torch.Tensor:
    """C-token absorbed-matmul MLA decode (speculative verify).  It
    mirrors ``mla_decode_paged``'s absorbed path, not the per-head
    expansion of ``mla_prefill_chunk_paged``: the two associate the latent
    products differently and part at ulp scale."""
    assert window is None, "MLA layers are full-attention"
    b, c, _ = x.shape
    ar = torch.arange(c, device=x.device)
    positions = start[:, None].long() + ar[None, :]
    with span("mla_attention"):
        q_nope, q_rope, c_kv, k_rope = layers._mla_qc(p, x, cfg, positions)
        ok = ar[None, :] < valid[:, None]
        slots = chunk_slots(page_table, positions, ok, pool["c_kv"].shape[1])
        _scatter_latent(pool, c_kv.flatten(0, 1), k_rope.flatten(0, 1), slots,
                        p.coupled)
        c_d = gather_pages(pool["c_kv"], page_table)           # (B, S, r)
        kr_d = gather_pages(pool["k_rope"], page_table)
        idx = torch.arange(c_d.shape[1], device=x.device)
        vmask = idx[None, None, :] <= positions[:, :, None]    # (B, C, S)
        out = layers.mla_absorbed_attention(p, q_nope, q_rope, c_d, kr_d,
                                            vmask, cfg)
    return tp_row_dot(out.to(x.dtype), p.wo)


def mla_prefill_chunk_paged(p: layers.MLA, x: torch.Tensor, cfg: ModelConfig,
                            pool: dict, page_table, start, valid, *,
                            window=None) -> torch.Tensor:
    """One MLA prefill chunk: scatter the chunk's latents, then attend by
    per-head expansion of the gathered latent view (the prefill path of
    ``mla_forward``, continued at per-slot offsets)."""
    assert window is None, "MLA layers are full-attention"
    b, c, _ = x.shape
    ar = torch.arange(c, device=x.device)
    positions = start[:, None].long() + ar[None, :]
    with span("mla_attention"):
        q_nope, q_rope, c_kv, k_rope = layers._mla_qc(p, x, cfg, positions)
        ok = ar[None, :] < valid[:, None]
        slots = chunk_slots(page_table, positions, ok, pool["c_kv"].shape[1])
        _scatter_latent(pool, c_kv.flatten(0, 1), k_rope.flatten(0, 1), slots,
                        p.coupled)
        c_d = gather_pages(pool["c_kv"], page_table)
        kr_d = gather_pages(pool["k_rope"], page_table)
        out = layers.mla_expanded_attention(p, q_nope, q_rope, c_d, kr_d, cfg,
                                            q_offset=start)
    return tp_row_dot(out.reshape(b, c, cfg.n_heads * cfg.v_hd), p.wo)


# ---------------------------------------------------------------------------
# Backend descriptor + registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttentionBackend:
    """One attention family's implementations and cache layout."""
    name: str
    paged_leaf_keys: tuple[str, ...]        # pool leaves with a token axis
    mask_families: tuple[str, ...]          # dense paths
    paged_mask_families: tuple[str, ...]    # paged paths
    init: Callable[..., Any]
    init_cache: Callable[..., dict]
    forward: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    # the ``nn.Module`` holding one layer's attention weights:
    # ``module(cfg, device)``, filled by ``init(module, gen, cfg)``
    module: Callable[..., Any]
    init_page_pool: Callable[..., dict] | None = None
    decode_paged: Callable[..., Any] | None = None
    prefill_chunk_paged: Callable[..., Any] | None = None
    # multi-token decode (speculative verify): C queries per slot at
    # per-row offsets over the paged pools
    decode_multi_paged: Callable[..., Any] | None = None
    # leaf key -> the unstacked pool-leaf dim that shards over a tensor-
    # parallel mesh's model axis (None = replicated); read by the pool
    # pricing (``parallel.plan.paged_kv_token_bytes``)
    paged_partition_spec: dict[str, int | None] | None = None

    @property
    def supports_paged(self) -> bool:
        return self.init_page_pool is not None


_REGISTRY: dict[str, AttentionBackend] = {}

# block kind -> backend name; kinds without attention (ssm) map to None
KIND_BACKEND: dict[str, str | None] = {
    "attn_dense": "gqa",
    "attn_moe": "gqa",
    "hybrid": "gqa",          # the attention half; SSM state is separate
    "mla_dense": "mla",
    "mla_moe": "mla",
    "ssm": None,
}


def register_backend(backend: AttentionBackend) -> AttentionBackend:
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> AttentionBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown attention backend {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def backend_for_kind(kind: str) -> AttentionBackend | None:
    try:
        name = KIND_BACKEND[kind]
    except KeyError:
        raise ValueError(f"unknown block kind {kind!r}") from None
    return get_backend(name) if name else None


# ---------------------------------------------------------------------------
# Cache layouts: what a block kind keeps resident per serving slot
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """Per-slot cache residency contract for one block kind: ``kv`` (the
    kind writes token-indexed pages; full-context or ring is a property of
    the segment's window, ``runtime.state_cache.SegmentCacheLayout``),
    ``state`` (constant-size recurrent state pooled per slot),
    ``init_state_pool`` (``(cfg, num_slots, *, device) -> pools``) and
    ``state_partition_spec`` (leaf key -> sharded dim, or None)."""
    kv: bool
    state: bool
    init_state_pool: Callable[..., dict] | None = None
    state_partition_spec: dict[str, int | None] | None = None


_SSM_STATE_LAYOUT = dict(
    state=True,
    init_state_pool=ssm_lib.init_ssm_state,
    state_partition_spec={"conv": None, "ssm": None},
)

# block kind -> residency layout.  Attention kinds are pure-KV; ssm is
# pure-state; hybrid blocks own both a KV half and a state half in the
# same slot.
KIND_LAYOUT: dict[str, CacheLayout] = {
    "attn_dense": CacheLayout(kv=True, state=False),
    "attn_moe": CacheLayout(kv=True, state=False),
    "mla_dense": CacheLayout(kv=True, state=False),
    "mla_moe": CacheLayout(kv=True, state=False),
    "hybrid": CacheLayout(kv=True, **_SSM_STATE_LAYOUT),
    "ssm": CacheLayout(kv=False, **_SSM_STATE_LAYOUT),
}


def layout_for_kind(kind: str) -> CacheLayout:
    try:
        return KIND_LAYOUT[kind]
    except KeyError:
        raise ValueError(f"unknown block kind {kind!r}") from None


GQA = register_backend(AttentionBackend(
    name="gqa",
    paged_leaf_keys=("k", "v"),
    mask_families=("prefix", "sliding"),
    paged_mask_families=("prefix", "sliding"),
    init=layers.init_attn,
    init_cache=layers.init_attn_cache,
    forward=layers.attn_forward,
    prefill=layers.attn_prefill,
    decode=layers.attn_decode,
    module=layers.Attention,
    init_page_pool=init_attn_page_pool,
    decode_paged=attn_decode_paged,
    prefill_chunk_paged=attn_prefill_chunk_paged,
    decode_multi_paged=attn_decode_multi_paged,
    # (P, page, KVH, HD) codes + (P, page, KVH) scale metadata: KV heads
    paged_partition_spec={"k": 2, "v": 2, "k_scale": 2, "v_scale": 2},
))

MLA = register_backend(AttentionBackend(
    name="mla",
    paged_leaf_keys=("c_kv", "k_rope"),
    mask_families=("prefix",),
    paged_mask_families=("prefix",),
    init=layers.init_mla,
    init_cache=lambda cfg, batch, max_len, window=None, dtype=torch.bfloat16,
    *, device: layers.init_mla_cache(cfg, batch, max_len, dtype,
                                     device=device),
    forward=lambda p, x, cfg, *, window=None, positions=None:
        layers.mla_forward(p, x, cfg, positions=positions),
    prefill=lambda p, x, cfg, cache, *, window=None:
        layers.mla_prefill(p, x, cfg, cache),
    decode=lambda p, x, cfg, cache, cur_pos, *, window=None, positions,
    cur_len: layers.mla_decode(p, x, cfg, cache, cur_pos,
                               positions=positions),
    module=layers.MLA,
    init_page_pool=init_mla_page_pool,
    decode_paged=mla_decode_paged,
    prefill_chunk_paged=mla_prefill_chunk_paged,
    decode_multi_paged=mla_decode_multi_paged,
    # the latent stream is shared by every head: replicated across a
    # tensor-parallel ring
    paged_partition_spec={"c_kv": None, "k_rope": None},
))
