"""Compiler: ModelConfig -> RPU instruction streams (paper §VI).

Lowers one **decode step** (the latency-critical path the paper optimizes)
into per-layer phase streams, following the paper's Fig 8 layer anatomy:

  wQKV VMM   — weight streaming, gated by the activation ring-broadcast
  SDPA       — KV$ streaming (query-unique => batch-scaled), gated by the
               Q/KV head gather + softmax max/expsum reductions
  wO VMM     — output projection (column-sharded: fragments stay distributed)
  MLP / MoE  — wUp/wGate (+ routed experts), gated by activation broadcast
  SSM        — state update (mamba/hybrid): weights + state read/write

All quantities are **per CU** under the paper's fine-grained sharding
(weights column-sharded across all CUs; KV$ sharded across CUs).
Deployment dtypes follow the paper: MXFP4 weights (4.25 b/elem incl.
scales), FP8 KV$, BF16 activations.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig
from repro_torch.models.footprint import (
    _attn_params, _mla_params, _mlp_params, _moe_params, _ssm_params,
)
from repro_torch.models.model import build_plan
from repro_torch.sim.isa import LayerProgram, Phase, Program

WEIGHT_BYTES = 4.25 / 8.0      # MXFP4 + E8M0 scales
KV_BYTES = 1.0                 # FP8 KV$
ACT_BYTES = 2.0                # BF16 activations


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    n_cus: int = 64
    batch: int = 1
    seq_len: int = 8192
    weight_bytes: float = WEIGHT_BYTES
    kv_bytes: float = KV_BYTES
    act_bytes: float = ACT_BYTES


def _unique_experts(e: int, k: int, tokens: int) -> float:
    """Expected number of distinct experts activated by ``tokens`` top-k
    draws (uniform routing assumption)."""
    if e == 0:
        return 0.0
    return e * (1.0 - (1.0 - min(k / e, 1.0)) ** tokens)


def _ring_hops(c: int, cus_per_package: int = 4) -> int:
    """Ring-broadcast hop count on the hierarchical topology (paper §IV):
    short UCIe hops within a 4-CU package, then the package-level outer
    ring via ring stations — so a full broadcast traverses
    (packages + in-package) hops, not one hop per CU."""
    import math
    return max(1, math.ceil(c / cus_per_package)) + min(c, cus_per_package)


def _attn_phases(cfg: ModelConfig, o: CompileOptions, window) -> list[Phase]:
    c, b = o.n_cus, o.batch
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s_eff = min(o.seq_len, window) if window else o.seq_len
    qkv_p = d * h * hd + 2 * d * kvh * hd
    o_p = h * hd * d
    kv_read = 2 * kvh * hd * s_eff * b * o.kv_bytes
    sdpa_flops = 2 * 2 * h * hd * s_eff * b           # QK^T + PV
    bcast_bytes = b * d * o.act_bytes
    gather_bytes = b * (h + 2 * kvh) * hd * o.act_bytes / c
    return [
        Phase("wqkv", mem_bytes=qkv_p * o.weight_bytes / c,
              flops=2 * qkv_p * b / c,
              net_bytes=bcast_bytes, net_hops=_ring_hops(c), overlap_net=True,
              kind="vmm"),
        Phase("sdpa", mem_bytes=kv_read / c + 2 * kvh * hd * b * o.kv_bytes / c,
              flops=sdpa_flops / c,
              net_bytes=gather_bytes * 3,
              net_hops=3 * _ring_hops(max(1, c // max(1, kvh))), kind="sdpa"),
        Phase("wo", mem_bytes=o_p * o.weight_bytes / c,
              flops=2 * o_p * b / c, kind="vmm"),
    ]


def _mla_phases(cfg: ModelConfig, o: CompileOptions) -> list[Phase]:
    c, b = o.n_cus, o.batch
    d, h = cfg.d_model, cfg.n_heads
    hd, rhd, vhd, r = cfg.hd, cfg.rope_head_dim, cfg.v_hd, cfg.kv_lora_rank
    p_total = _mla_params(cfg)
    kv_read = (r + rhd) * o.seq_len * b * o.kv_bytes
    # absorbed-latent attention: q_lat (H, r) . c_kv (S, r) + ctx expansion
    sdpa_flops = 2 * h * (r + rhd) * o.seq_len * b + 2 * h * r * vhd * b
    bcast_bytes = b * d * o.act_bytes
    return [
        Phase("mla_proj", mem_bytes=p_total * o.weight_bytes / c,
              flops=2 * p_total * b / c,
              net_bytes=bcast_bytes, net_hops=_ring_hops(c), overlap_net=True,
              kind="vmm"),
        Phase("mla_sdpa", mem_bytes=kv_read / c,
              flops=sdpa_flops / c,
              net_bytes=b * h * (r + rhd) * o.act_bytes / c * 3,
              net_hops=3 * _ring_hops(max(1, c // max(1, h))), kind="sdpa"),
    ]


def _mlp_phases(cfg: ModelConfig, o: CompileOptions, d_ff: int) -> list[Phase]:
    c, b, d = o.n_cus, o.batch, cfg.d_model
    up = 2 * d * d_ff
    down = d_ff * d
    bcast_bytes = b * d * o.act_bytes
    return [
        Phase("wupgate", mem_bytes=up * o.weight_bytes / c,
              flops=2 * up * b / c,
              net_bytes=bcast_bytes, net_hops=_ring_hops(c), overlap_net=True,
              kind="vmm"),
        Phase("wdown", mem_bytes=down * o.weight_bytes / c,
              flops=2 * down * b / c, kind="vmm"),
    ]


def _moe_phases(cfg: ModelConfig, o: CompileOptions) -> list[Phase]:
    c, b, d = o.n_cus, o.batch, cfg.d_model
    fe = cfg.moe_d_ff or cfg.d_ff
    e, k = cfg.n_experts, cfg.n_experts_per_token
    phases: list[Phase] = []
    bcast_bytes = b * d * o.act_bytes
    if cfg.n_shared_experts:
        sh = 3 * d * fe * cfg.n_shared_experts
        phases.append(Phase("moe_shared", mem_bytes=sh * o.weight_bytes / c,
                            flops=2 * sh * b / c,
                            net_bytes=bcast_bytes, net_hops=_ring_hops(c),
                            overlap_net=True, kind="vmm"))
    uniq = _unique_experts(e, k, b)
    exp_w = uniq * 3 * d * fe                      # streamed expert weights
    exp_f = 2 * k * 3 * d * fe * b                 # routed compute
    phases.append(Phase("moe_experts", mem_bytes=exp_w * o.weight_bytes / c,
                        flops=exp_f / c,
                        net_bytes=b * d * o.act_bytes, net_hops=_ring_hops(c),
                        overlap_net=True, kind="moe"))
    return phases


def _ssm_phases(cfg: ModelConfig, o: CompileOptions) -> list[Phase]:
    c, b = o.n_cus, o.batch
    p_total = _ssm_params(cfg)
    h, pd, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    state_elems = h * pd * n
    state_rw = 2 * state_elems * 4.0 * b           # f32 state read+write
    upd_flops = 6 * state_elems * b
    return [
        Phase("ssm", mem_bytes=(p_total * o.weight_bytes + state_rw) / c,
              flops=(2 * p_total * b + upd_flops) / c,
              net_bytes=b * cfg.d_model * o.act_bytes, net_hops=_ring_hops(c),
              overlap_net=True, kind="vmm"),
    ]


def compile_decode_step(cfg: ModelConfig, opts: CompileOptions) -> Program:
    """Lower one decode step to the per-CU phase program."""
    layers: list[LayerProgram] = []
    for seg in build_plan(cfg):
        seg_phases: list[Phase] = []
        for kind in seg.kinds:
            if kind in ("attn_dense", "attn_moe", "hybrid"):
                seg_phases += _attn_phases(cfg, opts, seg.window)
            if kind in ("mla_dense", "mla_moe"):
                seg_phases += _mla_phases(cfg, opts)
            if kind in ("ssm", "hybrid"):
                seg_phases += _ssm_phases(cfg, opts)
            if kind in ("attn_dense", "mla_dense", "hybrid"):
                seg_phases += _mlp_phases(cfg, opts, cfg.d_ff)
            if kind in ("attn_moe", "mla_moe"):
                seg_phases += _moe_phases(cfg, opts)
        layers.append(LayerProgram(f"seg{len(layers)}", seg_phases, seg.reps))

    # LM head (the final VMM) + logits gather
    c, b, d, v = opts.n_cus, opts.batch, cfg.d_model, cfg.vocab_size
    head = LayerProgram("head", [
        Phase("lm_head", mem_bytes=d * v * opts.weight_bytes / c,
              flops=2 * d * v * b / c,
              net_bytes=b * d * opts.act_bytes, net_hops=_ring_hops(c),
              overlap_net=True, kind="vmm"),
    ])
    layers.append(head)
    return Program(cfg.name, layers, batch=opts.batch, seq_len=opts.seq_len,
                   n_cus=opts.n_cus)
