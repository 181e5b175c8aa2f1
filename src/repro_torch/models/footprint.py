"""Analytical memory/compute footprints per ModelConfig.

Used by the RPU simulator (§VI), the HBM-CO SKU selection map (Fig 10),
and the roofline benchmarks.  All byte counts are exact functions of the
config — the same arithmetic the paper uses for "active parameters" and
"KV$ fraction".

A copy of ``repro/models/footprint.py`` with its imports redirected to the
port's ``ModelConfig`` and ``build_plan``, which plans every kind the
reference plans (ssm and hybrid included).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig
from repro_torch.models.model import build_plan


def _attn_params(cfg: ModelConfig) -> int:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n = d * h * hd + 2 * d * kvh * hd + h * hd * d
    if cfg.qkv_bias:
        n += h * hd + 2 * kvh * hd
    return n


def _mla_params(cfg: ModelConfig) -> int:
    d, h = cfg.d_model, cfg.n_heads
    hd, rhd, vhd, r = cfg.hd, cfg.rope_head_dim, cfg.v_hd, cfg.kv_lora_rank
    return (d * h * (hd + rhd) + d * (r + rhd)
            + r * h * hd + r * h * vhd + h * vhd * d)


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    return 3 * cfg.d_model * d_ff


def _moe_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active-per-token) for one MoE layer."""
    fe = cfg.moe_d_ff or cfg.d_ff
    per_exp = 3 * cfg.d_model * fe
    total = cfg.n_experts * per_exp + cfg.d_model * cfg.n_experts
    active = cfg.n_experts_per_token * per_exp + cfg.d_model * cfg.n_experts
    if cfg.n_shared_experts:
        shared = 3 * cfg.d_model * fe * cfg.n_shared_experts
        total += shared
        active += shared
    return total, active


def _ssm_params(cfg: ModelConfig) -> int:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
    conv_dim = di + 2 * g * n
    return (d * (2 * di + 2 * g * n + h) + cfg.conv_kernel * conv_dim
            + conv_dim + 3 * h + di + di * d)


@dataclasses.dataclass(frozen=True)
class Footprint:
    """Byte/param accounting for one architecture."""

    cfg: ModelConfig
    total_params: int
    active_params: int          # streamed per generated token (excl. embed table)
    kv_per_token: int           # KV$ *elements* per token per sequence
    state_elems: int            # fixed recurrent state elements per sequence

    def param_bytes(self, bits_per_weight: float = 4.25) -> float:
        return self.total_params * bits_per_weight / 8.0

    def active_param_bytes(self, bits_per_weight: float = 4.25) -> float:
        return self.active_params * bits_per_weight / 8.0

    def kv_bytes_per_token(self, kv_bytes: int = 1) -> float:
        """fp8 KV$ by default (paper's 'FP8 KV$' deployment)."""
        return self.kv_per_token * kv_bytes

    def kv_bytes(self, batch: int, seq_len: int, kv_bytes: int = 1) -> float:
        cfg = self.cfg
        eff = seq_len
        if cfg.sliding_window:
            eff = min(seq_len, cfg.sliding_window)
        return (self.kv_per_token * eff + self.state_elems) * kv_bytes * batch

    def capacity_bytes(self, batch: int, seq_len: int,
                       bits_per_weight: float = 4.25, kv_bytes: int = 1) -> float:
        return self.param_bytes(bits_per_weight) + self.kv_bytes(batch, seq_len, kv_bytes)

    def streamed_bytes_per_token(self, batch: int, seq_len: int,
                                 bits_per_weight: float = 4.25,
                                 kv_bytes: int = 1) -> float:
        """Bytes read from memory per decode step: every active weight once
        (shared across the batch) + each query's unique KV history."""
        return (self.active_param_bytes(bits_per_weight)
                + self.kv_bytes(batch, seq_len, kv_bytes))

    def decode_flops_per_token(self, batch: int, seq_len: int) -> float:
        """MACs*2 per decode step (batch shares weights; KV$ is per-query).
        Sliding-window archs only attend over the window."""
        eff = seq_len
        if self.cfg.sliding_window:
            eff = min(seq_len, self.cfg.sliding_window)
        w_flops = 2.0 * self.active_params * batch
        kv_flops = 2.0 * self.kv_per_token * eff * batch
        return w_flops + kv_flops


def compute_footprint(cfg: ModelConfig) -> Footprint:
    plan = build_plan(cfg)
    total = 0
    active = 0
    kv_per_tok = 0
    state = 0
    for seg in plan:
        for kind in seg.kinds:
            lt = la = lkv = lst = 0
            if kind in ("attn_dense", "attn_moe", "hybrid"):
                lt += _attn_params(cfg)
                # window caps the stored KV, handled in kv_bytes(); per-token
                # element count here:
                lkv += 2 * cfg.n_kv_heads * cfg.hd
            if kind in ("mla_dense", "mla_moe"):
                lt += _mla_params(cfg)
                lkv += cfg.kv_lora_rank + cfg.rope_head_dim
            if kind in ("attn_dense", "mla_dense", "hybrid"):
                lt += _mlp_params(cfg, cfg.d_ff)
            if kind in ("attn_moe", "mla_moe"):
                t, a = _moe_params(cfg)
                lt += t
                la += a + _attn_params(cfg) if kind == "attn_moe" else a + _mla_params(cfg)
            if kind in ("ssm", "hybrid"):
                lt += _ssm_params(cfg)
                lst += (cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
                        + (cfg.conv_kernel - 1) * (cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state))
            if la == 0:
                la = lt                      # dense layer: all params active
            total += lt * seg.reps
            active += la * seg.reps
            kv_per_tok += lkv * seg.reps
            state += lst * seg.reps
    d, v = cfg.d_model, cfg.vocab_size
    if cfg.frontend == "audio":
        total += d * d + d * v
        active += d * d + d * v
    else:
        total += v * d + (0 if cfg.tie_embeddings else d * v)
        active += d + d * v                  # one embed row + the lm head
    return Footprint(cfg, total, active, kv_per_tok, state)
