"""Analytical H100/H200 decode baseline, calibrated to the paper's §II
profiling:

  * 32% of peak HBM bandwidth sustained during distributed low-batch decode
    (Fig 2 right; "consistent with prior work [33],[52],[68]").
  * full bandwidth only for >~1GB working sets; dense-kernel compute at
    ~70% of peak for the large compute-bound phases.
  * kernel-launch overhead ~4us/kernel; TP collective latency ~9us
    (§II "kernel launch overheads become non-negligible...").
  * decode phase draws ~34% of TDP (Fig 2 left).

Deployment dtypes for the comparison follow §VIII: 4-bit weights (MARLIN
[18]) + 16-bit activations, KV$ 16-bit.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import hardware
from repro_torch.models.common import ModelConfig
from repro_torch.models.footprint import Footprint, compute_footprint


@dataclasses.dataclass(frozen=True)
class GPUSystemConfig:
    chip: hardware.GPUSpec = hardware.H100
    n_gpus: int = 1
    weight_bits: float = 4.25         # MARLIN 4-bit + scales
    kv_bits: float = 16.0
    kernels_per_layer: int = 10       # qkv, rope, sdpa(2), o, 2xnorm, 3xmlp
    collectives_per_layer: int = 2    # Megatron TP: attn + mlp all-reduce

    @property
    def tdp_w(self) -> float:
        return self.chip.tdp_w * self.n_gpus


@dataclasses.dataclass
class GPULatency:
    total_s: float
    mem_s: float
    comp_s: float
    overhead_s: float
    bw_utilization: float
    energy_j: float              # per generated token

    @property
    def tokens_per_s(self) -> float:
        return 1.0 / self.total_s if self.total_s else 0.0


def _bw_utilization(gpu: GPUSystemConfig, working_set_bytes: float,
                    batch: int) -> float:
    """Paper Fig 2 (right): utilization grows with per-kernel working set,
    saturating only above ~1GB; low-batch decode measured at 0.32."""
    base = gpu.chip.decode_bw_utilization
    # working set per kernel per GPU ~ largest weight shard
    if working_set_bytes >= 1e9:
        return 0.85
    # log-linear ramp between 128MB (the paper's measured 0.32 regime —
    # Fig 2 right shows full BW "only when the working set exceeds ~1GB")
    lo, hi = 128e6, 1e9
    if working_set_bytes <= lo:
        return base
    f = (math.log(working_set_bytes) - math.log(lo)) / (math.log(hi) - math.log(lo))
    return base + f * (0.85 - base)


def gpu_decode_latency(cfg: ModelConfig, gpu: GPUSystemConfig, *,
                       batch: int = 1, seq_len: int = 8192,
                       fp: Footprint | None = None) -> GPULatency:
    """Per-token decode latency of the GPU baseline (full TP over n_gpus)."""
    fp = fp or compute_footprint(cfg)
    n = gpu.n_gpus
    chip = gpu.chip

    w_bytes = fp.active_param_bytes(gpu.weight_bits)
    kv_bytes = fp.kv_bytes(batch, seq_len, int(gpu.kv_bits // 8))
    stream = (w_bytes + kv_bytes) / n

    # per-kernel working set: one layer's biggest matrix shard per GPU
    biggest = 3 * cfg.d_model * cfg.d_ff * gpu.weight_bits / 8.0 / max(n, 1) / 3
    util = _bw_utilization(gpu, biggest, batch)
    mem_s = stream / (chip.hbm_bw * util)

    flops = fp.decode_flops_per_token(batch, seq_len) / n
    comp_s = flops / (chip.peak_flops_bf16 * chip.compute_efficiency)

    n_layers = cfg.n_layers
    overhead = n_layers * gpu.kernels_per_layer * chip.kernel_launch_s
    if n > 1:
        overhead += n_layers * gpu.collectives_per_layer * chip.collective_latency_s

    total = max(mem_s, comp_s) + overhead
    # §II: decode draws ~34% of TDP
    energy = gpu.tdp_w * 0.34 * total
    return GPULatency(total_s=total, mem_s=mem_s, comp_s=comp_s,
                      overhead_s=overhead, bw_utilization=util, energy_j=energy)


def min_gpus_for_model(cfg: ModelConfig, gpu_spec: hardware.GPUSpec,
                       weight_bits: float = 4.25, *, batch: int = 1,
                       seq_len: int = 8192) -> int:
    """Smallest GPU count whose HBM fits weights + KV$ (power of two)."""
    fp = compute_footprint(cfg)
    need = fp.param_bytes(weight_bits) + fp.kv_bytes(batch, seq_len, 2)
    n = 1
    while n * gpu_spec.hbm_capacity * 0.9 < need:
        n *= 2
    return n
