"""HBM-CO SKU selection map (paper Fig 10).

For a fixed-bandwidth RPU deployment (e.g. 64 CUs = 128 memory chiplets =
32 TB/s), system capacity is tuned by choosing the HBM-CO chiplet SKU from
the Pareto frontier: the smallest capacity that fits

    active parameter bytes + KV-cache bytes(batch, seq)

per device.  High-BW/Cap SKUs maximize efficiency but limit the supported
(batch x seq) envelope; this module reproduces the selection map and the
slowdown model of Fig 10 (bottom).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import hardware
from repro_torch.core.hbmco import HBMCOConfig, enumerate_design_space, pareto_frontier, select_sku


@dataclasses.dataclass(frozen=True)
class WorkloadFootprint:
    """Capacity model of one LLM deployment."""

    name: str
    param_bytes: float                 # total stored parameters (quantized)
    kv_bytes_per_token: float          # per sequence-token KV$ footprint
    active_param_bytes: float          # bytes streamed per generated token

    def capacity_bytes(self, batch: int, seq_len: int) -> float:
        return self.param_bytes + self.kv_bytes_per_token * batch * seq_len

    def streamed_bytes_per_token(self, batch: int, seq_len: int) -> float:
        """Bytes that must be read from memory per generated token step:
        every active parameter once (batched queries share the read) plus
        each query's unique KV history (paper: 'KV$ entries are query-unique')."""
        return self.active_param_bytes + self.kv_bytes_per_token * batch * seq_len

    @classmethod
    def from_model(cls, model, *, weight_format: str | None = None,
                   cache_dtype=None) -> "WorkloadFootprint":
        """Footprint of a built model under a weight/KV quantization choice.

        ``weight_format`` is a ``repro_torch.quant.formats`` name (None = bf16
        storage, 2 bytes/param); ``cache_dtype`` follows the paged-KV pool
        convention ("fp8"/"int8" strings or a torch dtype, None = pool default).
        """
        from repro_torch.models.footprint import compute_footprint
        from repro_torch.parallel.plan import paged_kv_token_bytes
        from repro_torch.quant import formats

        fp = compute_footprint(model.cfg)
        per = (formats.bits_per_element(weight_format) / 8.0
               if weight_format else 2.0)
        kv_tok = paged_kv_token_bytes(model, cache_dtype=cache_dtype)
        return cls(name=model.cfg.name,
                   param_bytes=fp.total_params * per,
                   kv_bytes_per_token=kv_tok,
                   active_param_bytes=fp.active_params * per)


@dataclasses.dataclass(frozen=True)
class SKUCell:
    batch: int
    seq_len: int
    sku: HBMCOConfig | None
    bw_per_cap: float | None
    slowdown_vs_ref: float | None
    kv_fraction: float | None          # fraction of streamed bytes that is KV$


def sku_map(
    workload: WorkloadFootprint,
    batches: Sequence[int],
    seq_lens: Sequence[int],
    *,
    n_cus: int = 64,
    rpu: hardware.RPUChipParams = hardware.RPU_DEFAULT,
    ref_batch: int = 1,
    ref_seq: int = 8192,
) -> list[SKUCell]:
    """Compute the Fig-10 style SKU selection + slowdown map.

    Slowdown is per-query token latency relative to (ref_batch, ref_seq):
    token_time = streamed_bytes / system_bw (memory-bound decode regime).
    """
    chiplets = n_cus * 2
    system_bw = n_cus * rpu.cu_mem_bw
    frontier = pareto_frontier(enumerate_design_space())
    ref_time = workload.streamed_bytes_per_token(ref_batch, ref_seq) / system_bw
    out: list[SKUCell] = []
    for b in batches:
        for s in seq_lens:
            need = workload.capacity_bytes(b, s) / chiplets
            sku = select_sku(need, frontier)
            streamed = workload.streamed_bytes_per_token(b, s)
            kv = workload.kv_bytes_per_token * b * s
            out.append(SKUCell(
                batch=b, seq_len=s, sku=sku,
                bw_per_cap=sku.bw_per_cap if sku else None,
                slowdown_vs_ref=(streamed / system_bw) / ref_time if sku else None,
                kv_fraction=kv / streamed if sku else None,
            ))
    return out
