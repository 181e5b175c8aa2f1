"""Strong scaling, ISO-TDP, and energy/cost studies (paper §VII-§VIII).

Reproduces the quantitative structure of Figs 9-13:
  * ``rpu_point``      — latency/energy of an N-CU RPU for one model, with
                         the optimal HBM-CO SKU selected per §VII.
  * ``strong_scaling`` — sweep CU counts; speedup + the broadcast plateau.
  * ``iso_tdp_cus``    — CU count matching a GPU system's TDP.
  * ``system_cost``    — silicon + memory + substrate + PCB cost model
                         (Fig 12 bottom).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import hardware
from repro_torch.core.hbmco import (CANDIDATE_CO, HBM3E_LIKE, HBMCOConfig,
                              enumerate_design_space, pareto_frontier,
                              select_sku)
from repro_torch.models.common import ModelConfig
from repro_torch.models.footprint import compute_footprint
from repro_torch.sim.compiler import CompileOptions, compile_decode_step
from repro_torch.sim.engine import SimResult, simulate_program
from repro_torch.sim.gpu_model import (GPUSystemConfig, gpu_decode_latency,
                                 min_gpus_for_model)

# Cost model constants (normalized to one HBM3e module == 1.0, matching
# core.hbmco).  Compute chiplet ~60mm2 N2-class die; packaging per §IV.
# Calibrated so that (a) fixed-HBM3e vs HBM-CO total-cost ratio at the
# 405B latency-optimal scale lands near the paper's 12.4x and (b) the
# memory:compute cost ratio at scale matches an 8xH100 DGX (paper §VIII).
COMPUTE_COST_PER_CU = 0.11
SUBSTRATE_COST_PER_PACKAGE = 0.02     # 4 CUs per package
PCB_COST_PER_RING = 0.08              # ring station + board, per 32 packages


@dataclasses.dataclass
class RPUPoint:
    n_cus: int
    sku: HBMCOConfig
    sim: SimResult
    tdp_w: float
    cost: float
    ms_per_token: float

    @property
    def tokens_per_s(self) -> float:
        return 1e3 / self.ms_per_token


def cu_tdp_w(rpu: hardware.RPUChipParams, sku: HBMCOConfig) -> float:
    """CU TDP: memory stream power at the SKU's energy/bit is 70-80% of the
    budget (paper §IV provisioning)."""
    return rpu.cu_tdp_w(sku.energy_pj_per_bit)


def select_sku_for(cfg: ModelConfig, n_cus: int, *, batch: int = 1,
                   seq_len: int = 8192, frontier=None) -> HBMCOConfig | None:
    """Optimal SKU = smallest frontier capacity fitting weights+KV per
    chiplet (2 memory chiplets per CU)."""
    fp = compute_footprint(cfg)
    need = fp.capacity_bytes(batch, seq_len) / (n_cus * 2)
    return select_sku(need, frontier)


def rpu_point(cfg: ModelConfig, n_cus: int, *, batch: int = 1,
              seq_len: int = 8192,
              rpu: hardware.RPUChipParams = hardware.RPU_DEFAULT,
              sku: HBMCOConfig | None = None,
              decoupled: bool = True,
              fine_grained_net: bool = True) -> RPUPoint | None:
    """Simulate one (model, n_cus) deployment; None if no SKU fits."""
    if sku is None:
        sku = select_sku_for(cfg, n_cus, batch=batch, seq_len=seq_len)
    if sku is None:
        return None
    prog = compile_decode_step(cfg, CompileOptions(
        n_cus=n_cus, batch=batch, seq_len=seq_len))
    sim = simulate_program(prog, rpu=rpu, mem=sku, decoupled=decoupled,
                           fine_grained_net=fine_grained_net)
    return RPUPoint(
        n_cus=n_cus, sku=sku, sim=sim,
        tdp_w=n_cus * cu_tdp_w(rpu, sku),
        cost=system_cost(n_cus, sku)["total"],
        ms_per_token=sim.latency_s * 1e3,
    )


def system_cost(n_cus: int, sku: HBMCOConfig) -> dict:
    """Fig 12 (bottom): silicon / memory / substrate / PCB breakdown."""
    silicon = n_cus * COMPUTE_COST_PER_CU
    memory = n_cus * 2 * sku.module_cost
    substrate = math.ceil(n_cus / 4) * SUBSTRATE_COST_PER_PACKAGE
    pcb = math.ceil(n_cus / 128) * PCB_COST_PER_RING
    return {"silicon": silicon, "memory": memory, "substrate": substrate,
            "pcb": pcb, "total": silicon + memory + substrate + pcb}


def iso_tdp_cus(target_w: float, sku: HBMCOConfig,
                rpu: hardware.RPUChipParams = hardware.RPU_DEFAULT) -> int:
    return max(1, int(target_w / cu_tdp_w(rpu, sku)))


def min_cus_for_model(cfg: ModelConfig, *, batch: int = 1,
                      seq_len: int = 8192, frontier=None) -> int:
    """Smallest CU count for which some frontier SKU fits the model."""
    if frontier is None:
        frontier = pareto_frontier(enumerate_design_space())
    biggest = max(frontier, key=lambda c: c.capacity_bytes)
    fp = compute_footprint(cfg)
    need = fp.capacity_bytes(batch, seq_len)
    return max(1, math.ceil(need / (2 * biggest.capacity_bytes)))


def strong_scaling(cfg: ModelConfig, cu_counts, *, batch: int = 1,
                   seq_len: int = 8192) -> list[RPUPoint]:
    out = []
    for n in cu_counts:
        p = rpu_point(cfg, n, batch=batch, seq_len=seq_len)
        if p is not None:
            out.append(p)
    return out


def iso_tdp_comparison(cfg: ModelConfig, *, batch: int = 1,
                       seq_len: int = 8192,
                       gpu_spec: hardware.GPUSpec = hardware.H100) -> dict:
    """Paper Fig 11/13 headline: RPU at the GPU system's TDP."""
    n_gpus = min_gpus_for_model(cfg, gpu_spec, batch=batch, seq_len=seq_len)
    gpu = GPUSystemConfig(chip=gpu_spec, n_gpus=n_gpus)
    g = gpu_decode_latency(cfg, gpu, batch=batch, seq_len=seq_len)

    # pick the SKU iteratively: CU count depends on SKU TDP, SKU on count.
    frontier = pareto_frontier(enumerate_design_space())
    n_cus = 64
    sku = None
    for _ in range(8):
        sku = select_sku_for(cfg, n_cus, batch=batch, seq_len=seq_len,
                             frontier=frontier)
        if sku is None:
            n_cus *= 2
            continue
        new_n = iso_tdp_cus(gpu.tdp_w, sku)
        if new_n == n_cus:
            break
        n_cus = new_n
    point = rpu_point(cfg, n_cus, batch=batch, seq_len=seq_len, sku=sku)
    tok = batch  # tokens produced per step
    return {
        "model": cfg.name,
        "n_gpus": n_gpus,
        "gpu_tdp_w": gpu.tdp_w,
        "gpu_ms_per_token": g.total_s * 1e3,
        "gpu_energy_per_token_j": g.energy_j,
        "rpu_cus": point.n_cus,
        "rpu_tdp_w": point.tdp_w,
        "rpu_ms_per_token": point.ms_per_token,
        "rpu_energy_per_token_j": point.sim.energy_j,
        "sku": point.sku.name,
        "speedup": g.total_s * 1e3 / point.ms_per_token,
        "energy_ratio": g.energy_j / max(point.sim.energy_j, 1e-12),
        "throughput_ratio": (tok / point.ms_per_token) / (tok / (g.total_s * 1e3)),
    }
