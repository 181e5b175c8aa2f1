"""Hardware constants for the RPU reproduction.

Three roles:
  * ``TPU_V5E`` — the *target* chip for the JAX/Pallas framework itself
    (roofline analysis in ``core.roofline`` uses these numbers).
  * ``H100`` / ``H200`` — the paper's GPU baselines (§II, Fig 11-14),
    calibrated with the paper's measured utilization numbers.
  * ``RPUChipParams`` — the RPU compute-unit parameters from §IV/§V used by
    the analytical + event-driven simulator.

All bandwidths are bytes/second, energies pJ/bit unless noted.
"""
from __future__ import annotations

import dataclasses

# ----------------------------------------------------------------------------
# TPU v5e — roofline target for the JAX framework (per system prompt).
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """A generic accelerator chip for roofline arithmetic."""

    name: str
    peak_flops_bf16: float        # FLOP/s
    hbm_bw: float                 # bytes/s
    ici_link_bw: float            # bytes/s per link (uni-directional)
    ici_links: int                # usable links per chip
    hbm_capacity: float           # bytes
    tdp_w: float                  # watts

    @property
    def ops_per_byte(self) -> float:
        """Compute-to-bandwidth ratio (the paper's central provisioning metric)."""
        return self.peak_flops_bf16 / self.hbm_bw


TPU_V5E = ChipSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,       # 197 TFLOP/s bf16
    hbm_bw=819e9,                 # 819 GB/s
    ici_link_bw=50e9,             # ~50 GB/s per ICI link
    ici_links=4,                  # 2D torus on v5e
    hbm_capacity=16 * 2**30,
    tdp_w=250.0,
)

# ----------------------------------------------------------------------------
# GPU baselines (paper §II measurements drive the efficiency factors).
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GPUSpec(ChipSpec):
    """GPU baseline with the paper's measured decode-phase derates."""

    # Paper §II: "H100 only utilizes 32% of its peak memory bandwidth during
    # distributed LLM decode"; full BW only reached for working sets > ~1GB.
    decode_bw_utilization: float = 0.32
    # Compute efficiency for the large, compute-bound phases (prefill ~90% TDP,
    # high utilization). Dense-kernel sustained fraction of peak.
    compute_efficiency: float = 0.70
    # Kernel launch + scheduling overhead per kernel (paper §II cites launch
    # overheads "non-negligible for small kernel sizes"; ~ microseconds).
    kernel_launch_s: float = 4.0e-6
    # NVLink per-direction aggregate bandwidth (bytes/s) and per-collective
    # latency for TP collectives.
    nvlink_bw: float = 450e9
    collective_latency_s: float = 9.0e-6


H100 = GPUSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,       # dense bf16 (with sparsity excluded)
    hbm_bw=3.35e12,               # HBM3 3.35 TB/s
    ici_link_bw=450e9,            # NVLink4 aggregate per direction
    ici_links=1,
    hbm_capacity=80 * 2**30,
    tdp_w=700.0,
)

H200 = GPUSpec(
    name="h200_sxm",
    peak_flops_bf16=989e12,
    hbm_bw=4.8e12,                # HBM3e 4.8 TB/s
    ici_link_bw=450e9,
    ici_links=1,
    hbm_capacity=141 * 2**30,
    tdp_w=700.0,
)

# ----------------------------------------------------------------------------
# RPU parameters (paper §IV/§V).
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RPUChipParams:
    """One RPU Compute Unit (CU) and its reasoning cores.

    Paper §IV: each CU = 1 compute chiplet + 2 HBM-CO chiplets; dual 256 GB/s
    shorelines (512 GB/s per CU); 32 OPs/Byte ⇒ 8 TOPS per 256 GB/s shoreline
    (16 TOPS per CU); 16 reasoning cores per CU (8 per shoreline), each core
    with four 8x8 TMACs fed by one 32 GB/s pseudo-channel.
    """

    cores_per_cu: int = 16
    tmacs_per_core: int = 4
    macs_per_tmac: int = 64                   # 8x8 array
    core_clock_hz: float = 1.0e9
    pch_bw: float = 32e9                      # bytes/s per core (pseudo-channel)
    cu_mem_bw: float = 512e9                  # bytes/s per CU (dual shoreline)
    ops_per_byte: float = 32.0                # provisioned compute : BW ratio
    # ⇒ compute per CU = 32 OPs/B × 512 GB/s = 16.384 TOPS
    cus_per_package: int = 4
    # Network: UCIe in-package + PCB ring (§IV). Outer-ring BW and hop latency.
    cu_hop_latency_s: float = 10e-9           # ≤10ns per CU-to-CU hop
    ring_bw: float = 128e9                    # bytes/s outer-ring per direction
    # on-chip buffer per core (SRAM memory+network buffers, §V / Fig 8 shows
    # ~6MB per-CU lookahead ⇒ ~384KB/core usable staging; round to 512KB)
    buffer_bytes_per_core: int = 512 * 1024
    # Power (paper §IV: 70-80% of power to memory interfaces).
    mem_power_fraction: float = 0.75
    # Compute datapath energy (paper Fig 8 text: ~1.7 pJ/b datapath to write
    # memory buffer; ~5W/CU at full compute utilization).
    compute_w_per_cu_peak: float = 5.0
    sram_pj_per_bit: float = 1.7
    # Network energies (UCIe §IV): in-package 0.5 pJ/b, off-package 0.75-1.2.
    net_pj_per_bit_in_pkg: float = 0.5
    net_pj_per_bit_off_pkg: float = 1.0

    @property
    def cu_tops(self) -> float:
        """Provisioned OPs/s per CU."""
        return self.ops_per_byte * self.cu_mem_bw

    @property
    def core_tops(self) -> float:
        return self.cu_tops / self.cores_per_cu

    def cu_tdp_w(self, mem_pj_per_bit: float) -> float:
        """TDP of one CU given its memory device energy (paper: memory power
        dominates; peak power ≈ mem stream power / mem_power_fraction)."""
        mem_w = self.cu_mem_bw * 8 * mem_pj_per_bit * 1e-12
        return mem_w / self.mem_power_fraction


RPU_DEFAULT = RPUChipParams()

# Useful time constants
US = 1e-6
MS = 1e-3
GB = 1e9
GIB = float(2**30)
