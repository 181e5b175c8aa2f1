"""HBM-CO: Capacity-Optimized High-Bandwidth Memory (paper §III).

Analytical model of the bandwidth / capacity / energy / cost design space of
stacked DRAM, parameterized over the structures the paper identifies as
capacity-driving but bandwidth-neutral (ranks, banks per bank-group,
sub-arrays i.e. bank capacity) and the bandwidth-driving structures
(layers per rank x channels per layer x pseudo-channels).

Energy-per-bit components (paper §III "Modeling Energy and Cost for HBM-CO"):
  1. Row activation  : 0.18  pJ/bit (streaming; conservative HBM3 timing)
  2. Data movement   : 0.2   pJ/bit/mm x intra-die routing distance
  3. TSV traversal   : 0.148 pJ/bit/layer x mean stack depth
  4. I/O interface   : 0.25  pJ/bit (UCIe / HBM3e DQ)

Calibration targets from the paper:
  * HBM3e-like (4 ranks x 4 layers, 4 ch/layer, 4 banks/group, 24MB banks):
    48 GB, 1024 GB/s (32 pCH x 32 GB/s), ~3.44 pJ/bit  [validated §III]
  * Candidate Pareto point (1 rank, 1 ch/layer, 1 bank/group, 24MB banks):
    768 MB, 256 GB/s, BW/Cap = 341, ~1.45 pJ/bit, 2.4x lower energy,
    ~1.8x higher cost per GB, ~35x lower module cost.

All of these are reproduced by this module and asserted in
``tests/test_hbmco.py``; the derived numbers land within a few percent of the
paper's and the deltas are recorded in EXPERIMENTS.md.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import re
from typing import Iterable, Sequence

# --- energy model constants (paper §III) -----------------------------------
ACT_PJ_PER_BIT = 0.18           # row activation, streaming
DM_PJ_PER_BIT_MM = 0.2          # on-die data movement per mm
TSV_PJ_PER_BIT_LAYER = 0.148    # per stacked layer traversed (0.8 pF TSV)
IO_PJ_PER_BIT = 0.25            # interface I/O

# Routing-distance model: mean on-die routing distance grows with the linear
# dimension of the DRAM array region (wire-length scaling from HBM core-die
# floorplans [35],[47],[54]).  distance = DM_BASE + DM_K * sqrt(array_mm2).
# Calibrated so the HBM3e-like point gives 3.44 pJ/bit total.
DM_BASE_MM = 1.2
DM_K_MM = 0.85
DRAM_DENSITY_GBIT_PER_MM2 = 0.3   # ~1z-nm DRAM array density
ARRAY_AREA_FRACTION = 2.0 / 3.0   # TSV/command/periphery occupy ~1/3 of die

# Bandwidth model: each pseudo-channel sustains 32 GB/s (paper §III);
# pCHs = layers_per_rank x channels_per_layer x 2.
PCH_BW_GBS = 32.0

# Cost model, normalized to an HBM3e-like module == 1.0.  Module cost =
# (#dies x die_area x COST_PER_MM2) + FIXED_COST, where FIXED_COST captures
# the non-amortized base-die logic + TSV footprint + packaging floor.
# Calibrated on (HBM3e-like == 1.0, candidate == 1/35) per the paper's
# "35x lower cost overall" for the 768MB candidate.
_COST_PER_MM2 = 5.142e-4
_FIXED_COST = 0.01275


@dataclasses.dataclass(frozen=True)
class HBMCOConfig:
    """One point in the HBM-CO design space.

    The default values give the paper's candidate Pareto-optimal device.
    """

    name: str = "hbmco"
    ranks: int = 1                    # capacity only (shared interface)
    layers_per_rank: int = 4          # bandwidth: separate channels per layer
    channels_per_layer: int = 1       # bandwidth
    banks_per_group: int = 1          # capacity only (1 active bank suffices)
    bank_groups_per_pch: int = 4      # fixed: 4 pipelined BGs saturate a pCH
    bank_mb: float = 24.0             # capacity only (sub-array count knob)

    # ---------------- derived: bandwidth & capacity ----------------
    @property
    def total_layers(self) -> int:
        return self.ranks * self.layers_per_rank

    @property
    def pseudo_channels(self) -> int:
        # 2 pseudo-channels per channel; only one rank's interface is active.
        return self.layers_per_rank * self.channels_per_layer * 2

    @property
    def bandwidth_gbs(self) -> float:
        return self.pseudo_channels * PCH_BW_GBS

    @property
    def banks_per_layer(self) -> int:
        return (self.channels_per_layer * 2 * self.bank_groups_per_pch
                * self.banks_per_group)

    @property
    def capacity_mb(self) -> float:
        return self.total_layers * self.banks_per_layer * self.bank_mb

    @property
    def capacity_gb(self) -> float:
        return self.capacity_mb / 1024.0

    @property
    def capacity_bytes(self) -> float:
        return self.capacity_mb * 2**20

    @property
    def bw_per_cap(self) -> float:
        """GB/s of bandwidth per GB of capacity — the paper's key metric."""
        return self.bandwidth_gbs / self.capacity_gb

    # ---------------- derived: geometry ----------------
    @property
    def capacity_per_die_gbit(self) -> float:
        return self.capacity_gb * 8.0 / self.total_layers

    @property
    def array_area_mm2(self) -> float:
        return self.capacity_per_die_gbit / DRAM_DENSITY_GBIT_PER_MM2

    @property
    def die_area_mm2(self) -> float:
        return self.array_area_mm2 / ARRAY_AREA_FRACTION

    @property
    def shoreline_mm(self) -> float:
        """IO shoreline; bandwidth per shoreline is held constant across the
        family (paper: HBM-CO "retains ... shoreline bandwidth")."""
        return self.bandwidth_gbs / BW_PER_SHORELINE_GBS_MM

    # ---------------- derived: energy ----------------
    @property
    def mean_route_mm(self) -> float:
        return DM_BASE_MM + DM_K_MM * math.sqrt(self.array_area_mm2)

    @property
    def energy_components_pj_bit(self) -> dict:
        tsv = TSV_PJ_PER_BIT_LAYER * (self.total_layers + 1) / 2.0
        dm = DM_PJ_PER_BIT_MM * self.mean_route_mm
        return {
            "activation": ACT_PJ_PER_BIT,
            "data_movement": dm,
            "tsv": tsv,
            "io": IO_PJ_PER_BIT,
        }

    @property
    def energy_pj_per_bit(self) -> float:
        return sum(self.energy_components_pj_bit.values())

    # ---------------- derived: cost ----------------
    @property
    def module_cost(self) -> float:
        """Normalized module cost (HBM3e-like == 1.0)."""
        silicon = self.total_layers * self.die_area_mm2 * _COST_PER_MM2
        return silicon + _FIXED_COST

    @property
    def cost_per_gb(self) -> float:
        return self.module_cost / self.capacity_gb

    @property
    def bandwidth_per_cost(self) -> float:
        """GB/s per normalized cost unit (paper: 'bandwidth per dollar')."""
        return self.bandwidth_gbs / self.module_cost

    # ---------------- derived: system behaviour ----------------
    @property
    def ideal_token_latency_s(self) -> float:
        """Min token latency at 100% capacity utilization = Cap/BW (§III)."""
        return 1.0 / self.bw_per_cap

    def describe(self) -> str:
        e = self.energy_components_pj_bit
        return (f"{self.name}: {self.capacity_mb:.0f}MB @ {self.bandwidth_gbs:.0f}GB/s "
                f"BW/Cap={self.bw_per_cap:.0f} energy={self.energy_pj_per_bit:.2f}pJ/b "
                f"(act={e['activation']:.2f} dm={e['data_movement']:.2f} "
                f"tsv={e['tsv']:.2f} io={e['io']:.2f}) "
                f"cost={self.module_cost:.4f} (${self.cost_per_gb:.4f}/GB)")


# Shoreline constant: HBM3e-like 1024 GB/s over ~11 mm of shoreline.
BW_PER_SHORELINE_GBS_MM = 1024.0 / 11.0

# ---------------------------------------------------------------------------
# Named reference devices
# ---------------------------------------------------------------------------

HBM3E_LIKE = HBMCOConfig(
    name="hbm3e-like",
    ranks=4, layers_per_rank=4, channels_per_layer=4,
    banks_per_group=4, bank_mb=24.0,
)

# The paper's candidate Pareto-optimal device: 768 MB, 256 GB/s, BW/Cap=341.
CANDIDATE_CO = HBMCOConfig(
    name="hbmco-768MB",
    ranks=1, layers_per_rank=4, channels_per_layer=1,
    banks_per_group=1, bank_mb=24.0,
)


def hbmco_by_name(name: str) -> HBMCOConfig:
    """Look up a named HBM-CO device.

    Accepts the two reference devices ("hbm3e-like", "hbmco-768MB") and
    the ``enumerate_design_space`` naming scheme ``co-r{R}c{C}b{B}m{MB}``
    (e.g. ``co-r1c1b1m24`` — the candidate's knobs), so every point of the
    Fig-5 grid is addressable from a CLI flag or a ``DeploymentSpec``.
    """
    named = {HBM3E_LIKE.name: HBM3E_LIKE, CANDIDATE_CO.name: CANDIDATE_CO}
    if name in named:
        return named[name]
    m = re.fullmatch(r"co-r(\d+)c(\d+)b(\d+)m([0-9.]+)", name)
    if not m:
        raise ValueError(
            f"unknown HBM-CO device {name!r}; want one of {sorted(named)} "
            "or a design-space point 'co-r<ranks>c<channels>b<banks>m<MB>'")
    return HBMCOConfig(name=name, ranks=int(m.group(1)),
                       channels_per_layer=int(m.group(2)),
                       banks_per_group=int(m.group(3)),
                       bank_mb=float(m.group(4)))


def enumerate_design_space(
    ranks: Sequence[int] = (1, 2, 4),
    channels: Sequence[int] = (1, 2, 4),
    banks: Sequence[int] = (1, 2, 4),
    bank_mbs: Sequence[float] = (1.5, 3.0, 6.0, 12.0, 24.0),
) -> list[HBMCOConfig]:
    """Enumerate the HBM-CO knob grid (paper Fig 5 design space)."""
    out = []
    for r, c, b, mb in itertools.product(ranks, channels, banks, bank_mbs):
        cfg = HBMCOConfig(
            name=f"co-r{r}c{c}b{b}m{mb:g}",
            ranks=r, channels_per_layer=c, banks_per_group=b, bank_mb=mb,
        )
        out.append(cfg)
    return out


def pareto_frontier(
    configs: Iterable[HBMCOConfig],
    *,
    fixed_bandwidth_gbs: float | None = 256.0,
) -> list[HBMCOConfig]:
    """Pareto-minimal set over (energy/bit, -capacity).

    The RPU composes fixed-bandwidth-interface chiplets (paper Fig 9-10:
    "Each memory chiplet has a fixed bandwidth interface"), so by default
    the frontier is taken within the 256 GB/s interface class; pass ``None``
    to sweep all bandwidths.
    """
    cand = [c for c in configs
            if fixed_bandwidth_gbs is None
            or abs(c.bandwidth_gbs - fixed_bandwidth_gbs) < 1e-6]
    # sort by capacity ascending; keep points with strictly decreasing energy
    # as capacity grows?  No: energy grows with capacity, so the frontier is
    # (capacity asc, energy asc) — keep configs not dominated by another with
    # (capacity >= and energy <=).
    frontier: list[HBMCOConfig] = []
    for c in sorted(cand, key=lambda x: (x.capacity_mb, x.energy_pj_per_bit)):
        dominated = any(
            o.capacity_mb >= c.capacity_mb - 1e-9
            and o.energy_pj_per_bit <= c.energy_pj_per_bit + 1e-12
            and (o.capacity_mb > c.capacity_mb or
                 o.energy_pj_per_bit < c.energy_pj_per_bit)
            for o in cand)
        if not dominated:
            if not frontier or c.capacity_mb > frontier[-1].capacity_mb + 1e-9:
                frontier.append(c)
    return frontier


def select_sku(
    required_bytes_per_device: float,
    frontier: Sequence[HBMCOConfig] | None = None,
) -> HBMCOConfig | None:
    """Pick the highest-BW/Cap (smallest-capacity) SKU that fits the
    per-device capacity requirement (paper Fig 9/10 selection rule:
    "the smallest device capacity that meets the system-level requirement").

    Returns ``None`` when even the largest SKU cannot fit the requirement.
    """
    if frontier is None:
        frontier = pareto_frontier(enumerate_design_space())
    fitting = [c for c in frontier if c.capacity_bytes >= required_bytes_per_device]
    if not fitting:
        return None
    return min(fitting, key=lambda c: c.capacity_bytes)
