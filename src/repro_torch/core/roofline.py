"""Roofline terms of one counted step, the port of
``repro/core/roofline.py``: one device, or one rank of a mesh.

For every (architecture x input shape x mesh) dry-run cell, per device:

    compute term = FLOPs       / peak bf16 FLOP/s of the chip
    memory term  = bound bytes / HBM bytes/s of the chip

from the op counter's ``Cost`` of one eager run of the step
(``core/op_cost.py``), against ``hardware.H100`` (989 TFLOP/s bf16,
3.35 TB/s: the data sheet's rates).  The memory term divides the least
traffic of the step (``Cost.bound_bytes``: each argument read once, each
write once), so ``bound_s`` is a lower bound on the step's time on the
card; the op-level bytes (``bytes_per_device``, the reference's proxy)
are reported beside it, and ``op_memory_s`` is their term.

    collective term = collective bytes / (links x link bytes/s)

The reference parses its collectives from the compiled HLO; here one
rank of the mesh counts them as it issues them (``hints.CountComm``, the
dry-run's pod meshes): per kind the calls, the operand bytes (the
result's size, the reference's spec metric, which the term divides) and
the ring-algorithm wire bytes (reported beside it).  The H100's link is
NVLink at 450 GB/s (``hardware.H100``: one link of ``ici_link_bw``),
priced as if every card of the mesh shared one NVLink domain; past 8
cards a real cluster crosses slower links.  One device runs none:
``collective_s`` is 0 and ``collective_detail`` empty.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core import hardware
from repro_torch.core.op_cost import Cost


@dataclasses.dataclass
class RooflineReport:
    """Roofline terms for one (arch x shape) dry-run cell."""

    name: str
    chip: str
    n_chips: int
    flops_per_device: float
    bytes_per_device: float             # op-level (the reference's proxy)
    collective_bytes_per_device: float
    collective_wire_bytes_per_device: float
    collective_detail: dict             # by kind; empty on one device
    compute_s: float
    memory_s: float                     # bound_bytes over the HBM rate
    collective_s: float
    model_flops_total: float | None = None
    bound_bytes_per_device: float = 0.0
    op_memory_s: float = 0.0            # op-level bytes over the HBM rate

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Lower bound on step time assuming perfect overlap (max of terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serial_s(self) -> float:
        """Upper bound assuming zero overlap (sum of terms)."""
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def useful_flops_ratio(self) -> float | None:
        """MODEL_FLOPS / counted FLOPs — the fraction of the step's compute
        that is algorithmically necessary (catches remat / redundancy
        waste, and the whole blocks plain attention computes)."""
        if self.model_flops_total is None:
            return None
        total = self.flops_per_device * self.n_chips
        return self.model_flops_total / total if total else None

    @property
    def roofline_fraction(self) -> float:
        """How close the dominant-resource bound is to the serial time; 1.0
        means the pipelines fully overlap."""
        return self.bound_s / self.serial_s if self.serial_s else 1.0

    def row(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "chips": self.n_chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "useful_ratio": self.useful_flops_ratio,
        }


def analyze_counted(cost: Cost, *, name: str = "",
                    chip: hardware.ChipSpec = hardware.H100, n_chips: int = 1,
                    model_flops_total: float | None = None,
                    collectives: dict | None = None) -> RooflineReport:
    """A ``RooflineReport`` from the ``Cost`` of one counted run of a step
    (the counterpart of the reference's ``analyze_compiled``);
    ``collectives``: kind -> {"count", "operand_bytes", "wire_bytes"} of
    one rank (``hints.CountComm.ops``), priced over ``links x
    ici_link_bw``."""
    colls = dict(collectives or {})
    coll_bytes = float(sum(c["operand_bytes"] for c in colls.values()))
    wire_bytes = float(sum(c["wire_bytes"] for c in colls.values()))
    link_bw = chip.ici_link_bw * chip.ici_links
    return RooflineReport(
        name=name,
        chip=chip.name,
        n_chips=n_chips,
        flops_per_device=cost.flops,
        bytes_per_device=cost.bytes,
        collective_bytes_per_device=coll_bytes,
        collective_wire_bytes_per_device=wire_bytes,
        collective_detail=colls,
        compute_s=cost.flops / chip.peak_flops_bf16,
        memory_s=cost.bound_bytes / chip.hbm_bw,
        collective_s=coll_bytes / link_bw,
        model_flops_total=model_flops_total,
        bound_bytes_per_device=cost.bound_bytes,
        op_memory_s=cost.bytes / chip.hbm_bw,
    )


def model_flops_estimate(n_params_active: float, tokens: float,
                         training: bool) -> float:
    """MODEL_FLOPS = 6*N*D (train fwd+bwd) or 2*N*D (inference) per the
    standard accounting; for MoE use active (routed-in) parameters."""
    per_token = (6.0 if training else 2.0) * n_params_active
    return per_token * tokens
