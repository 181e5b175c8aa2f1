"""RPU ISA phases (paper §VI "RPU ISA and Compiler").

The RPU exposes CISC-style long-running instructions (a whole VMM, an SDPA
pass, a collective) whose dataflow is hardened in hardware; the compiler
statically orders them into synchronized memory/compute/network streams.
We model each instruction as a ``Phase`` with its per-CU resource demands;
the event-driven engine (``sim.engine``) executes the streams with the
decoupled-pipeline semantics of §V.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Phase:
    """One CISC instruction in the per-layer stream (per-CU quantities)."""

    name: str
    mem_bytes: float = 0.0       # HBM -> memory-buffer traffic (weights, KV$)
    flops: float = 0.0           # TMAC + HP-VOP work
    net_bytes: float = 0.0       # ring traffic for this phase's collective
    net_hops: int = 0            # ring hops for the collective
    overlap_net: bool = False    # True: broadcast pipelined into the VMM
                                 # (paper §IV: compute starts on the local
                                 # fragment; the collective only bounds the
                                 # phase END).  False: collective gates the
                                 # phase START (SDPA gathers/reductions).
    kind: str = "vmm"            # vmm | sdpa | moe | vop | collective


@dataclasses.dataclass
class LayerProgram:
    """Compiled instruction stream for one transformer layer (or stack)."""

    name: str
    phases: list
    repeat: int = 1

    def total(self, attr: str) -> float:
        return self.repeat * sum(getattr(p, attr) for p in self.phases)


@dataclasses.dataclass
class Program:
    """A full compiled model step (one decode token or one batch step)."""

    name: str
    layers: list                  # list[LayerProgram]
    batch: int = 1
    seq_len: int = 0
    n_cus: int = 1

    def flat_phases(self) -> list:
        out = []
        for lp in self.layers:
            for _ in range(lp.repeat):
                out.extend(lp.phases)
        return out

    def total_mem_bytes(self) -> float:
        return sum(lp.total("mem_bytes") for lp in self.layers)

    def total_flops(self) -> float:
        return sum(lp.total("flops") for lp in self.layers)

    def total_net_bytes(self) -> float:
        return sum(lp.total("net_bytes") for lp in self.layers)
