"""Event-driven simulator of the RPU's decoupled pipelines (paper §V/§VI).

Models one CU (all CUs are symmetric under the paper's fine-grained
sharding) as three pipelines coupled through a bounded SRAM buffer:

  memory  — streams each phase's HBM bytes in chunks at ``cu_mem_bw``;
            may run AHEAD of compute (prefetch) until the buffer fills —
            the decoupling that lets the RPU absorb network stalls and
            phase imbalance (Fig 8 ①③⑤).
  compute — consumes chunks in order at the phase's FLOP rate; cannot
            start a phase before its gating collective completes (Fig 8 ②④).
  network — per-phase ring collectives: hops x hop_latency + bytes/ring_bw.

Chunk-granular discrete-event execution (FIFO producer/consumer over one
buffer) reproduces the paper's transient behaviours: buffer occupancy
ramps, compute "catch-up" after stalls, and the bimodal smoothing claim
(§IX C3: decoupling is worth up to 1.6x at BS=32; ablate with
``decoupled=False`` / ``fine_grained_net=False``).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import hardware
from repro_torch.core.hbmco import HBMCOConfig, CANDIDATE_CO
from repro_torch.core.provisioning import DATAPATH_PJ_PER_BIT
from repro_torch.sim.isa import Phase, Program

COMPUTE_PJ_PER_FLOP = 0.3     # 5 W / 16.4 TOPS (paper Fig 8 compute power)


@dataclasses.dataclass
class SimResult:
    latency_s: float
    mem_busy_s: float
    comp_busy_s: float
    net_busy_s: float
    mem_stall_buffer_s: float        # memory blocked on full buffer
    comp_stall_net_s: float          # compute blocked on collectives
    comp_stall_data_s: float         # compute blocked on memory stream
    energy_j: float
    buffer_peak_bytes: float
    phase_spans: list                # (name, comp_start, comp_end)
    tokens_per_s_per_query: float = 0.0
    batch: int = 1

    @property
    def mem_bw_utilization(self) -> float:
        return self.mem_busy_s / self.latency_s if self.latency_s else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.batch / self.latency_s if self.latency_s else 0.0


def simulate_program(
    program: Program,
    *,
    rpu: hardware.RPUChipParams = hardware.RPU_DEFAULT,
    mem: HBMCOConfig = CANDIDATE_CO,
    buffer_bytes: float | None = None,
    chunk_bytes: float = 64 * 1024,
    decoupled: bool = True,
    fine_grained_net: bool = True,
) -> SimResult:
    """Execute the compiled program on the decoupled-pipeline model."""
    phases = program.flat_phases()
    bw = rpu.cu_mem_bw
    tops = rpu.cu_tops
    ring_bw = rpu.ring_bw
    hop = rpu.cu_hop_latency_s
    if buffer_bytes is None:
        buffer_bytes = rpu.buffer_bytes_per_core * rpu.cores_per_cu

    # --- build the global chunk list (FIFO across phases)
    chunk_phase: list[int] = []
    chunk_mem_t: list[float] = []
    chunk_comp_t: list[float] = []
    for pi, ph in enumerate(phases):
        n = max(1, math.ceil(ph.mem_bytes / chunk_bytes)) if ph.mem_bytes else 1
        for j in range(n):
            frac = 1.0 / n
            chunk_phase.append(pi)
            chunk_mem_t.append(ph.mem_bytes * frac / bw)
            chunk_comp_t.append(ph.flops * frac / tops)

    nch = len(chunk_phase)
    stream_end = [0.0] * nch
    consume_end = [0.0] * nch

    # --- network schedule: gating collective for phase i starts when the
    # previous phase's compute has produced the activation.
    net_end = [0.0] * len(phases)

    # two-cursor simulation: memory cursor m, compute cursor c
    mem_free = 0.0
    comp_free = 0.0
    net_free = 0.0
    mem_stall_buffer = 0.0
    comp_stall_net = 0.0
    comp_stall_data = 0.0
    mem_busy = 0.0
    comp_busy = 0.0
    net_busy = 0.0
    buffer_peak = 0.0
    phase_comp_start = [0.0] * len(phases)
    phase_comp_end = [0.0] * len(phases)

    # buffer window: memory may stream chunk m only if the un-consumed bytes
    # stay <= buffer_bytes; with uniform chunks this is a sliding window.
    window = max(1, int(buffer_bytes / chunk_bytes)) if decoupled else 1

    prev_comp_end_of_phase = 0.0
    cur_phase_for_comp = -1

    m = 0
    c = 0
    # interleaved advance: always progress the earlier-available action.
    while c < nch:
        # --- advance memory cursor while it can stream
        while m < nch:
            # buffer space: chunk m-window must have been consumed
            space_t = consume_end[m - window] if m - window >= 0 else 0.0
            ph_m = phases[chunk_phase[m]]
            start_req = mem_free
            if not decoupled:
                # serial ablation: no cross-phase prefetch — memory may not
                # start phase p until compute finished phase p-1.
                pidx = chunk_phase[m]
                if pidx > 0:
                    start_req = max(start_req, phase_comp_end[pidx - 1])
            if not fine_grained_net:
                # global-barrier ablation: memory waits for the phase's
                # gating collective too.
                pidx = chunk_phase[m]
                if phases[pidx].net_bytes:
                    start_req = max(start_req, net_end[pidx])
            # occupancy bound: at most ``window`` chunks ahead of the
            # consume cursor (also keeps consume_end[m-window] well-defined)
            if m >= c + window:
                break
            start = max(start_req, space_t)
            if start > mem_free:
                mem_stall_buffer += start - mem_free
            dur = chunk_mem_t[m]
            stream_end[m] = start + dur
            mem_free = stream_end[m]
            mem_busy += dur
            buffer_peak = max(buffer_peak,
                              min(window, m - c + 1) * chunk_bytes)
            m += 1

        # --- advance compute by one chunk
        pidx = chunk_phase[c]
        ph = phases[pidx]
        # coarse-grained ablation (paper §IX C3): every collective becomes
        # a gating global barrier over the full flat ring (the fine-grained
        # sharding is what shrinks the sync scope and lets VMMs overlap
        # their broadcasts).
        gating = ph.net_bytes and (not ph.overlap_net or not fine_grained_net)
        if pidx != cur_phase_for_comp:
            cur_phase_for_comp = pidx
            # schedule this phase's collective (consumes the previous
            # phase's output, so it starts no earlier than that)
            if ph.net_bytes:
                ns = max(net_free, prev_comp_end_of_phase)
                hops = ph.net_hops if fine_grained_net else program.n_cus
                dur = hops * hop + ph.net_bytes / ring_bw
                net_end[pidx] = ns + dur
                net_free = ns + dur
                net_busy += dur
            first_start = max(comp_free, stream_end[c])
            if gating and net_end[pidx] > first_start:
                comp_stall_net += net_end[pidx] - first_start
            phase_comp_start[pidx] = max(
                first_start, net_end[pidx] if gating else 0.0)

        start = max(comp_free, stream_end[c])
        if gating:
            start = max(start, net_end[pidx])
        if stream_end[c] > comp_free:
            comp_stall_data += stream_end[c] - comp_free
        dur = chunk_comp_t[c]
        consume_end[c] = start + dur
        comp_free = consume_end[c]
        comp_busy += dur
        if c == nch - 1 or chunk_phase[c + 1] != pidx:
            # pipelined broadcast (paper §IV): the VMM cannot *finish*
            # before the last activation fragment has arrived.
            if ph.overlap_net and ph.net_bytes:
                if net_end[pidx] > comp_free:
                    comp_stall_net += net_end[pidx] - comp_free
                    comp_free = net_end[pidx]
                    consume_end[c] = comp_free
            phase_comp_end[pidx] = comp_free
            prev_comp_end_of_phase = comp_free
        c += 1

    latency = comp_free
    # --- energy
    pjb = (mem.energy_pj_per_bit + DATAPATH_PJ_PER_BIT) * 1e-12 * 8
    mem_bytes = program.total_mem_bytes()
    net_bytes = program.total_net_bytes()
    flops = program.total_flops()
    energy_per_cu = (mem_bytes * pjb
                     + flops * COMPUTE_PJ_PER_FLOP * 1e-12
                     + net_bytes * 8 * rpu.net_pj_per_bit_off_pkg * 1e-12)
    energy = energy_per_cu * program.n_cus

    spans = [(phases[i].name, phase_comp_start[i], phase_comp_end[i])
             for i in range(len(phases))]
    return SimResult(
        latency_s=latency,
        mem_busy_s=mem_busy,
        comp_busy_s=comp_busy,
        net_busy_s=net_busy,
        mem_stall_buffer_s=mem_stall_buffer,
        comp_stall_net_s=comp_stall_net,
        comp_stall_data_s=comp_stall_data,
        energy_j=energy,
        buffer_peak_bytes=buffer_peak,
        phase_spans=spans,
        batch=program.batch,
    )
