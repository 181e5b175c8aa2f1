"""Ring collective matmuls: the port of ``repro/parallel/collective_matmul.py``,
the RPU's distributed VMM dataflow (paper §IV) over ``torch.distributed``.

The paper's scheme: weights are column-sharded across cores; each core
starts computing on its local activation fragment at once while the
fragments travel the ring, so the vector broadcast hides behind compute.
The row-sharded variant reduces partial sums on the critical path.

  * ``ring_allgather_matmul``   — x fragment (..., K/P) x W columns
    (K, N/P): P steps, each posting the next ring hop of the activation
    fragment (``batch_isend_irecv``) before the chunk matmul and waiting
    on it after, so the hop overlaps the product;
  * ``ring_matmul_reducescatter`` — x fragment (..., K/P) x W rows
    (K/P, N): partial outputs travel the ring accumulating, each hop
    posted before the next chunk's matmul; each rank ends with its fully
    reduced (..., N/P) chunk.

Both accumulate in f32 and cast to x's dtype at the end; they equal the
dense ``x @ w`` up to the order of the f32 sums.  As in the reference,
nothing on the serve path calls them: they are the paper's distributed
VMM, held against ``x @ w`` on CPU ranks and on the card.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.hints import TPComm


def _comm(group) -> TPComm:
    return group if isinstance(group, TPComm) else TPComm(group)


def _chunk_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.float() @ w.float()


def ring_allgather_matmul(x_frag: torch.Tensor, w_cols: torch.Tensor,
                          group=None) -> torch.Tensor:
    """Column-sharded VMM with broadcast-compute overlap.

    x_frag: (..., B, K/P) this rank's activation fragment (K sharded);
    w_cols: (K, N/P) this rank's full-K column shard; ``group``: the ring
    (a process group or a ``TPComm``).  Returns (..., B, N/P), this rank's
    output columns."""
    comm = _comm(group)
    p, idx = comm.size, comm.rank
    kp = x_frag.shape[-1]
    acc = torch.zeros(x_frag.shape[:-1] + (w_cols.shape[-1],),
                      dtype=torch.float32, device=x_frag.device)
    frag = x_frag
    for i in range(p):
        src = (idx - i) % p                  # origin of the current fragment
        hop = comm.ring_shift(frag) if i < p - 1 else None
        acc += _chunk_dot(frag, w_cols[src * kp:(src + 1) * kp])
        if hop is not None:
            frag = hop.wait()
    return acc.to(x_frag.dtype)


def ring_matmul_reducescatter(x_frag: torch.Tensor, w_rows: torch.Tensor,
                              group=None) -> torch.Tensor:
    """Row-sharded VMM with ring reduce-scatter overlap.

    x_frag: (..., B, K/P) this rank's activation fragment; w_rows:
    (K/P, N) this rank's row shard.  Returns (..., B, N/P): rank d holds
    output columns [d*N/P, (d+1)*N/P)."""
    comm = _comm(group)
    p, idx = comm.size, comm.rank
    nl = w_rows.shape[-1] // p

    def chunk(c):
        return _chunk_dot(x_frag, w_rows[:, c * nl:(c + 1) * nl])

    # the partial of chunk (idx - i - 1) arrives having visited i ranks;
    # add this rank's contribution and pass it on.  After P-1 hops each
    # rank holds its own fully reduced chunk.
    acc = chunk((idx - 1) % p)
    for i in range(1, p):
        hop = comm.ring_shift(acc)
        part = chunk((idx - i - 1) % p)
        acc = hop.wait() + part
    return acc.to(x_frag.dtype)


def tp_linear_overlapped(x: torch.Tensor, w: torch.Tensor, mesh,
                         tp_axis: str = "model",
                         mode: str = "ag") -> torch.Tensor:
    """Tensor-parallel linear with RPU-style ring overlap on ``mesh``'s
    ``tp_axis``.  ``x``: this rank's fragment (..., K/P); ``w``: this
    rank's column shard (K, N/P) for ``mode="ag"`` or row shard (K/P, N)
    for ``mode="rs"``.  Returns this rank's (..., N/P) output fragment."""
    group = mesh.get_group(tp_axis)
    if mode == "ag":
        return ring_allgather_matmul(x, w, group)
    if mode == "rs":
        return ring_matmul_reducescatter(x, w, group)
    raise ValueError(f"mode={mode!r} (want 'ag' or 'rs')")
