"""Mixture-of-Experts layer (DeepSeek-V2 style): the port of
``repro/models/moe.py``.

Two execution strategies, chosen by token count as the reference chooses:

  * ``dense`` — every expert processes every token, combined with the
    routing weights (tiny configs only);
  * ``capacity`` — tokens sorted by expert id are gathered into an
    (E, C, D) buffer (capacity C, deterministic drop policy), run through
    one batched product per weight, and gathered back.

Both are plain torch ops, as the reference's are plain ``jnp`` einsums: no
Pallas kernel carries MoE.  Three points keep the port's choices equal to
the reference's:

  * top-k ties go to the lower expert index (``jax.lax.top_k``'s rule):
    a stable descending sort, then the first k;
  * the capacity drop policy is the reference's exactly: a stable argsort
    of the token-major flat expert ids, each assignment's rank within its
    expert from ``searchsorted(side="left")``, and ``keep = rank < cap``.
    Padding rows count in T and compete for capacity, so which
    assignments survive depends on the batch;
  * the combine adds each token's kept contributions in the reference's
    sorted order (ascending expert id), one rounding per add in the
    activation dtype, and uses no atomics: a second identical session
    reproduces every stream on the card.

``impl="ep"`` is expert parallelism on a serving mesh (``moe_ep``; the
reference's ``shard_map`` over the model axis), which ``impl="auto"``
picks under the mesh's expert-parallel context
(``parallel.hints.ep_context``) as the reference does.  On a training mesh (``parallel/train.py``) a rank holds a block
of the experts (``_expert_range``) and the rows of one DP rank: the
strategy, the chunks and the capacity are the whole batch's
(``parallel.hints.batch_comm``), and each expert's slots go first to the
assignments of the lower DP ranks, whose tokens precede this rank's
(``_lower_rank_counts``).  Inside a tensor-parallel serve region the
experts run replicated, whole (``models.model._ffn`` turns the TP marks
off for them).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.common import (
    PARAM_DTYPE, ModelConfig, dense_init, span, swiglu,
)
from repro_torch.parallel.hints import batch_comm, ep_context, split_comm


class MoE(nn.Module):
    """Routed experts ``(E, D, F)`` / ``(E, F, D)``, an f32 router and,
    when the config has them, the shared experts under ``shared``.
    ``impl`` is the strategy ``moe_forward`` runs them with."""

    def __init__(self, cfg: ModelConfig, device, impl: str = "auto"):
        super().__init__()
        self.impl = impl
        e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff
        self.router = layers._param((d, e), torch.float32, device)
        self.w_gate = layers._param((e, d, f), PARAM_DTYPE, device)
        self.w_up = layers._param((e, d, f), PARAM_DTYPE, device)
        self.w_down = layers._param((e, f, d), PARAM_DTYPE, device)
        if cfg.n_shared_experts:
            self.shared = layers.MLP(cfg, device,
                                     d_ff=f * cfg.n_shared_experts)


@torch.no_grad()
def init_moe(p: MoE, gen: torch.Generator) -> None:
    """Fill ``p`` in place with the reference's distributions, one expert
    at a time (no second copy of the expert stack)."""
    d, e = p.router.shape
    p.router.copy_(dense_init(gen, d, e, torch.float32))
    for w in (p.w_gate, p.w_up, p.w_down):
        for i in range(w.shape[0]):
            w[i].copy_(dense_init(gen, w.shape[1], w.shape[2]))
    if hasattr(p, "shared"):
        layers.init_mlp(p.shared, gen)


def _routing(x2d: torch.Tensor, router: torch.Tensor, k: int):
    """Top-k softmax routing.  Returns (weights (T, k) f32, ids (T, k)
    int64); equal probabilities go to the lower expert index first."""
    logits = x2d.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :k], ids[:, :k]
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    return w, ids


def _expert_range(p) -> tuple[int, int]:
    """(first, count) of the experts ``p`` holds: all of them, or on a
    training mesh whose model axis splits them the rank's block."""
    n = p.w_gate.shape[0]
    comm = split_comm("moe")
    return (0 if comm is None else comm.rank * n), n


def _lower_rank_counts(ids: torch.Tensor, e: int, comm) -> torch.Tensor:
    """(E,) the assignments per expert of the DP ranks before this one in
    ``comm`` (their counts all-gathered)."""
    flat = ids.reshape(-1)
    counts = torch.zeros(e, dtype=flat.dtype, device=flat.device
                         ).scatter_add_(0, flat, torch.ones_like(flat))
    return comm.all_gather_stack(counts)[:comm.rank].sum(dim=0)


def _expert_ffn(xe: torch.Tensor, p) -> torch.Tensor:
    """(E, C, D) -> (E, C, D) batched SwiGLU over the expert axis."""
    g = torch.bmm(xe, p.w_gate)
    u = torch.bmm(xe, p.w_up)
    h = F.silu(g.float()).to(xe.dtype) * u
    return torch.bmm(h, p.w_down)


def moe_dense(x: torch.Tensor, p: MoE, cfg: ModelConfig) -> torch.Tensor:
    """Reference path: all experts on all tokens (tiny configs only; at
    most 16 experts and 4096 tokens under ``impl="auto"``).  The expert
    products are batched over E with x broadcast (``torch.matmul`` of
    (T, D) by (E, D, F)): the reference's ``einsum("td,edf->tef")`` in
    torch would first copy each (E, D, F) weight into (D, E F) order."""
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    with span("moe_dispatch"):
        w, ids = _routing(x2d, p.router, cfg.n_experts_per_token)
    with span("moe_experts"):
        g = torch.matmul(x2d, p.w_gate)                          # (E, T, F)
        u = torch.matmul(x2d, p.w_up)
        h = F.silu(g.float()).to(x.dtype) * u
        y_all = torch.bmm(h, p.w_down)                           # (E, T, D)
    with span("moe_combine"):
        onehot = F.one_hot(ids, cfg.n_experts).float()           # (T, k, E)
        comb = torch.einsum("tk,tke->te", w, onehot)             # (T, E)
        e0, n = _expert_range(p)
        if n != cfg.n_experts:
            comb = comb[:, e0:e0 + n]
        y = torch.einsum("te,etd->td", comb.to(x.dtype), y_all)
    return y.reshape(b, s, d)


def _dispatch(ids: torch.Tensor, n_buckets: int, cap: int, *,
              offset=None, first: int = 0, n_local: int | None = None):
    """The reference's drop policy over (T, k) expert ids: returns
    ``order`` (the stable argsort of the token-major flat ids), and in
    that sorted order each assignment's token ``stok``, its capacity
    buffer row ``cell`` ((expert - first) * cap + rank, clipped) and
    ``keep`` (rank < cap and one of the ``n_local`` experts from
    ``first``; ids >= n_buckets are drop buckets).  ``offset`` (E,): the
    ranks each expert's slots start at (earlier tokens of the batch)."""
    t, k = ids.shape
    dev = ids.device
    flat_ids = ids.reshape(-1)                                   # (T*k,)
    order = torch.argsort(flat_ids, stable=True)
    sid = flat_ids[order]
    stok = torch.arange(t, device=dev).repeat_interleave(k)[order]
    # rank within expert = index among same-expert entries (sorted order)
    starts = torch.searchsorted(
        sid, torch.arange(n_buckets, device=dev, dtype=sid.dtype),
        side="left")
    sid_c = sid.clamp(0, n_buckets - 1)
    slot = torch.arange(t * k, device=dev) - starts[sid_c]
    if offset is not None:
        slot = slot + offset[sid_c]
    n = n_buckets if n_local is None else n_local
    keep = (slot < cap) & (sid >= first) & (sid < min(first + n, n_buckets))
    cell = (sid - first).clamp(0, n - 1) * cap + slot.clamp(0, cap - 1)
    return order, stok, cell, keep


def _capacity_core(x2d: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
                   n_buckets: int, cap: int, wp, *, offset=None,
                   first: int = 0) -> torch.Tensor:
    """Sort-by-expert + capacity buffer + batched products over the
    experts ``wp`` holds (``first`` on, of ``n_buckets``).  Returns (T,
    D): the contributions of those experts.  Per expert, the
    earliest-sorted assignments win a slot (``_dispatch``, after
    ``offset``)."""
    t, d = x2d.shape
    k = ids.shape[1]
    n = wp.w_gate.shape[0]
    dev = x2d.device
    with span("moe_dispatch"):
        order, stok, cell, keep = _dispatch(ids, n_buckets, cap,
                                            offset=offset, first=first,
                                            n_local=n)
        sw = w.reshape(-1)[order]
        # each kept assignment owns one buffer row; the dropped ones all
        # write a spare last row, which is discarded
        dest = torch.where(keep, cell, n * cap)
        buf = torch.zeros((n * cap + 1, d), dtype=x2d.dtype, device=dev)
        buf[dest] = x2d[stok]
        xe = buf[:-1].view(n, cap, d)
    with span("moe_experts"):
        ye = _expert_ffn(xe, wp)                                 # (E, C, D)
    with span("moe_combine"):
        y_tok = ye.reshape(-1, d)[cell]                          # (T*k, D)
        contrib = torch.where(keep[:, None],
                              y_tok * sw[:, None].to(y_tok.dtype), 0)
        # each token's contributions in sorted order: ascending rank
        rank = torch.empty_like(order)
        rank[order] = torch.arange(t * k, device=dev)
        parts = contrib[rank.view(t, k).sort(dim=1).values]      # (T, k, D)
        y = torch.zeros((t, d), dtype=x2d.dtype, device=dev)
        for j in range(k):
            y = y + parts[:, j]
    return y


def moe_capacity(x: torch.Tensor, p: MoE, cfg: ModelConfig,
                 capacity_factor: float = 1.25) -> torch.Tensor:
    """Sort-by-expert dispatch into (E, C, D) buffers, with C =
    ceil(T k / E x capacity_factor) and at least 1, T the batch's tokens
    (on a training mesh every DP rank's)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_per_token
    t = b * s
    x2d = x.reshape(t, d)
    with span("moe_dispatch"):
        w, ids = _routing(x2d, p.router, k)
    comm = batch_comm()
    n = 1 if comm is None else comm.size
    cap = max(int(math.ceil(t * n * k / e * capacity_factor)), 1)
    offset = None if comm is None else _lower_rank_counts(ids, e, comm)
    y = _capacity_core(x2d, w, ids, e, cap, p, offset=offset,
                       first=_expert_range(p)[0])
    return y.reshape(b, s, d)


def moe_ep(x: torch.Tensor, p: MoE, cfg: ModelConfig,
           capacity_factor: float = 1.25) -> torch.Tensor:
    """Expert-parallel MoE (the reference's ``moe_ep``): under the serving
    mesh's expert-parallel context (``parallel.hints.ep_context``) this
    rank holds ``E / n`` experts, ``p``'s block (``_expert_range``), routes
    the batch's whole token set against the full router, keeps the
    assignments that land on its experts (the others fall in the drop
    bucket) and runs the capacity path with the batch's capacity ``ceil(T
    k / E x capacity_factor)`` (T every DP rank's tokens, each expert's
    slots first to the lower DP ranks' rows).  Returns the rank's (B, S,
    D) contribution; the block's exit sums the ranks' over the group
    (``parallel.hints.seq_leave``), as the reference sums its stacked
    partials.  The assignments that survive are ``moe_capacity``'s: a
    stable sort keeps each expert's order whether or not the other
    experts' assignments are in it."""
    if ep_context() is None:
        raise ValueError(
            "moe_impl='ep' needs an expert-parallel context (a serving "
            "plan with ep over a model axis of more than one rank that "
            "splits the experts); use impl='auto'")
    return moe_capacity(x, p, cfg, capacity_factor)


# Token budget per dispatch chunk: bounds the (T*k, D) gather streams and
# (E, C, D) capacity buffers at prefill scale.  Chunks re-stream expert
# weights, so keep them large.
MOE_CHUNK_TOKENS = 65536


def moe_chunks(rows: int, s: int) -> int:
    """The dispatch chunks of a batch of ``rows`` (every DP rank's) x
    ``s`` tokens: ~MOE_CHUNK_TOKENS tokens each, a divisor of ``s``."""
    if rows * s <= MOE_CHUNK_TOKENS:
        return 1
    n = max(1, s // max(1, MOE_CHUNK_TOKENS // rows))
    while s % n:
        n -= 1
    return n


def moe_plan(cfg: ModelConfig, rows: int, s: int, impl: str = "auto",
             ep=None) -> tuple[str, int]:
    """(strategy, dispatch chunks) of ``moe_forward`` on a batch of
    ``rows`` (every DP rank's) x ``s`` tokens under the expert-parallel
    group ``ep`` (or None).  ``impl="auto"``: ``ep`` where that group's
    ranks divide the experts, else ``dense`` at rows*s <= 4096 tokens and
    at most 16 experts, ``capacity`` otherwise."""
    if impl == "auto":
        if (ep is not None and ep.size > 1 and cfg.n_experts % ep.size == 0
                and cfg.n_experts >= ep.size):
            impl = "ep"
        elif rows * s <= 4096 and cfg.n_experts <= 16:
            impl = "dense"
        else:
            impl = "capacity"
    if impl not in ("dense", "capacity", "ep"):
        raise ValueError(f"moe impl {impl!r}: expected 'auto', 'dense', "
                         f"'capacity' or 'ep'")
    return impl, 1 if impl == "dense" else moe_chunks(rows, s)


def _chunked(fn, x: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Apply ``fn`` over ``n`` equal sequence chunks of ``x`` (by default
    ``moe_chunks``' count for ``x``'s own rows)."""
    if n is None:
        n = moe_chunks(x.shape[0], x.shape[1])
    if n <= 1:
        return fn(x)
    cl = x.shape[1] // n
    return torch.cat([fn(x[:, i * cl:(i + 1) * cl]) for i in range(n)],
                     dim=1)


def moe_forward(x: torch.Tensor, p: MoE, cfg: ModelConfig,
                impl: str = "auto") -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D), by ``moe_plan``'s strategy and chunks
    (B the batch's rows: on a mesh every DP rank's)."""
    b, s, _ = x.shape
    comm = batch_comm()
    rows = b * (1 if comm is None else comm.size)
    impl, n = moe_plan(cfg, rows, s, impl, ep_context())
    if impl == "dense":
        y = moe_dense(x, p, cfg)
    elif impl == "capacity":
        y = _chunked(lambda xc: moe_capacity(xc, p, cfg), x, n)
    else:
        y = _chunked(lambda xc: moe_ep(xc, p, cfg), x, n)
    if cfg.n_shared_experts:
        sh = p.shared
        y = y + swiglu(x, sh.w_gate, sh.w_up, sh.w_down)
    return y
