"""The serving plans executed: ``make_plan``'s ``decode``, ``prefill`` and
``long_decode`` kinds run by the static engine on a mesh (the port of the
reference's GSPMD-partitioned ``ServeEngine`` under ``with mesh,
sharding_rules(plan.rules())``).

One process per rank (SPMD) on a ``(data, model)`` mesh (or a ``(pod,
data, model)`` one, counted by the dry-run).  ``ServeLayout`` plays the
part ``TrainLayout`` plays for training, and shares its machinery: a rank
**stores** the plan's ``shard_shape`` of every weight (Megatron columns
and rows, heads, experts, SSM heads and the vocabulary over the ``tp``
axes; FSDP of the other dim over the DP axes where the plan turns it on)
and of every dense-cache leaf (``ParallelPlan.cache_shardings``: the
batch over ``dp``, the sequence of attention k / v and MLA latents over
``cache_seq``); it **computes** with a region of each weight
(``Leaf.region``: its heads, d_ff columns, experts, SSM heads, vocabulary
block), made from its shard with the collectives counted
(``param_gather``; none where the region is the stored shard, the common
case).

The forward is ``Model.prefill`` / ``decode_step`` themselves, run inside
``parallel.hints.serve_layout`` (ROADMAP Queue 3, "One forward,
marked"): each layer reads its weights through ``block`` and its widths
from ``local_cfg``, and every mark is the identity off a mesh.

  * **Megatron pairs.**  A column-split projection gives the rank's heads
    or columns; the closing row-split product (``wo``, ``w_down``,
    ``out_proj``) is the rank's f32 partial (``row_dot``), all-reduced at
    the block's exit (``seq_leave``) and cast to the residual's dtype
    once, after the sum.  A part whose widths do not split over the axis
    (25 heads on 2 ranks) runs whole on every rank from its gathered
    weights, and its exit is the identity.
  * **Context parallelism.**  A layer's cache holds the rank's block of
    the sequence (``seq_shard``) and every KV head.  Decode gathers the
    new token's k / v heads over ``tp`` and the rank owning slot ``pos %
    w`` writes them; it gathers the query heads over ``tp``, attends over
    its block with the dense kernel's partial mode (``cur_len`` clamped
    to the block, 0 for an empty one), merges the partials over
    ``cache_seq`` in f32 (``combine_partials``) and keeps its own heads
    for the row-split ``wo``.  Prefill runs flash at the local heads and
    writes each rank's block of the gathered k / v (a ring cache's slots
    by their positions).  ``slot_pos`` is replicated, as the plan says.
  * **Expert parallelism.**  Under a plan with ``ep`` over ``model`` each
    rank holds ``E / tp`` experts and routes the batch's whole token set;
    it keeps the assignments that land on its experts, with the capacity
    of the batch (``moe.moe_ep``), and the block's exit sums the ranks'
    outputs.
  * **SSM heads** split over ``tp`` (``shard_ssm``): a rank runs its heads'
    channels and keeps their state only (less than the plan's replicated
    state: the rank's heads of ``ssm`` and its conv channels, the B / C
    channels whole); the gated norm's sum of squares is all-reduced, and
    the B / C projection, replicated in the plan, is computed as a column
    block and gathered (``col_gather``), so no rank repeats another's
    work.
  * **Vocabulary.**  The embedding lookup sums the ranks' vocabulary
    blocks; the head's logits are gathered whole before the sampler
    (``vocab_gather``, the reference's ``logits`` rule).  A vocabulary
    the axis does not divide stays whole on every rank.
  * **Batch.**  Under a plan with ``dp`` each rank takes its rows
    (``local_rows``); the engine gathers every row's tokens at the end, on
    every rank (every rank issues every collective).

``predict_serve_bytes`` gives the bytes each kind of collective moves in
one decode step or one prefill, from the plan's shapes, the layer kinds
and the batch; ``ServeLayout.groups.counts()`` measures them.  A layout
made on a ``MeshShape`` (no processes) counts one rank's collectives with
``CountComm``s: the dry-run's pod meshes.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention_backends as ab
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.parallel.hints import TPComm
from repro_torch.parallel.plan import ParallelPlan, entry_axes
from repro_torch.parallel.train import (
    RankGroups, TrainLayout, _SoloComm, _block,
)
from repro_torch.quant import formats
from repro_torch.quant.linear import is_packed, qdot, quantizable_leaf

__all__ = ["SeqShard", "ServeLayout", "predict_serve_bytes"]

# closing (row-parallel) products read through ``tp_row_dot``
_ROW_KEYS = ("wo", "w_down", "out_proj")


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """A rank's block of a layer's dense cache: entries ``[start, start +
    size)`` of the ``cache_seq`` group ``comm``'s ``comm.size * size``
    (a group of one and the whole width where the axis does not divide
    it)."""
    comm: TPComm
    start: int
    size: int


class ServeLayout(TrainLayout):
    """A serving plan of ``model`` on this rank: groups (``tp``, ``cs`` for
    ``cache_seq``, ``batch`` for ``dp``), each weight's shard (sliced from
    ``model``'s whole weights, which the caller may then free) and compute
    region.  ``weight_format``: every leaf ``quant.linear.quantize_params``
    packs is served with its packed values, a rank's region packed where
    it is a slice of the packed whole leaf (``_pack``)."""

    serving = True

    def __init__(self, model, plan: ParallelPlan, *,
                 weight_format: str | None = None):
        if plan.seq_parallel:
            raise ValueError("a serving layout takes a decode, prefill or "
                             "long_decode plan; the train plan runs in the "
                             "training step (parallel/train.py)")
        groups = RankGroups(plan.mesh, extra={
            "tp": entry_axes(plan.tp), "cs": entry_axes(plan.cache_seq),
            "batch": tuple(plan.dp)})
        super().__init__(model, plan, groups=groups)
        self.cs_comm = groups.comms["cs"]
        self.weight_format = weight_format
        whole = dict(model.named_parameters())
        packs = {n for n, p in whole.items() if weight_format is not None
                 and quantizable_leaf(n, p, weight_format)}
        # a leaf the format packs is served with its packed values: the
        # shard of the whole leaf's quantized values
        self.params = {n: self.shard(n, formats.dequantize_any(
            formats.quantize(p.detach(), weight_format), p.dtype)
            if n in packs else p.detach()) for n, p in whole.items()}
        self._rows = {n for n, leaf in self.leaves.items()
                      if leaf.region is not None
                      and n.split(".")[-1] in _ROW_KEYS
                      and not ("moe" in n.split(".")
                               and "shared" not in n.split("."))}
        self._ready: dict = {}
        for name, leaf in self.leaves.items():
            if leaf.fs_dim is None and (leaf.tp_dim is None
                                        or self._own(leaf)):
                region = self._materialize(name)
                if name in packs:
                    region = self._pack(name, region, whole[name])
                    if is_packed(region) and (leaf.region is None
                                              or self._own(leaf)):
                        self.params[name] = region   # stored packed
                self._ready[name] = region

    # ----- groups -----
    @property
    def batch_comm(self) -> TPComm:
        """The ranks whose rows form the batch (the plan's ``dp``)."""
        return self.groups.comms["batch"]

    @property
    def ep_comm(self) -> TPComm | None:
        """The expert-parallel group: the reference's ``__ep__`` rule (a
        plan with ``ep`` whose ``tp`` is the ``model`` axis) where the axis
        splits the experts."""
        if (self.plan.ep and self.plan.tp == "model" and self.m > 1
                and self._split["moe"]):
            return self.tp_comm
        return None

    # ----- which parts split -----
    def _splits(self) -> dict[str, bool]:
        out = super()._splits()
        cfg = self.cfg
        out["ssm_bc"] = bool(out["ssm"] and (2 * cfg.ssm_groups
                                             * cfg.ssm_state) % self.m == 0)
        return out

    def _region(self, name: str, shape: tuple):
        parts = name.split(".")
        if (self.m > 1 and "ssm" in parts and parts[-1] == "w_bc"
                and self._split["ssm_bc"]):
            return (1, _block(shape[1], self.m, self.r))
        return super()._region(name, shape)

    # ----- weights -----
    @staticmethod
    def _own(leaf) -> bool:
        """The compute region is the stored ``tp`` block itself."""
        reg, blk = leaf.region, leaf.block[leaf.tp_dim]
        return (reg is not None and reg[0] == leaf.tp_dim
                and isinstance(reg[1], slice)
                and (reg[1].start, reg[1].stop) == (blk.start, blk.stop))

    def _materialize(self, name: str):
        """The compute region of ``name`` from this rank's shard: the FSDP
        dim gathered over DP, the ``tp`` dim gathered where the stored
        block is not the region (counted ``param_gather``), then
        indexed."""
        leaf = self.leaves[name]
        x = self.params[name]
        if leaf.fs_dim is not None:
            x = self.groups.comms["dp"].all_gather_dim(x, leaf.fs_dim,
                                                       kind="param_gather")
        own = leaf.tp_dim is not None and self._own(leaf)
        if leaf.tp_dim is not None and not own:
            x = self.tp_comm.all_gather_dim(x, leaf.tp_dim,
                                            kind="param_gather")
        if leaf.region is not None and not own:
            dim, where = leaf.region
            x = (x.narrow(dim, where.start, where.stop - where.start)
                 if isinstance(where, slice)
                 else x.index_select(dim, where.to(x.device)))
        if name in self._rows:
            x.tp_rows = True
        return x

    def _pack(self, name: str, region, whole):
        """A ready region of a leaf the weight format packs: packed (from
        the whole leaf's values) where it is a column block or a row block
        of whole K blocks, which pack to their slice of the packed whole
        leaf (MXFP4 blocks run along K in each column); else ``region``,
        the packed values unpacked (its products then take x unrounded)."""
        leaf = self.leaves[name]
        fmt = self.weight_format
        block = formats.format_spec(fmt).block
        if leaf.region is None:
            src = whole.detach()
        else:
            dim, where = leaf.region
            if not isinstance(where, slice) or dim == 0 and (
                    where.start % block or where.stop % block):
                return region
            src = whole.detach().narrow(dim, where.start,
                                        where.stop - where.start)
        w = formats.quantize(src.contiguous(), fmt)
        if name in self._rows:
            w.tp_rows = True
        return w

    def weight(self, name: str):
        """The compute region of ``name`` (made once where it needs no
        collective, else from the shard at every call)."""
        w = self._ready.get(name)
        return self._materialize(name) if w is None else w

    def stored_bytes(self) -> int:
        """The bytes of the weight shards this rank stores (a packed one at
        its packed bytes)."""
        return sum(p.nbytes if is_packed(p) else p.numel() * p.element_size()
                   for p in self.params.values())

    # ----- marks -----
    def enter(self, h: torch.Tensor) -> torch.Tensor:
        return h

    def leave(self, out: torch.Tensor, part: str) -> torch.Tensor:
        """The ranks' partial sums of a split ``part`` all-reduced."""
        if self.m > 1 and self._split[part]:
            return self.tp_comm.all_reduce_op(out, kind="leave")
        return out

    def row_dot(self, x: torch.Tensor, w) -> torch.Tensor:
        """A closing product: the f32 partial of the rank's rows of a
        row-split weight (a packed one dequantized to f32 first, an MXFP4
        one taking x rounded to bf16, as ``qdot``'s product does), else
        ``qdot``."""
        if not getattr(w, "tp_rows", False):
            return qdot(x, w)
        if isinstance(w, formats.PackedMXFP4):
            x = x.to(torch.bfloat16)
        if is_packed(w):
            w = formats.dequantize_any(w, torch.float32)
        return x.float() @ w.float()

    def lookup(self, emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        if self._split["vocab"] and self.m > 1:
            return super().lookup(emb, tokens)
        return emb[tokens.long()]

    def scatter_positions(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' vocabulary blocks of the lookup summed (every
        position stays on every rank)."""
        if self._split["vocab"] and self.m > 1:
            return self.tp_comm.all_reduce_op(x, kind="embed")
        return x

    def own_positions(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def image_rank(self) -> bool:
        """Whether this rank adds a vision batch's image rows into the
        summed lookup (the first rank of a split vocabulary, or every
        rank of a whole one)."""
        return self.r == 0 or not self._split["vocab"] or self.m == 1

    def vocab_offset(self, v_local: int) -> int:
        return self.r * v_local if self._split["vocab"] else 0

    def vocab_gather(self, logits: torch.Tensor) -> torch.Tensor:
        if self._split["vocab"] and self.m > 1:
            return self.tp_comm.all_gather_dim(logits, logits.ndim - 1,
                                               kind="vocab_gather")
        return logits

    def col_gather(self, y: torch.Tensor, part: str) -> torch.Tensor:
        if self._split[part] and self.m > 1:
            return self.tp_comm.all_gather_dim(y, y.ndim - 1,
                                               kind="col_gather")
        return y

    def heads_gather(self, x: torch.Tensor, dim: int,
                     kv: bool = False) -> torch.Tensor:
        """Every head along ``dim`` from each rank's heads (a KV head held
        by ``tp // n_kv_heads`` ranks taken once)."""
        if not self._split["attn"] or self.m == 1:
            return x
        x = self.tp_comm.all_gather_dim(x, dim, kind="heads_gather")
        kvh = self.cfg.n_kv_heads
        if kv and not self.cfg.mla and kvh % self.m:
            idx = torch.arange(0, self.m, self.m // kvh, device=x.device)
            x = x.index_select(dim, idx)
        return x

    def own_heads(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if not self._split["attn"] or self.m == 1:
            return x
        hl = self.cfg.n_heads // self.m
        return x.narrow(dim, self.r * hl, hl)

    def seq_shard(self, width: int) -> SeqShard:
        n = self.cs_comm.size
        if n == 1 or width % n:
            return SeqShard(_SoloComm(), 0, width)
        size = width // n
        return SeqShard(self.cs_comm, self.cs_comm.rank * size, size)

    # ----- batch and caches -----
    def local_rows(self, batch: dict) -> dict:
        """This rank's rows of a global batch (the ``dp`` ranks' rows
        contiguous, in rank order)."""
        n, i = self.batch_comm.size, self.batch_comm.rank
        out = {}
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch {k!r}: {v.shape[0]} rows do not "
                                 f"split over {n} DP ranks")
            b = v.shape[0] // n
            out[k] = v[i * b:(i + 1) * b]
        return out

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` (dim 0), in batch order, on every
        rank."""
        return self.batch_comm.all_gather_dim(x, 0, kind="rows")

    def init_cache(self, model, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> list[dict]:
        """This rank's dense caches for ``batch`` local rows: each attention
        layer's block of the sequence (``seq_shard`` of its global width)
        with every KV head and the whole ``slot_pos``; a stateful layer's
        state of the rank's SSM heads."""
        dev = model.device if device is None else device
        caches = []
        for win, blk in zip(model.windows, model.layers):
            if blk.kind == "ssm":
                caches.append(ssm_lib.init_ssm_state(self.local_cfg, batch,
                                                     device=dev))
                continue
            be = ab.backend_for_kind(blk.kind)
            full = be.init_cache(self.cfg, batch, max_len, win, dtype,
                                 device="meta")
            w = full["slot_pos"].shape[0]
            c = be.init_cache(self.cfg, batch, self.seq_shard(w).size, None,
                              dtype, device=dev)
            c["slot_pos"] = torch.full((w,), -1, dtype=torch.int32,
                                       device=dev)
            if blk.kind == "hybrid":
                c = {"attn": c, "ssm": ssm_lib.init_ssm_state(
                    self.local_cfg, batch, device=dev)}
            caches.append(c)
        return caches


def _ag(nbytes: int, n: int) -> int:
    return nbytes * (n - 1)


def _ar(nbytes: int, n: int) -> int:
    return 2 * (n - 1) * nbytes // n


def predict_serve_bytes(lay: ServeLayout, model, *, rows: int, seq: int,
                        max_len: int, act_dtype: torch.dtype,
                        step: str = "decode") -> dict:
    """The bytes each kind of this rank's collectives moves in one
    ``step`` ("decode": one token a row; "prefill": a ``seq``-token
    prompt), by the counts' keys (``kind_bytes``), from the plan's shapes,
    the layer kinds and the rank's ``rows`` (``max_len``: the caches'
    width).  ``model``: the served model's layers (kinds and windows);
    ``act_dtype``: the residual stream's dtype."""
    cfg, lcfg, m = lay.cfg, lay.local_cfg, lay.m
    tp = lay.tp_comm.size
    sp = lay._split
    isz = torch.finfo(act_dtype).bits // 8
    t = rows * (1 if step == "decode" else seq)     # token rows a layer sees
    out: dict = {}

    def add(kind, nbytes):
        if nbytes:
            out[kind + "_bytes"] = out.get(kind + "_bytes", 0) + int(nbytes)

    # the weights gathered at every use (no stored block is the region; a
    # tied embedding is used twice, by the lookup and by the head)
    for name, leaf in lay.leaves.items():
        if name in lay._ready:
            continue
        p = lay.params[name]
        uses = 2 if name == "embed" and cfg.tie_embeddings else 1
        cur = p.numel() * p.element_size()
        if leaf.fs_dim is not None:
            n = lay.groups.comms["dp"].size
            add("param_gather", uses * _ag(cur, n))
            cur *= n
        if leaf.tp_dim is not None and not lay._own(leaf):
            add("param_gather", uses * _ag(cur, tp))
    d = cfg.d_model
    if sp["vocab"] and m > 1:
        add("embed", _ar(t * d * isz, m))
        add("vocab_gather", _ag(rows * (cfg.padded_vocab // m) * isz, m))
    for win, blk in zip(model.windows, model.layers):
        kind = blk.kind
        if kind in ("ssm", "hybrid"):
            if sp["ssm"] and m > 1:
                add("all_reduce_fwd", _ar(t * 4, m))           # gated norm
                add("leave", _ar(t * d * 4, m))
            if sp["ssm_bc"] and m > 1:
                gn2 = 2 * cfg.ssm_groups * cfg.ssm_state
                add("col_gather", _ag(t * gn2 // m * isz, m))
        if kind == "ssm":
            continue
        be = ab.backend_for_kind(kind)
        full = be.init_cache(cfg, rows, max_len, win, device="meta")
        w = full["slot_pos"].shape[0]
        sh = lay.seq_shard(w)
        h, kvh = cfg.n_heads, cfg.n_kv_heads
        if sp["attn"] and m > 1:
            add("leave", _ar(t * d * 4, m))
            hl = lcfg.n_heads
            if cfg.mla:
                if step == "decode":                   # q in latent space
                    add("heads_gather", _ag(
                        rows * hl * (cfg.kv_lora_rank + cfg.rope_head_dim)
                        * 4, m))
            else:
                kl = lcfg.n_kv_heads
                add("heads_gather", 2 * _ag(t * kl * cfg.hd * isz, m))
                if step == "decode":
                    add("heads_gather", _ag(rows * hl * cfg.hd * isz, m))
        n_cs = sh.comm.size
        if step == "decode" and n_cs > 1:
            width = cfg.kv_lora_rank if cfg.mla else cfg.hd
            add("attn_max", _ar(rows * h * 4, n_cs))
            add("attn_sum", _ar(rows * h * (width + 1) * 4, n_cs))
        # the FFN
        if blk.is_moe:
            if sp["moe"] and m > 1:
                add("leave", _ar(t * d * (4 if cfg.n_shared_experts
                                          else isz), m))
            nb = lay.batch_comm.size
            s_len = t // rows
            impl, chunks = moe_lib.moe_plan(cfg, rows * nb, s_len,
                                            model.moe_impl, lay.ep_comm)
            if impl in ("capacity", "ep") and nb > 1:
                # the lower DP ranks' counts, once a dispatch chunk
                add("all_gather", chunks * _ag(cfg.n_experts * 8, nb))
        elif sp["mlp"] and m > 1:
            add("leave", _ar(t * d * 4, m))
    return out
