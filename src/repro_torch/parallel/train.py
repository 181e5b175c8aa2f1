"""The ``train`` plan executed: each rank stores its shard of every
parameter and moment and computes its part of the step (the port of the
reference's sharded train step, which GSPMD partitions from the plan's
``NamedSharding``s).

One process per rank (SPMD) on a ``(pod, data, model)`` mesh.  The plan
is the placement (``ParallelPlan.param_spec``): a rank **stores**
``shard_shape`` of every leaf.  The compute is chosen here, per leaf, as a
region of the whole leaf (``Leaf.region``): a rank's query / KV
heads, d_ff columns, experts, SSM heads or vocabulary rows over the
``model`` axis, whole over the DP axes.  ``TrainLayout.weight`` makes the
region from the shard under autograd (``_Materialize``): FSDP all-gathers
the DP-split dim on use, the ``model``-split dim too where the stored
block is not the region (a KV head replicated on ``tp // n_kv_heads``
ranks, a stored shard that cuts a head), then indexes the region; its
backward puts the region's gradient back in the whole leaf's place and
reduces it to the rank's shard: reduce-scatter over a split axis, a sum
over an axis the leaf is replicated on.  Every collective is counted
(``TPComm``), each kind apart.

The forward is ``Model.loss`` itself, run inside
``TrainLayout.computing`` (``parallel.hints.train_layout``): Megatron
tensor parallelism with sequence parallelism.  The residual stream
between blocks holds the rank's ``S / tp`` positions; each layer computes
with the rank's regions (``TrainLayout.block``) and local head counts
(``local_cfg``); a sub-layer's entry all-gathers the sequence
(``seq_enter``) and its exit reduce-scatters the row-parallel partial sums
back to the rank's positions (``seq_leave`` -> ``leave``).  Under that
rule every computation is split over the ranks (positions, heads,
vocabulary, batch rows), so each leaf's gradient is the sum of the ranks'
parts.  A sub-layer whose widths do not split over the axis (heads, d_ff,
experts, SSM heads) runs whole on every rank over the gathered sequence
and keeps its own positions of the output: still a split computation.

  * attention (GQA with qk-norm / qkv biases, sliding windows, MLA) is
    the plain ``blocked_attention`` under autograd, as on one device;
  * the embedding and the head are vocabulary-parallel: a rank looks up
    the tokens of its rows (``lookup``), and the cross-entropy takes its
    max, sum of exponentials and target logit over the axis
    (``_VocabXent``), so the (B, S, V) logits are never whole on one rank;
  * MoE experts split over ``model`` (``moe._expert_range``); capacity is
    the global batch's: each DP rank counts its assignments per expert and
    offsets its slots by the lower ranks' counts (all-gathered over
    ``batch_comm``), so the assignments that survive are the reference's;
  * the SSM's inner dim splits over ``model``: a rank takes its channels
    of the conv and of the per-channel / per-head leaves, and the gated
    RMSNorm's sum of squares is all-reduced (``split_comm``).

The loss of a rank is its rows' mean; the step's loss is the mean over
the DP ranks, which is the global mean because every rank holds the same
number of tokens (checked).  Gradients are averaged over the DP axes by
the reduce-scatter of the rank means' gradients, each scaled by 1/DP.
Under cross-pod compression the backward reduces over the data axis
only (to the whole DP dim: the pod's gradient of the rank's ``model``
block), and ``train_step`` takes the cross-pod mean through
``parallel.compression`` before slicing the rank's shard.

``RankGroups`` and ``TrainLayout`` serve the serving plans too
(``parallel/serve.py``'s ``ServeLayout``): the layout's ``tp`` group is
the plan's ``tp`` axes (``model`` here, every axis under a fully
tensor-parallel decode plan), and a ``RankGroups`` made on a
``MeshShape`` counts rank 0's collectives with ``CountComm``s (the
dry-run's pod meshes; the training step runs there too, on ``meta``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.models import moe as moe_lib
from repro_torch.models.common import ModelConfig
from repro_torch.parallel.hints import (
    CountComm, TPComm, gather_dim, scatter_sum_dim, train_layout,
)
from repro_torch.parallel.plan import ParallelPlan, entry_axes, mesh_axes
from repro_torch.quant.linear import qdot

DP_AXES = ("pod", "data")


class _View:
    """A module whose weights are this rank's compute tensors (set as
    attributes); its other attributes (a block's ``kind``, the MoE's
    ``impl``) read through to the module."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, name)


def refuse_non_train(plan: ParallelPlan) -> None:
    """A training step runs the ``train`` plan (sequence-parallel, TP over
    ``model``); a serving plan runs in the static engine
    (``parallel/serve.py``)."""
    if not plan.seq_parallel or plan.tp != "model":
        raise ValueError(
            f"a training step takes the train plan; this one (dp={plan.dp}, "
            f"tp={plan.tp}, cache_seq={plan.cache_seq}) is a serving plan: "
            f"run it with ServeEngine(plan=) or LLMEngine(backend='static', "
            f"mesh=)")


# ---------------------------------------------------------------------------
# the rank's groups
# ---------------------------------------------------------------------------


class RankGroups:
    """This rank's coordinates on the mesh and its groups, each a counted
    ``TPComm``: ``model``, ``dp`` (pod x data, pod-major: the batch order),
    ``data``, ``pod``, ``world``, and ``extra`` ones (name -> the axes they
    span; a serving plan's ``tp``, ``cs`` and ``batch``).  Made
    collectively: every rank builds its groups in the same order.  On a
    ``MeshShape`` (no processes) the groups are ``CountComm``s of rank 0
    of the mesh: its collectives are counted, none is issued."""

    def __init__(self, mesh, extra: dict | None = None):
        sizes = mesh_axes(mesh)
        names = tuple(mesh.mesh_dim_names)
        self.names = names
        self.sizes = {a: sizes.get(a, 1) for a in ("pod", "data", "model")}
        self.counting = not hasattr(mesh, "get_coordinate")
        if self.counting:
            coord = [0] * len(names)
            grid = torch.arange(math.prod(sizes.values()))
            self._me = 0
        else:
            coord = mesh.get_coordinate()
            grid = mesh.mesh
            self._me = dist.get_rank()
        self.coord = {a: (coord[names.index(a)] if a in names else 0)
                      for a in ("pod", "data", "model")}
        self._grid = grid.reshape([sizes[a] for a in names])
        self._over: dict = {}
        self.comms = {
            "model": self.over(("model",)),
            "dp": self.over(DP_AXES),
            "data": self.over(("data",)),
            "pod": self.over(("pod",)),
            "world": self.over(names),
        }
        for key, axes in (extra or {}).items():
            self.comms[key] = self.over(axes)

    def over(self, axes) -> TPComm:
        """The group of the ranks that differ from this one only on
        ``axes`` (their order is the mesh's, major first), made once."""
        axes = tuple(a for a in self.names if a in tuple(axes))
        if axes in self._over:
            return self._over[axes]
        n = math.prod(self._grid.shape[self.names.index(a)] for a in axes)
        if n == 1:
            comm = _SoloComm()
        elif self.counting:
            comm = CountComm(n, 0)
        elif axes == self.names:
            comm = TPComm(None)
        else:
            rest = [i for i, a in enumerate(self.names) if a not in axes]
            span = [self.names.index(a) for a in axes]
            rows = self._grid.permute(rest + span).reshape(-1, n)
            comm = None
            for row in rows:
                rl = [int(x) for x in row]
                g = dist.new_group(ranks=rl)
                if self._me in rl:
                    comm = TPComm(g)
        self._over[axes] = comm
        return comm

    @property
    def dp_index(self) -> int:
        return self.coord["pod"] * self.sizes["data"] + self.coord["data"]

    @property
    def dp_size(self) -> int:
        return self.sizes["pod"] * self.sizes["data"]

    def _unique(self) -> list:
        out = []
        for c in self.comms.values():
            if all(c is not o for o in out):
                out.append(c)
        return out

    def set_phase(self, phase: str | None) -> None:
        for c in self._unique():
            c.phase = phase

    def counts(self) -> dict:
        """The collectives' counts of every group, summed by key."""
        out: dict = {}
        for c in self._unique():
            for k, v in c.counts.items():
                out[k] = out.get(k, 0) + v
        return out

    def reset_counts(self) -> None:
        for c in self._unique():
            c.counts.clear()


class _SoloComm(TPComm):
    """A group of one rank: every collective is the identity (counted as
    TPComm counts a group of one)."""

    def __init__(self):
        from collections import Counter
        self.group = None
        self.size, self.rank, self.backend = 1, 0, "none"
        self.counts = Counter()
        self.phase = None


# ---------------------------------------------------------------------------
# per-leaf layout: storage (the plan's shard) and compute (the region)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Leaf:
    """A parameter's placement on this rank: ``shape`` whole; ``fs_dim``
    the dim split over the DP axes (or None), ``tp_dim`` over ``model``;
    ``block`` the rank's stored slice of every dim; ``region`` the compute
    region, (dim, slice or index tensor) or None (whole)."""
    name: str
    shape: tuple
    fs_dim: int | None
    tp_dim: int | None
    block: tuple
    region: tuple | None

    @property
    def local_shape(self) -> tuple:
        return tuple(s.stop - s.start for s in self.block)


def _block(n: int, size: int, index: int) -> slice:
    b = n // size
    return slice(index * b, (index + 1) * b)


class TrainLayout:
    """The ``train`` plan of ``model`` on this rank: groups, each leaf's
    storage and compute, and the step's gradient stash.  ``compress``
    (set by the step): the backward reduces over the data axis only."""

    serving = False

    def __init__(self, model, plan: ParallelPlan, groups=None):
        self.plan = plan
        self.cfg: ModelConfig = model.cfg
        self.kinds = [blk.kind for blk in model.layers]
        self.moe_impl = model.moe_impl
        self.groups = groups or RankGroups(plan.mesh)
        self.tp_axes = entry_axes(plan.tp)
        self.tp_comm = self.groups.over(self.tp_axes)
        self.m = self.tp_comm.size
        self.r = self.tp_comm.rank
        self.compress = False
        self.grads: dict[str, torch.Tensor] = {}
        self.params, self._top = None, {}
        self._split = self._splits()
        self.local_cfg = self._local_cfg()
        self.leaves = {n: self._leaf(n, tuple(p.shape))
                       for n, p in model.named_parameters()}

    # ----- groups -----
    @property
    def model_comm(self) -> TPComm:
        """The ``tp`` group: the ranks that split heads, columns, experts
        and the vocabulary (the ``model`` axis of the train plan)."""
        return self.tp_comm

    @property
    def batch_comm(self) -> TPComm:
        """The ranks whose rows form the batch the model sees: DP, or the
        pod's data ranks under cross-pod compression (the reference runs
        each pod's batch apart there)."""
        return self.groups.comms["data" if self.compress else "dp"]

    # ----- which sub-modules split over the model axis -----
    def _splits(self) -> dict[str, bool]:
        cfg, m = self.cfg, self.m
        kvh, h = cfg.n_kv_heads, cfg.n_heads
        shared_ff = (cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts
        out = {
            "attn": h % m == 0 and (cfg.mla or kvh % m == 0
                                    or m % kvh == 0),
            "mlp": cfg.d_ff % m == 0,
            "moe": (cfg.n_experts % m == 0 if cfg.n_experts else False)
            and (not cfg.n_shared_experts or shared_ff % m == 0),
            "ssm": False,
        }
        if cfg.ssm or cfg.family in ("ssm", "hybrid"):
            nh = cfg.n_ssm_heads
            out["ssm"] = (self.plan.shard_ssm and nh % m == 0
                          and (nh // m) % cfg.ssm_groups == 0)
        out["vocab"] = cfg.padded_vocab % m == 0
        if not out["vocab"] and not self.serving:
            raise NotImplementedError(
                f"{cfg.name}: a vocabulary of {cfg.padded_vocab} does not "
                f"split over a {m}-way model axis (vocabulary-parallel "
                f"embedding and head)")
        return out

    def _region(self, name: str, shape: tuple):
        """(dim, slice | index) of the compute region, or None."""
        cfg, m, r = self.cfg, self.m, self.r
        parts = name.split(".")
        last = parts[-1]
        sl = lambda n, size: _block(n, size, r)      # noqa: E731
        if m == 1:
            return None
        if last == "embed":
            return (0, sl(shape[0], m)) if self._split["vocab"] else None
        if last == "head" and parts[0] == "head":
            return (1, sl(shape[1], m)) if self._split["vocab"] else None
        if parts[0] != "layers":
            return None                       # final_norm, in_proj
        if "ssm" in parts:
            if not self._split["ssm"]:
                return None
            nh, di = cfg.n_ssm_heads, cfg.d_inner
            hl, cl = nh // m, di // m
            if last in ("w_z", "w_x"):
                return (1, _block(di, m, r))
            if last == "out_proj":
                return (0, _block(di, m, r))
            if last == "norm_w":
                return (0, _block(di, m, r))
            if last in ("A_log", "D", "dt_bias"):
                return (0, _block(nh, m, r))
            if last == "w_dt":
                return (1, _block(nh, m, r))
            if last in ("conv_w", "conv_b"):
                idx = torch.cat([torch.arange(r * cl, (r + 1) * cl),
                                 torch.arange(di, shape[-1])])
                return (len(shape) - 1, idx)
            return None                       # w_bc
        if "moe" in parts:
            if not self._split["moe"]:
                return None
            if "shared" in parts:
                f = shape[1] if last in ("w_gate", "w_up") else shape[0]
                return ((1, _block(f, m, r)) if last in ("w_gate", "w_up")
                        else (0, _block(f, m, r)))
            if last in ("w_gate", "w_up", "w_down"):
                return (0, _block(cfg.n_experts, m, r))
            return None                       # router
        if "attn" in parts:
            if cfg.mla:
                if not self._split["attn"]:
                    return None
                hl = cfg.n_heads // m
                per = {"wq": cfg.hd + cfg.rope_head_dim, "w_uk": cfg.hd,
                       "w_uv": cfg.v_hd}
                if last in per:
                    w = hl * per[last]
                    return (1, slice(r * w, (r + 1) * w))
                if last == "wo":
                    w = hl * cfg.v_hd
                    return (0, slice(r * w, (r + 1) * w))
                return None                   # w_dkv, kv_norm
            if not self._split["attn"]:
                return None
            hd, h, kvh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
            q = slice(r * (h // m) * hd, (r + 1) * (h // m) * hd)
            if kvh % m == 0:
                kv = slice(r * (kvh // m) * hd, (r + 1) * (kvh // m) * hd)
            else:
                g = r // (m // kvh)
                kv = slice(g * hd, (g + 1) * hd)
            if last in ("wq", "bq"):
                return (len(shape) - 1, q)
            if last in ("wk", "wv", "bk", "bv"):
                return (len(shape) - 1, kv)
            if last == "wo":
                return (0, q)
            return None                       # q_norm, k_norm
        if "mlp" in parts:
            if not self._split["mlp"]:
                return None
            if last in ("w_gate", "w_up"):
                return (1, _block(cfg.d_ff, m, r))
            if last == "w_down":
                return (0, _block(cfg.d_ff, m, r))
        return None                           # norms

    def _leaf(self, name: str, shape: tuple) -> Leaf:
        spec = self.plan.param_spec(name, shape)
        fs_dim = tp_dim = None
        block = []
        g = self.groups
        for dim, entry in enumerate(spec):
            axes = entry_axes(entry)
            if not axes:
                block.append(slice(0, shape[dim]))
                continue
            if axes == self.tp_axes:
                tp_dim, idx, size = dim, self.r, self.m
            elif set(axes) <= set(DP_AXES):
                fs_dim = dim
                idx, size = 0, 1
                for a in axes:                   # major first
                    idx = idx * g.sizes[a] + g.coord[a]
                    size *= g.sizes[a]
            else:
                raise NotImplementedError(
                    f"{name}: spec {spec} (a plan shards a dim over the DP "
                    f"axes or over its tp axes {self.tp_axes})")
            block.append(_block(shape[dim], size, idx))
        return Leaf(name, shape, fs_dim, tp_dim, tuple(block),
                    self._region(name, shape))

    # ----- state -----
    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's stored block of the whole leaf ``full`` (a copy)."""
        return full[self.leaves[name].block].clone(
            memory_format=torch.contiguous_format)

    def pod_region(self, name: str) -> tuple:
        """The region of a leaf a rank compresses over the pods: its
        ``model`` block, whole over the DP axes."""
        leaf = self.leaves[name]
        return tuple(b if d == leaf.tp_dim else slice(0, leaf.shape[d])
                     for d, b in enumerate(leaf.block))

    def owner(self, name: str) -> bool:
        """Whether this rank counts its shard of ``name`` in a sum over
        ranks (the first of the ranks holding the same values)."""
        leaf, c = self.leaves[name], self.groups.coord
        if leaf.tp_dim is None and c["model"]:
            return False
        if leaf.fs_dim is None and (c["pod"] or c["data"]):
            return False
        return True

    def gather_full(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's shard (every rank gets it, a
        new tensor: a replicated leaf is copied)."""
        leaf = self.leaves[name]
        x = shard
        if leaf.fs_dim is not None:
            x = self.groups.comms["dp"].all_gather_dim(x, leaf.fs_dim)
        if leaf.tp_dim is not None:
            x = self.model_comm.all_gather_dim(x, leaf.tp_dim)
        return x.clone() if x is shard else x

    def gather_pod_regions(self, name: str, region: torch.Tensor):
        """(n_pods, whole) from every rank's pod region (err leaves)."""
        leaf = self.leaves[name]
        x = region
        if leaf.tp_dim is not None:
            x = self.model_comm.all_gather_dim(x, leaf.tp_dim)
        return self.groups.comms["pod"].all_gather_stack(x)

    def local_rows(self, batch: dict) -> dict:
        """This rank's rows of a global batch: the DP ranks' rows
        contiguous, in rank order (pod-major)."""
        n, i = self.groups.dp_size, self.groups.dp_index
        out = {}
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch {k!r}: {v.shape[0]} rows do not "
                                 f"split over {n} DP ranks")
            b = v.shape[0] // n
            out[k] = v[i * b:(i + 1) * b]
        return out

    # ----- compute: what ``Model.loss`` reads under the layout -----
    @contextlib.contextmanager
    def computing(self, params: dict):
        """Run ``Model.loss`` and its backward inside as this rank, on
        the shards ``params`` (``parallel.hints.train_layout``)."""
        self.params, self._top = params, {}
        try:
            with train_layout(self):
                yield self
        finally:
            self.params, self._top = None, {}

    def _stash(self, name: str, g: torch.Tensor) -> None:
        """Add a leaf's reduced gradient to the step's (a leaf made twice
        in one step adds both)."""
        have = self.grads.get(name)
        self.grads[name] = g if have is None else have + g

    def weight(self, name: str) -> torch.Tensor:
        """The compute region of ``name`` from this rank's shard, under
        autograd (its gradient lands in ``self.grads[name]``); a
        top-level leaf once a step (a tied embedding is also the head)."""
        if name in self._top:
            return self._top[name]
        w = _Materialize.apply(self.params[name], self, self.leaves[name])
        if not name.startswith("layers."):
            self._top[name] = w
        return w

    def block(self, i: int, blk) -> _View:
        """Layer ``i``'s weights (each leaf's region, made once a call:
        remat makes them again) in a view of ``blk``'s modules."""
        def view(mod, pre):
            v = _View(mod)
            for n, _ in mod.named_parameters(recurse=False):
                setattr(v, n, self.weight(f"{pre}.{n}"))
            for n, child in mod.named_children():
                setattr(v, n, view(child, f"{pre}.{n}"))
            return v
        return view(blk, f"layers.{i}")

    def _local_cfg(self) -> ModelConfig:
        """The config a rank's layers run with: the query / KV heads and
        SSM heads of its region where they split, head widths pinned."""
        cfg, m, sp = self.cfg, self.m, self._split
        kw = ({"head_dim": cfg.hd, "v_head_dim": cfg.v_hd} if cfg.n_heads
              else {})                   # an SSM-only model has no heads
        if sp["attn"]:
            kw["n_heads"] = cfg.n_heads // m
            if not cfg.mla:
                kvh = cfg.n_kv_heads
                kw["n_kv_heads"] = kvh // m if kvh % m == 0 else 1
        if sp["ssm"]:
            kw["ssm_heads"] = cfg.n_ssm_heads // m
        return dataclasses.replace(cfg, **kw)

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """A block's entry: the sequence gathered over the model axis."""
        return gather_dim(h, self.model_comm, 1)

    def row_dot(self, x: torch.Tensor, w) -> torch.Tensor:
        """A row-parallel product: the rank's rows in the activation dtype
        (its reduce-scatter sums them)."""
        return qdot(x, w)

    def image_rank(self) -> bool:
        """Whether this rank's lookup part carries a vision batch's image
        rows (the first model rank's; the others add zeros)."""
        return self.r == 0

    def vocab_offset(self, v_local: int) -> int:
        """The first vocabulary column of the rank's ``v_local``."""
        return self.r * v_local

    def split_comm(self, part: str) -> TPComm | None:
        """The model axis when it splits ``part``, else None."""
        return self.model_comm if self.m > 1 and self._split[part] else None

    def leave(self, out: torch.Tensor, part: str) -> torch.Tensor:
        """A sub-layer's output back on the rank's positions: the ranks'
        partial sums reduce-scattered, or a whole computation's own
        positions."""
        if self._split[part]:
            return scatter_sum_dim(out, self.model_comm, 1)
        return self.own_positions(out)

    def own_positions(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x``'s positions (dim 1)."""
        self._positions(x.shape[1])
        if self.m == 1:
            return x
        s = x.shape[1] // self.m
        return x[:, self.r * s:(self.r + 1) * s]

    def scatter_positions(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' parts of ``x`` summed, this rank's positions."""
        self._positions(x.shape[1])
        return scatter_sum_dim(x, self.model_comm, 1)

    def _positions(self, n: int) -> None:
        if n % self.m:
            raise ValueError(f"{n} positions do not split over the "
                             f"{self.m}-way model axis (sequence "
                             f"parallelism)")

    def lookup(self, emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's part of the embedding lookup: the rows of its
        vocabulary block ``emb``, zero for the other tokens."""
        v_l = emb.shape[0]
        loc = tokens.long() - self.r * v_l
        mine = (loc >= 0) & (loc < v_l)
        return torch.where(mine[..., None], emb[loc.clamp(0, v_l - 1)],
                           torch.zeros((), dtype=emb.dtype,
                                       device=emb.device))

    def xent(self, logits: torch.Tensor, targets: torch.Tensor):
        """The mean cross-entropy of the rank's vocabulary columns."""
        v_l = logits.shape[-1]
        return _VocabXent.apply(logits.reshape(-1, v_l), targets.reshape(-1),
                                self.r * v_l, self.model_comm)


class _Materialize(torch.autograd.Function):
    """Shard -> compute region (forward) and region gradient -> shard
    gradient, reduced over the ranks (backward); see ``TrainLayout``."""

    @staticmethod
    def forward(ctx, shard, lay: TrainLayout, leaf: Leaf):
        ctx.lay, ctx.leaf = lay, leaf
        comms = lay.groups.comms
        x = shard
        if leaf.fs_dim is not None:
            x = comms["dp"].all_gather_dim(x, leaf.fs_dim, kind="param_gather")
        region = leaf.region
        own = False
        if leaf.tp_dim is not None:
            blk = leaf.block[leaf.tp_dim]
            own = (region is not None and region[0] == leaf.tp_dim
                   and isinstance(region[1], slice)
                   and region[1].start == blk.start
                   and region[1].stop == blk.stop)
            if not own:
                x = comms["model"].all_gather_dim(x, leaf.tp_dim,
                                                  kind="param_gather")
        ctx.own, ctx.pre_shape = own, tuple(x.shape)
        if region is not None and not own:
            dim, where = region
            x = (x.narrow(dim, where.start, where.stop - where.start)
                 if isinstance(where, slice)
                 else x.index_select(dim, where.to(x.device)))
        return x if x is not shard else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        lay, leaf = ctx.lay, ctx.leaf
        comms = lay.groups.comms
        region = leaf.region
        if region is not None and not ctx.own:
            dim, where = region
            full = torch.zeros(ctx.pre_shape, dtype=g.dtype, device=g.device)
            if isinstance(where, slice):
                full.narrow(dim, where.start, where.stop - where.start).copy_(g)
            else:
                full.index_copy_(dim, where.to(g.device), g)
            g = full
        if leaf.tp_dim is not None:
            if not ctx.own:
                g = comms["model"].reduce_scatter_dim(g, leaf.tp_dim,
                                                      kind="grad_reduce")
        elif leaf.fs_dim is None and not lay.compress:
            # replicated on every rank: one sum over the world
            g = comms["world"].all_reduce_op(g, kind="grad_reduce")
            lay._stash(leaf.name, g)
            return None, None, None
        else:
            g = comms["model"].all_reduce_op(g, kind="grad_reduce")
        if lay.compress:
            g = comms["data"].all_reduce_op(g, kind="grad_reduce")
        elif leaf.fs_dim is not None:
            g = comms["dp"].reduce_scatter_dim(g, leaf.fs_dim,
                                               kind="grad_reduce")
        else:
            g = comms["dp"].all_reduce_op(g, kind="grad_reduce")
        lay._stash(leaf.name, g)
        return None, None, None


# ---------------------------------------------------------------------------
# the vocabulary-parallel cross-entropy
# ---------------------------------------------------------------------------


class _VocabXent(torch.autograd.Function):
    """Mean cross-entropy over vocabulary-parallel logits: (N, V_l) on each
    rank of ``comm``, columns ``[v0, v0 + V_l)``.  The max, the sum of
    exponentials and the target logit are reduced over the ranks in f32;
    the backward is each rank's own columns of (softmax - onehot) / N."""

    @staticmethod
    def forward(ctx, logits, targets, v0, comm):
        lf = logits.float()
        mx = torch.amax(lf, dim=-1).detach()
        mx = comm.all_reduce_op(mx, "max", kind="xent_max")
        ex = torch.exp(lf - mx[:, None])
        se = comm.all_reduce_op(ex.sum(dim=-1), kind="xent_sum")
        loc = targets.long() - v0
        mine = (loc >= 0) & (loc < lf.shape[-1])
        tl = torch.gather(lf, -1, loc.clamp(0, lf.shape[-1] - 1)[:, None])[:, 0]
        tgt = comm.all_reduce_op(torch.where(mine, tl, 0.0),
                                 kind="xent_target")
        lse = torch.log(se) + mx
        n = lf.shape[0]
        ctx.save_for_backward(ex, se, loc, mine)
        ctx.dtype, ctx.n = logits.dtype, n
        return torch.mean(lse - tgt)

    @staticmethod
    def backward(ctx, g):
        ex, se, loc, mine = ctx.saved_tensors
        grad = ex / se[:, None]
        # 1 off each target column this rank holds (no data-dependent
        # shapes: a meta count runs it too)
        hit = torch.zeros_like(grad).scatter_(
            1, loc.clamp(0, grad.shape[1] - 1)[:, None],
            mine[:, None].to(grad.dtype))
        grad = (grad - hit) * (g / ctx.n)
        return grad.to(ctx.dtype), None, None, None


# ---------------------------------------------------------------------------
# the gradient norm and the predicted collective bytes
# ---------------------------------------------------------------------------


def global_norm(lay: TrainLayout, grads: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf's whole gradient: each
    rank sums the shards it owns (a leaf replicated on several ranks
    counts once), then one all-reduce over the world."""
    dev = next(iter(grads.values())).device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for name, g in grads.items():
        if lay.owner(name):
            total = total + torch.sum(g.float() ** 2)
    total = lay.groups.comms["world"].all_reduce_op(total, kind="grad_norm")
    return torch.sqrt(total)


def state_bytes(lay: TrainLayout, param_dtypes: dict,
                moment_itemsize: int) -> dict:
    """The bytes a rank holds by the plan: parameters at their dtypes and
    two moments of ``moment_itemsize`` each, from the shard shapes."""
    p = m = 0
    for name, leaf in lay.leaves.items():
        n = math.prod(leaf.local_shape)
        p += n * param_dtypes[name].itemsize
        m += 2 * n * moment_itemsize
    return {"params": p, "moments": m}


def _ag(nbytes: int, n: int) -> int:
    return nbytes * (n - 1)


def _rs(nbytes: int, n: int) -> int:
    return nbytes * (n - 1) // n


def _ar(nbytes: int, n: int) -> int:
    return 2 * (n - 1) * nbytes // n


def predict_step_bytes(lay: TrainLayout, batch: dict, param_dtypes: dict, *,
                       remat: bool = False) -> dict:
    """The bytes a rank's collectives move in one step, by the counts'
    keys (``phase:kind_bytes``), from the plan's shard shapes, the layer
    kinds and the batch's shapes (the rank's rows): the FSDP / model-axis
    gathers of the weights (``fwd:param_gather``), their gradients'
    reductions (``bwd:grad_reduce``), the sequence-parallel entries and
    exits both ways, the SSM norm's sum, the cross-entropy's three sums,
    the MoE capacity counts, and with ``remat`` every layer's forward
    collectives once more in the backward pass but its last exit
    (``remat:*``).  Not
    counted here: the step phase (norm, loss, the first step's shape
    check, the compression)."""
    cfg, m = lay.cfg, lay.m
    g = lay.groups
    n_dp, n_world = g.dp_size, g.dp_size * m
    n_data = g.sizes["data"]
    out: dict = {}

    def add(key, nbytes):
        out[key + "_bytes"] = out.get(key + "_bytes", 0) + int(nbytes)

    layer_keys: dict = {}

    def add_layer(i, key, nbytes):
        add(key, nbytes)
        layer_keys.setdefault(i, []).append((key, nbytes))

    for name, leaf in lay.leaves.items():
        isz = param_dtypes[name].itemsize
        cur = math.prod(leaf.local_shape) * isz
        i = int(name.split(".")[1]) if name.startswith("layers.") else None
        fwd = 0
        if leaf.fs_dim is not None:
            fwd += _ag(cur, n_dp)
            cur *= n_dp
        own = False
        if leaf.tp_dim is not None:
            blk = leaf.block[leaf.tp_dim]
            reg = leaf.region
            own = (reg is not None and reg[0] == leaf.tp_dim
                   and isinstance(reg[1], slice)
                   and (reg[1].start, reg[1].stop) == (blk.start, blk.stop))
            if not own:
                fwd += _ag(cur, m)
                cur *= m
        if i is None:
            add("fwd:param_gather", fwd)
        else:
            add_layer(i, "fwd:param_gather", fwd)
        bwd = 0
        if leaf.tp_dim is not None:
            if not own:
                bwd += _rs(cur, m)
                cur //= m
        elif leaf.fs_dim is None and not lay.compress:
            add("bwd:grad_reduce", _ar(cur, n_world))
            continue
        else:
            bwd += _ar(cur, m)
        if lay.compress:
            bwd += _ar(cur, n_data)
        elif leaf.fs_dim is not None:
            bwd += _rs(cur, n_dp)
        else:
            bwd += _ar(cur, n_dp)
        add("bwd:grad_reduce", bwd)

    if cfg.frontend == "audio":
        b, s = batch["features"].shape[:2]
        xsz = torch.promote_types(torch.bfloat16,
                                  param_dtypes["in_proj"]).itemsize
    else:
        b, s = batch["tokens"].shape[:2]
        xsz = param_dtypes["embed"].itemsize
        if cfg.frontend == "vision" and "image_embeds" in batch:
            s += batch["image_embeds"].shape[1]
    d = cfg.d_model
    whole = b * s * d * xsz                      # (B, S, D) activation
    shard = b * (s // m) * d * xsz

    def entry(i):
        add_layer(i, "fwd:all_gather_dim", _ag(shard, m))
        add("bwd:reduce_scatter", _rs(whole, m))

    def exit_(i, split):
        if split:
            add_layer(i, "fwd:reduce_scatter_fwd", _rs(whole, m))
            add("bwd:all_gather_bwd", _ag(shard, m))

    for i, kind in enumerate(lay.kinds):
        entry(i)
        if kind in ("ssm", "hybrid") and lay._split["ssm"]:
            nb = b * s * 4
            add_layer(i, "fwd:all_reduce_fwd", _ar(nb, m))
            add("bwd:all_reduce_bwd", _ar(nb, m))
        if kind == "ssm":
            exit_(i, lay._split["ssm"])
            continue
        exit_(i, lay._split["attn"])
        if kind == "hybrid":
            exit_(i, lay._split["ssm"])
        entry(i)
        if kind.endswith("_moe"):
            exit_(i, lay._split["moe"])
            nb = lay.batch_comm.size
            impl, chunks = moe_lib.moe_plan(cfg, b * nb, s, lay.moe_impl)
            if impl == "capacity":
                add_layer(i, "fwd:all_gather",
                          chunks * _ag(cfg.n_experts * 8, nb))
        else:
            exit_(i, lay._split["mlp"])
    if cfg.frontend != "audio":
        add("fwd:reduce_scatter_fwd", _rs(whole, m))    # the embedding
        add("bwd:all_gather_bwd", _ag(shard, m))
    add("fwd:all_gather_dim", _ag(shard, m))           # before the head
    add("bwd:reduce_scatter", _rs(whole, m))
    n_pos = b * (s if cfg.frontend == "audio" else
                 s - 1 - (batch["image_embeds"].shape[1]
                          if cfg.frontend == "vision"
                          and "image_embeds" in batch else 0))
    for kind in ("xent_max", "xent_sum", "xent_target"):
        add(f"fwd:{kind}", _ar(n_pos * 4, m))
    if remat:
        # the recompute stops once the saved tensors the backward needs
        # exist (``torch.utils.checkpoint``'s early stop): a layer's last
        # exit, whose output nothing saves, is not issued again
        for i, items in layer_keys.items():
            last = max((j for j, (k, _) in enumerate(items)
                        if k == "fwd:reduce_scatter_fwd"), default=None)
            for j, (key, nbytes) in enumerate(items):
                if j != last:
                    add("remat:" + key.split(":", 1)[1], nbytes)
    return {k: v for k, v in out.items() if v}

