"""Partitioning plans: ``ParallelPlan`` / ``make_plan`` (the reference's
plan of every (arch x shape x mesh) cell) and the tensor-parallel paged
serve plan with its pool pricing; the port of ``repro/parallel/plan.py``.

``ParallelPlan`` maps each parameter, batch and dense-cache leaf onto a
``(pod, data, model)`` mesh as the reference does: DP over
``(pod, data)``, Megatron TP of weight columns / rows and heads over
``model``, MoE
experts over ``model``, the SSM's inner dim over ``model``, the vocab of
the embedding and head over ``model``, and FSDP of every matrix's other dim
over the DP axes; an axis whose size does not divide a dim is dropped
(``_drop_uneven``).  A spec is a tuple with one entry a dim: None, an axis
name, or a tuple of axis names (major first, as a ``PartitionSpec``).  The
``train`` kind is executed by the training step (``parallel/train.py``:
each rank stores exactly ``shard_shape`` of every parameter and moment),
the ``decode``, ``prefill`` and ``long_decode`` kinds by the static serve
engine (``parallel/serve.py``: the rank's weight shards and its
``cache_shardings`` shard of every dense cache leaf).  ``rules()`` (the
reference's GSPMD activation rules) has no counterpart: the serve layout
places every activation itself; its ``__ep__`` entry is
``parallel.hints.ep_context``.

``PagedServePlan`` partitions the continuous-batching serve path over a
mesh's ``model`` dim, the paper's CU ring.  The reference runs the paged
step inside one manual ``shard_map``; here every rank is a process (SPMD)
that builds its own local model (``local_model``) and its own pools, and
runs the same host loop:

  * attention and dense-MLP weights Megatron column-shard (``wq``, ``wk``,
    ``wv``, their biases, ``w_gate``, ``w_up``, MLA's ``w_uk`` / ``w_uv``)
    in contiguous head / d_ff blocks; each block closes its pair at the
    ``tp_row_dot`` / ``tp_psum`` marks (``parallel/hints.py``).
    ``reduce="gather"`` keeps the closing weights (``wo``, ``w_down``)
    whole on every rank and all-gathers the column intermediate;
    ``reduce="psum"`` row-shards them and spends one f32 all-reduce a
    block;
  * GQA pools hold the rank's KV heads (``local_config``); MLA's latent
    pools replicate; page ids, page tables, positions and sampling
    tensors are the same on every rank (the host allocator does not know
    the mesh);
  * embeddings, head, norms and MoE experts replicate: logits come back
    whole on every rank, so every rank samples the same tokens.

Under ``n_kv_heads < tp`` (llama3-style GQA) each KV head is replicated on
``kv_repl = tp // n_kv_heads`` consecutive ranks (``prepare_params``), so
every rank holds exactly the one KV head its query heads read.

A mesh is a ``DeviceMesh`` (``launch/mesh.py``) or, for pricing only, a
``MeshShape``: the plan reads ``mesh_dim_names``, ``size(dim)`` and
``device_type``.

``split_mesh`` cuts a mesh into the two disjoint phase slices of a
disaggregated deployment along its ``model`` dim (the reference's
contract): a prefill engine and a decode engine then build their own
serve plans, each with its own TP degree.  On a ``DeviceMesh`` it is
collective over the whole world (every rank calls it, a rank in neither
slice too): it builds both slices' process groups and ``phase_group``, the
gloo group of the two slices' ranks over which a ``DisaggServeEngine``
coordinates its phases and hands KV pages from one to the other.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from repro_torch.models.common import ModelConfig

# parameter name -> kind tables (the reference's; the port's parameter
# names are the reference pytree's keys)
_COL_SHARD = {"wq", "wk", "wv", "w_gate", "w_up", "w_uk", "w_uv",
              "head", "in_proj"}
_BIAS_COL = {"bq", "bk", "bv"}
_ROW_SHARD = {"wo", "w_down", "out_proj"}
_VOCAB_SHARD = {"embed"}

# Per-device bytes the serve/prefill plans are willing to spend on weights
# before turning on FSDP weight sharding (the reference's budget).
_WEIGHT_FIT_BYTES = 8 * 2**30


def axis_size(mesh, axis: str) -> int:
    """The size of ``mesh``'s dim ``axis`` (``DeviceMesh.size`` takes the
    dim's index)."""
    return int(mesh.size(tuple(mesh.mesh_dim_names).index(axis)))


def mesh_axes(mesh) -> dict[str, int]:
    """{dim name: size} of ``mesh``, in its order."""
    names = tuple(mesh.mesh_dim_names)
    return {a: int(mesh.size(i)) for i, a in enumerate(names)}


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name, or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def entry_size(mesh, entry) -> int:
    return math.prod(axis_size(mesh, a) for a in entry_axes(entry))


def _drop_uneven(spec: tuple, shape, mesh) -> tuple:
    """Drop the sharded axes of the dims whose size they do not divide
    (e.g. 25 heads over a 16-way model axis): the reference's rule for
    ``in_shardings``, which need even shards."""
    out = []
    for dim in range(len(shape)):
        entry = spec[dim] if dim < len(spec) else None
        if entry is not None and shape[dim] % entry_size(mesh, entry):
            entry = None
        out.append(entry)
    return tuple(out)


def shard_shape(spec: tuple, shape, mesh) -> tuple[int, ...]:
    """The local shape of a ``shape`` leaf laid out by ``spec`` (an even
    shard: ``_drop_uneven`` first), as ``NamedSharding.shard_shape``."""
    return tuple(n // entry_size(mesh, spec[i]) if i < len(spec) else n
                 for i, n in enumerate(shape))


def _tree_specs(tree, assign, names=()):
    """``tree`` (nested dicts / lists / tuples of tensors or shapes) with
    each leaf replaced by ``assign(names, leaf)``."""
    if isinstance(tree, dict):
        return {k: _tree_specs(v, assign, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not (
            tree and all(isinstance(x, int) for x in tree)):
        return type(tree)(_tree_specs(v, assign, names + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return assign(names, tree)


def _leaf_shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """Sharding plan of one (config x shape) cell: the reference's fields.
    ``dp`` the axes of the batch, ``tp`` of weights and heads, ``fsdp`` of
    the non-TP weight dim, ``cache_seq`` of a KV cache's sequence,
    ``seq_parallel`` the training activations' sequence over ``tp``,
    ``ep`` expert parallelism advertised to MoE (the serving plans'
    ``parallel.hints.ep_context``), ``shard_ssm`` the SSM inner dim over
    ``tp``."""

    mesh: Any
    dp: tuple[str, ...]
    tp: tuple[str, ...] | str
    fsdp: tuple[str, ...] = ()
    cache_seq: tuple[str, ...] | str | None = None
    seq_parallel: bool = False
    ep: bool = True
    shard_ssm: bool = True

    # ---------------- parameters ----------------
    def _param_spec(self, names, ndim: int) -> tuple:
        """The reference's spec of a leaf named by ``names`` (its path; a
        port parameter's dotted name split) with ``ndim`` dims.  The port
        keeps no layer axis, and the reference's rules place every axis
        relative to the last dims, so they give the trailing part of the
        reference's spec of the stacked leaf."""
        name = names[-1]
        in_moe = "moe" in names and "shared" not in names
        in_ssm = "ssm" in names
        fsdp = self.fsdp if self.fsdp else None
        lead = max(0, ndim - 2)
        none = [None] * max(ndim - 2, 0)
        if in_moe and name in ("w_gate", "w_up", "w_down"):
            # experts (E, D, F): experts over tp, FSDP the D dim
            spec: list = [None] * ndim
            spec[lead - 1 if lead >= 1 else 0] = self.tp
            if fsdp:
                spec[ndim - 2] = fsdp
            return tuple(spec)
        if in_ssm:
            if name in ("w_z", "w_x"):
                return (*none, fsdp, self.tp if self.shard_ssm else None)
            if name == "out_proj":
                return (*none, self.tp if self.shard_ssm else fsdp,
                        fsdp if self.shard_ssm else None)
            if name in ("w_bc", "w_dt") and fsdp:
                return (*none, fsdp, None)
            return (None,) * ndim
        if name in _BIAS_COL:
            return (*([None] * (ndim - 1)), self.tp)
        if name in _VOCAB_SHARD:
            return (*none, self.tp, fsdp)
        if name in _COL_SHARD:
            if ndim >= 2:
                return (*none, fsdp, self.tp)
            return (*([None] * (ndim - 1)), self.tp)
        if name in _ROW_SHARD:
            return (*none, self.tp, fsdp)
        return (None,) * ndim

    def param_spec(self, name, shape) -> tuple:
        """The spec of parameter ``name`` (dotted, or its path as a
        tuple) of ``shape``, uneven axes dropped."""
        if isinstance(name, str):
            name = (name,)
        names = tuple(part for n in name for part in n.split("."))
        shape = tuple(shape)
        return _drop_uneven(self._param_spec(names, len(shape)), shape,
                            self.mesh)

    def param_shardings(self, params) -> Any:
        """``params`` (a dict of tensors or shapes, nested dicts too: an
        optimizer state) with each leaf replaced by its spec; a scalar
        (the step counter) is replicated."""
        return _tree_specs(params, lambda names, leaf: self.param_spec(
            names, _leaf_shape(leaf)))

    def shard_shape(self, name, shape) -> tuple[int, ...]:
        """The local shape a rank stores of parameter ``name``."""
        return shard_shape(self.param_spec(name, shape), tuple(shape),
                           self.mesh)

    # ---------------- batches ----------------
    def batch_shardings(self, batch: dict) -> dict:
        def assign(leaf):
            nd = len(_leaf_shape(leaf))
            if nd == 0 or not self.dp:
                return (None,) * nd
            return (self.dp, *([None] * (nd - 1)))
        return {k: assign(v) for k, v in batch.items()}

    # ---------------- caches ----------------
    def cache_spec(self, name: str, ndim: int) -> tuple:
        """The spec of a dense-cache leaf ``name`` of ``ndim`` dims (the
        port's layer caches are unstacked: the batch is dim 0): the batch
        over ``dp``; the sequence (dim 1) of attention ``k`` / ``v`` and
        MLA ``c_kv`` / ``k_rope`` over ``cache_seq`` (context
        parallelism, the paper's KV$ across CUs); ``slot_pos`` replicated,
        the SSM and conv states replicated apart from their batch dim."""
        if name == "slot_pos" or ndim == 0:
            return (None,) * ndim
        spec: list = [None] * ndim
        if self.dp:
            spec[0] = self.dp
        if self.cache_seq and name in ("k", "v", "c_kv", "k_rope"):
            spec[1] = self.cache_seq
        return tuple(spec)

    def cache_shardings(self, cache) -> Any:
        """``cache`` (``Model.init_cache``'s list of per-layer dicts, a
        hybrid layer's ``{"attn", "ssm"}`` nested) with each leaf replaced
        by its spec (``cache_spec``), uneven axes dropped."""
        return _tree_specs(cache, lambda names, leaf: _drop_uneven(
            self.cache_spec(names[-1], len(_leaf_shape(leaf))),
            _leaf_shape(leaf), self.mesh))


def _full_tp_ok(cfg: ModelConfig, mesh) -> bool:
    """Dense archs whose projection widths divide the WHOLE mesh can run
    decode fully tensor-parallel (MoE/SSM/hybrid/MLA keep the DP plan)."""
    if cfg.moe or cfg.ssm or cfg.family in ("ssm", "hybrid") or cfg.mla:
        return False
    total = math.prod(mesh_axes(mesh).values())
    dims = (cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd, cfg.d_ff,
            cfg.padded_vocab)
    return all(d % total == 0 for d in dims)


def make_plan(cfg: ModelConfig, mesh, *, global_batch: int, shape_kind: str,
              param_bytes: float | None = None) -> ParallelPlan:
    """The reference's plan of an (arch x shape x mesh) cell.
    ``shape_kind``: train | prefill | decode | long_decode;
    ``param_bytes``: total bf16 weight bytes (the FSDP fit decision), from
    the footprint when omitted.  ``mesh``: a ``DeviceMesh`` or a
    ``MeshShape``."""
    axes = tuple(mesh.mesh_dim_names)
    sizes = mesh_axes(mesh)
    dp_axes = tuple(a for a in axes if a in ("pod", "data"))
    model_size = sizes.get("model", 1)
    dp_size = math.prod(sizes[a] for a in dp_axes)
    if param_bytes is None:
        from repro_torch.models.footprint import compute_footprint
        param_bytes = compute_footprint(cfg).total_params * 2.0
    needs_fsdp = param_bytes / max(model_size, 1) > _WEIGHT_FIT_BYTES

    if shape_kind == "train":
        # FSDP always on for training: params + AdamW state shard over DP
        return ParallelPlan(mesh, dp=dp_axes, tp="model", fsdp=dp_axes,
                            cache_seq=None, seq_parallel=True, ep=False)
    if shape_kind == "long_decode" or global_batch < dp_size:
        return ParallelPlan(mesh, dp=(), tp="model", cache_seq=axes)
    if shape_kind == "decode" and _full_tp_ok(cfg, mesh):
        return ParallelPlan(mesh, dp=(), tp=axes, cache_seq=axes)
    fsdp = dp_axes if needs_fsdp else ()
    cache_seq = "model" if shape_kind in ("decode", "prefill") else None
    return ParallelPlan(mesh, dp=dp_axes, tp="model", fsdp=fsdp,
                        cache_seq=cache_seq)


@dataclasses.dataclass(frozen=True)
class PagedServePlan:
    """Partitioning of the continuous-batching serve path over ``mesh``'s
    ``axis``; ``reduce`` "gather" (bit-exact on the CPU) or "psum"
    (Megatron); ``kv_repl`` the KV-head replication factor (1 = plain
    head sharding)."""

    mesh: Any
    axis: str = "model"
    reduce: str = "gather"
    kv_repl: int = 1

    @property
    def tp(self) -> int:
        return axis_size(self.mesh, self.axis)

    # ---------------- local (per-rank) model geometry ----------------
    def local_config(self, cfg: ModelConfig) -> ModelConfig:
        """The config a rank's model runs with: head counts and the dense
        MLP width divide by TP; everything replicated (d_model, vocab, MoE
        experts, latent ranks) keeps its size.  Under KV-head replication
        a rank holds exactly one KV head (its query group's)."""
        if self.tp == 1:
            return cfg
        if self.kv_repl > 1:
            kvh = 1
        elif cfg.n_kv_heads % self.tp == 0:
            kvh = cfg.n_kv_heads // self.tp
        else:
            kvh = cfg.n_kv_heads
        return dataclasses.replace(
            cfg, n_heads=cfg.n_heads // self.tp, n_kv_heads=kvh,
            d_ff=cfg.d_ff // self.tp)

    def pool_config(self, cfg: ModelConfig) -> ModelConfig:
        """The config of the global pools: under KV-head replication the
        KV-head axis widens to ``n_kv_heads * kv_repl`` (= tp) heads, one
        a rank.  Identity otherwise."""
        if self.kv_repl == 1:
            return cfg
        return dataclasses.replace(cfg,
                                   n_kv_heads=cfg.n_kv_heads * self.kv_repl)

    def prepare_params(self, params: dict, cfg: ModelConfig) -> dict:
        """``params`` (dotted name -> tensor) with each KV head's ``wk`` /
        ``wv`` columns (and ``bk`` / ``bv`` entries) repeated ``kv_repl``
        times along the head axis, so that the contiguous column shard
        hands rank ``d`` the one head its query heads (global heads
        ``[d*H/tp, (d+1)*H/tp)``, all in KV group ``d // kv_repl``)
        attend to.  MoE and SSM subtrees are left alone.  The same dict
        when ``kv_repl == 1``."""
        if self.kv_repl == 1:
            return params
        r, kvh, hd = self.kv_repl, cfg.n_kv_heads, cfg.hd
        out = {}
        for name, leaf in params.items():
            names = name.split(".")
            last = names[-1]
            if any(n in ("moe", "ssm") for n in names) or last not in (
                    "wk", "wv", "bk", "bv"):
                out[name] = leaf
                continue
            *lead, width = leaf.shape
            x = leaf.reshape(*lead, kvh, hd)
            out[name] = torch.repeat_interleave(x, r, dim=-2).reshape(
                *lead, width * r)
        return out

    # ---------------- parameters ----------------
    def param_shard_dim(self, name: str, ndim: int) -> int | None:
        """The dim of parameter ``name`` (dotted, ``layers.0.attn.wq``;
        ``ndim`` dims) that shards over the axis, or None (replicated):
        the reference's ``_serve_param_spec``."""
        names = name.split(".")
        last = names[-1]
        if any(n in ("moe", "ssm") for n in names):
            return None                 # replicated, computed whole
        if last in _BIAS_COL:
            return ndim - 1
        if last in _COL_SHARD and last not in ("head", "in_proj"):
            return ndim - 1
        if last in _ROW_SHARD and self.reduce == "psum":
            return ndim - 2
        return None                     # embed / head / norms / gather's wo

    def local_model(self, model, rank: int | None = None):
        """Rank ``rank``'s model (default: this process's rank on the
        axis): a ``Model`` of ``local_config`` on ``model``'s device that
        owns copies of the rank's slices of every sharded parameter (after
        ``prepare_params``) and shares ``model``'s replicated tensors.  The
        full model is left as it was; drop it and its sharded tensors are
        freed.  ``model`` must be unquantized: the engine packs the local
        model (per-column blocks along K, so a column or K-aligned row
        slice packs to the slice of the packed weight).  ``model`` itself
        when tp is 1."""
        from repro_torch.models.model import Model
        from repro_torch.quant.linear import packed_leaves

        if self.tp == 1:
            return model
        if next(packed_leaves(model), None) is not None:
            raise ValueError("local_model takes the unquantized model; the "
                             "engine quantizes the rank's local model")
        if rank is None:
            rank = self.mesh.get_local_rank(self.axis)
        cfg, n = model.cfg, self.tp
        full = self.prepare_params(dict(model.named_parameters()), cfg)
        local = Model(self.local_config(cfg), device="meta",
                      moe_impl=model.moe_impl)
        local.device = model.device
        for prefix, mod in local.named_modules():
            for key, p in list(mod._parameters.items()):
                name = f"{prefix}.{key}" if prefix else key
                src = full[name]
                dim = self.param_shard_dim(name, src.ndim)
                if dim is not None:
                    size = src.shape[dim] // n
                    src = nn.Parameter(
                        src.detach().narrow(dim, rank * size, size).clone(
                            memory_format=torch.contiguous_format),
                        requires_grad=False)
                elif not isinstance(src, nn.Parameter):
                    src = nn.Parameter(src, requires_grad=False)
                # a gather-mode closing weight stays whole: it multiplies
                # the gathered activation
                whole = dim is None and key in _ROW_SHARD
                if src.shape != p.shape and not whole:
                    raise ValueError(f"{name}: rank {rank}'s slice is "
                                     f"{tuple(src.shape)}, the local model "
                                     f"wants {tuple(p.shape)}")
                mod._parameters[key] = src
        return local

    # ---------------- accounting ----------------
    def psum_bytes_per_step(self, model, num_slots: int,
                            dtype_bytes: int = 4) -> int:
        """Bytes a device moves through the TP collectives of one decode
        step, over the attention and dense-MLP closure of every layer.
        ``"psum"``: ring all-reduce of the (slots, d_model) partial,
        2(tp-1)/tp of the payload.  ``"gather"``: all-gather of the column
        intermediate, (tp-1)/tp of its (wider) payload."""
        if self.tp == 1:
            return 0
        cfg = model.cfg
        n = self.tp
        total = 0.0
        for seg in model.plan:
            for kind in seg.kinds:
                if self.reduce == "psum":
                    att = mlp = 2 * (n - 1) / n * num_slots * cfg.d_model
                else:
                    width = (cfg.n_heads * (cfg.v_hd if kind.startswith("mla")
                                            else cfg.hd))
                    att = (n - 1) / n * num_slots * width
                    mlp = (n - 1) / n * num_slots * cfg.d_ff
                total += att * seg.reps
                if not kind.endswith("_moe"):
                    total += mlp * seg.reps
        return int(total * dtype_bytes)


def paged_kv_token_bytes(model, *, tp: int = 1, dtype_bytes: int = 4,
                         kv_repl: int = 1, cache_dtype=None) -> int:
    """Per-device pool bytes one cached token costs: leaves sharded by
    their backend's ``paged_partition_spec`` divide by ``tp`` (after
    widening by ``kv_repl``: per-device bytes bottom out at one head),
    replicated leaves do not.  With ``cache_dtype`` set the bytes are
    measured from a tiny pool at that dtype on the ``meta`` device
    (``dtype_bytes`` is ignored), so fp8/int8 pools price their 1-byte
    codes plus f32 scale leaves, the bytes the engine allocates; without
    it every leaf element counts ``dtype_bytes``."""
    full, ring = paged_kv_token_bytes_split(model, tp=tp,
                                            dtype_bytes=dtype_bytes,
                                            kv_repl=kv_repl,
                                            cache_dtype=cache_dtype)
    return full + ring


def paged_kv_token_bytes_split(model, *, tp: int = 1, dtype_bytes: int = 4,
                               kv_repl: int = 1,
                               cache_dtype=None) -> tuple[int, int]:
    """``paged_kv_token_bytes`` split into its ``(full, ring)`` residency
    halves: bytes/token in full-context segments vs sliding-window
    segments (which hold O(window) tokens per slot once ring pages are
    reclaimed).  SSM segments write no token-indexed pages and count in
    neither half."""
    from repro_torch.models.attention_backends import backend_for_kind

    full = ring = 0
    for seg in model.plan:
        seg_total = 0
        for kind in seg.kinds:
            be = backend_for_kind(kind)
            if be is None or not be.supports_paged:
                continue
            part = be.paged_partition_spec or {}
            if cache_dtype is not None:
                pool = be.init_page_pool(model.cfg, 2, 1, dtype=cache_dtype,
                                         device="meta")
                leaf_bytes = {k: math.prod(v.shape[2:]) * v.element_size()
                              for k, v in pool.items()}
            else:
                pool = be.init_page_pool(model.cfg, 2, 1, device="meta")
                leaf_bytes = {k: math.prod(v.shape[2:]) * dtype_bytes
                              for k, v in pool.items()}
            for key, per_tok in leaf_bytes.items():
                if tp > 1 and part.get(key) is not None:
                    per_tok = per_tok * kv_repl // tp
                seg_total += per_tok * seg.reps
        if seg.window is not None:
            ring += seg_total
        else:
            full += seg_total
    return full, ring


def split_mesh(mesh, n_first: int, n_second: int | None = None,
               axis: str = "model") -> tuple:
    """Split ``mesh`` into two disjoint slices along ``axis``: the phase
    slices of a disaggregated deployment (prefill takes the first
    ``n_first`` positions, decode the next ``n_second``, by default the
    rest; an explicit ``n_second`` may leave positions unused).  Each slice
    keeps every other axis whole and the order of its positions, so the
    two phase engines build independent serve plans with different TP
    degrees over one set of devices.

    A ``MeshShape`` splits into two ``MeshShape``s (for pricing).  A
    ``DeviceMesh`` splits into two ``DeviceMesh``es over the sliced rank
    tensor (``mesh.mesh``).  That is collective over the whole world: every
    rank must call it, a rank in neither slice too, since each slice's
    process groups and the slices' ``phase_group`` are made here.  A rank
    gets both slices back; in one it is not a member
    (``get_coordinate()`` is None), and an engine on such a slice only
    mirrors that phase's schedule (``ContinuousServeEngine.member``)."""
    from repro_torch.launch.mesh import MeshShape
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh {names} has no {axis!r} axis")
    ai = names.index(axis)
    size = axis_size(mesh, axis)
    if n_second is None:
        n_second = size - n_first
    if n_first < 1 or n_second < 1 or n_first + n_second > size:
        raise ValueError(
            f"cannot split a {size}-way {axis!r} axis into "
            f"{n_first}+{n_second} device slices")
    if isinstance(mesh, MeshShape):
        shape = list(mesh.shape)
        return tuple(dataclasses.replace(mesh, shape=tuple(
            shape[:ai] + [n] + shape[ai + 1:])) for n in (n_first, n_second))
    from torch.distributed.device_mesh import DeviceMesh
    ranks = mesh.mesh
    first, second = (DeviceMesh(mesh.device_type,
                                ranks.narrow(ai, lo, n).contiguous(),
                                mesh_dim_names=names)
                     for lo, n in ((0, n_first), (n_first, n_second)))
    phase_group(first, second)
    return first, second


def mesh_ranks(mesh) -> list[int]:
    """The world ranks of a ``DeviceMesh``, in its order."""
    return [int(r) for r in mesh.mesh.flatten().tolist()]


# (world ranks of both slices) -> their gloo group; made by split_mesh (or
# by the first engine over the two slices), in the same order on every rank
_PHASE_GROUPS: dict[tuple[int, ...], Any] = {}


def phase_group(first, second):
    """The gloo process group of the ranks of two ``DeviceMesh`` slices
    (``split_mesh``'s): a ``DisaggServeEngine`` broadcasts each step's
    schedule over it, and its ``KVHandoff`` sends page bytes between the
    slices over it (staged through the host, as the reference stages).
    Made once per set of ranks; ``new_group`` is collective over the whole
    world, so the first call must be made on every rank."""
    import torch.distributed as dist
    key = tuple(sorted(set(mesh_ranks(first)) | set(mesh_ranks(second))))
    if key not in _PHASE_GROUPS:
        _PHASE_GROUPS[key] = dist.new_group(list(key), backend="gloo")
    return _PHASE_GROUPS[key]


def make_paged_serve_plan(cfg: ModelConfig, mesh, axis: str = "model",
                          reduce: str = "auto") -> PagedServePlan:
    """Validate and build the TP partitioning of the paged serve path.

    ``reduce="auto"``: the bit-exact ``"gather"`` composition on a CPU
    mesh, the one-all-reduce-a-block ``"psum"`` pairing on a CUDA one (the
    reference's ``on_cpu()`` rule)."""
    if reduce == "auto":
        reduce = "gather" if mesh.device_type == "cpu" else "psum"
    if reduce not in ("gather", "psum"):
        raise ValueError(f"reduce={reduce!r} (want 'auto'/'gather'/'psum')")
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh {names} has no {axis!r} axis")
    tp = axis_size(mesh, axis)
    if tp == 1:
        return PagedServePlan(mesh=mesh, axis=axis, reduce=reduce)
    if cfg.family in ("ssm", "hybrid") or cfg.ssm:
        raise NotImplementedError(
            "sharded paged serving needs a paged state pool for SSM/hybrid "
            "families first (see ROADMAP)")
    kv_repl = 1
    problems = []
    if cfg.n_heads % tp:
        problems.append(f"n_heads={cfg.n_heads}")
    if not cfg.mla and cfg.n_kv_heads % tp:
        if tp % cfg.n_kv_heads == 0:
            # llama3-style kvh < tp: replicate each KV head on tp/kvh
            # consecutive ranks (one local head each); see prepare_params
            kv_repl = tp // cfg.n_kv_heads
        else:
            problems.append(f"n_kv_heads={cfg.n_kv_heads}")
    if cfg.d_ff % tp:
        problems.append(f"d_ff={cfg.d_ff}")
    if problems:
        raise ValueError(
            f"{cfg.name}: {', '.join(problems)} not divisible by the "
            f"{tp}-way {axis!r} axis; pick a mesh whose TP degree divides "
            "the head/FFN widths (KV heads may also be an integer divisor "
            "of TP — they replicate)")
    return PagedServePlan(mesh=mesh, axis=axis, reduce=reduce,
                          kv_repl=kv_repl)
