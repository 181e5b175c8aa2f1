"""Train step factory: loss -> gradients (autograd) -> AdamW, with optional
activation rematerialization; the port of ``repro/train/train_step.py``.

``TrainState`` holds the weights as ``{name: nn.Parameter}`` (the model's
parameter names) with the optimizer state beside them; the model is the
function.  ``make_train_step(model, opt_cfg)`` returns ``train_step(state,
batch) -> (state, metrics)``, which points the model's parameters at the
state's (no copy), runs ``Model.loss`` under autograd (``remat=``: each
layer recomputed in the backward pass), and updates the weights and the
accumulators in place, one tensor at a time.  The attention of a training
step is the plain ``blocked_attention`` on every device, so it launches no
hand-written kernel (``layers.attention_kernel_path``), as the reference's
runs no Pallas one.

On a mesh (``plan=``, a ``make_plan(..., shape_kind="train")`` of a
``DeviceMesh``; or ``mesh=``, from which the step makes that plan) the
state holds each rank's shard of every parameter and moment
(``init_train_state(plan=)``, laid out by ``parallel.train.TrainLayout``)
and the step runs ``Model.loss`` inside ``TrainLayout.computing`` on the
rank's rows of the batch (``TrainLayout.local_rows`` of a global one, or
a pipeline sharded by DP rank): the loss is the global mean, the
gradients are averaged over the DP axes and reduced to each rank's
shard, and the global-norm clip counts every leaf once.
``compress_pods=True`` (a mesh with a ``pod`` axis, a state made with
``n_pods=``) takes the cross-pod gradient mean through the int8
error-feedback compression after the in-pod reduction, the reference's
``shard_map`` over ``pod``; ``state.err`` holds the rank's own f32
residual.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.models.model import Model
from repro_torch.quant.linear import packed_leaves
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state


@dataclasses.dataclass
class TrainState:
    params: dict                 # name -> trainable nn.Parameter (a shard)
    opt_state: dict              # {"m": {...}, "v": {...}, "step": int32}
    err: Any = None              # cross-pod compression residual, f32
    # the mesh layout of a sharded state (parallel.train.TrainLayout);
    # not saved: a checkpoint holds whole leaves
    layout: Any = None

    @property
    def step(self) -> torch.Tensor:
        return self.opt_state["step"]


def decay_mask(model: Model) -> dict[str, bool]:
    """{name: bool}: the parameters AdamW decays.  The reference decays
    the leaves of ndim >= 2 of its own layout, where each weight of a
    segment of more than one layer carries a leading layer axis: there a
    layer's norms and biases (ndim 1 here) decay too, while a one-layer
    segment's do not.  This keeps that rule, so an update equals the
    reference's leaf for leaf."""
    stacked = [seg.reps > 1 for seg in model.plan for _ in range(seg.reps)
               for _ in seg.kinds]
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        lead = parts[0] == "layers" and stacked[int(parts[1])]
        out[name] = p.ndim + lead >= 2
    return out


def _fresh_parameters(model: Model) -> None:
    """Give every parameter of ``model`` new storage (uninitialised), so
    re-initialising it leaves tensors that an earlier state holds as they
    are."""
    for mod in model.modules():
        for attr, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[attr] = nn.Parameter(torch.empty_like(p),
                                                     requires_grad=False)


def bind_params(model: Model, params: dict) -> None:
    """Point ``model``'s parameters at ``params`` ({name: nn.Parameter}),
    without a copy."""
    mods = dict(model.named_modules())
    for name, t in params.items():
        mod, _, attr = name.rpartition(".")
        m = mods[mod]
        if m._parameters[attr] is not t:
            m._parameters[attr] = t


def init_train_state(model: Model, seed: int | None = None, *,
                     plan=None, n_pods: int = 0,
                     state_dtype: str = "float32") -> TrainState:
    """A fresh training state for ``model``.  ``seed``: weights from
    ``Model.init(seed)``, in new tensors (a state made earlier keeps its
    own); None: copies of the weights the model holds (e.g. bridged from
    the reference).  f32 (or ``state_dtype``) moments on the model's
    device.

    ``plan`` (a train plan of a ``DeviceMesh``; every rank calls this
    together): the state holds this rank's shard of each weight and
    moment (``plan.shard_shape``), copied from the whole weights, which
    the caller may then free.  ``n_pods`` (the plan's pod count): an f32
    compression residual of the rank's ``model`` block of each leaf,
    whole over the DP axes (``TrainLayout.pod_region``)."""
    if any(True for _ in packed_leaves(model)):
        raise NotImplementedError("training a quantized view: its packed "
                                  "weights have no gradients")
    if n_pods and plan is None:
        raise ValueError("n_pods= is the residual of cross-pod compression: "
                         "it needs a plan= of a mesh with a 'pod' axis")
    if seed is not None:
        _fresh_parameters(model)
        model.init(seed)
    if plan is None:
        if seed is not None:
            params = {n: p.requires_grad_(True)
                      for n, p in model.named_parameters()}
        else:
            params = {n: nn.Parameter(p.detach().clone())
                      for n, p in model.named_parameters()}
        return TrainState(params=params,
                          opt_state=init_opt_state(params, state_dtype))
    from repro_torch.parallel.train import TrainLayout, refuse_non_train
    refuse_non_train(plan)
    lay = TrainLayout(model, plan)
    pods = lay.groups.sizes["pod"]
    if n_pods and n_pods != pods:
        raise ValueError(f"n_pods={n_pods}, the plan's mesh has {pods} pods")
    params = {n: nn.Parameter(lay.shard(n, p.detach()))
              for n, p in model.named_parameters()}
    err = None
    if n_pods:
        err = {n: torch.zeros(p.detach()[lay.pod_region(n)].shape,
                              dtype=torch.float32, device=p.device)
               for n, p in model.named_parameters()}
    return TrainState(params=params,
                      opt_state=init_opt_state(params, state_dtype),
                      err=err, layout=lay)


def _train_plan(model: Model, mesh, plan):
    """The train plan a mesh step runs: ``plan``, or the one of ``mesh``
    (a ``DeviceMesh``, or a "DxM" / "PxDxM" spec over the initialised
    world)."""
    from repro_torch.launch.mesh import MeshShape, parse_mesh
    from repro_torch.parallel.plan import make_plan
    from repro_torch.parallel.train import refuse_non_train
    if plan is None:
        if isinstance(mesh, MeshShape):
            raise ValueError(
                f"mesh {mesh.shape}: a MeshShape only prices; training needs "
                f"a DeviceMesh over its ranks (launch them with torchrun "
                f"--nproc-per-node {mesh.size()}, then launch.mesh."
                f"parse_mesh)")
        if isinstance(mesh, str):
            mesh = parse_mesh(mesh, model.device)
        plan = make_plan(model.cfg, mesh, global_batch=0, shape_kind="train")
    refuse_non_train(plan)
    return plan


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    remat: bool = False, compress_pods: bool = False,
                    mesh=None, plan=None, keep_grads=False):
    """Build ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds tensors on the model's device (``Model.loss``'s dict).  The
    returned state shares the updated tensors with the one passed in.

    ``mesh`` / ``plan``: the sharded step of a state from
    ``init_train_state(plan=)`` (``batch``: the rank's rows).
    ``compress_pods``: the cross-pod mean int8-compressed (a state with
    ``err``, updated in place).  ``keep_grads``: ``train_step.grads``
    keeps the last step's reduced gradients (the rank's shards; on one
    device the whole leaves), before the clip, and with compression
    ``train_step.pod_grads`` the in-pod ones it compressed; True keeps
    every leaf, a collection of names those leaves."""
    if compress_pods and mesh is None and plan is None:
        raise ValueError("compress_pods=True needs a mesh with a 'pod' axis "
                         "(mesh= or plan=), as the reference asserts")
    if mesh is not None or plan is not None:
        plan = _train_plan(model, mesh, plan)
        if compress_pods and "pod" not in tuple(plan.mesh.mesh_dim_names):
            raise ValueError(f"compress_pods=True: the mesh "
                             f"{tuple(plan.mesh.mesh_dim_names)} has no "
                             f"'pod' axis")
        return _make_sharded_step(model, opt_cfg, plan, remat=remat,
                                  compress=compress_pods,
                                  keep_grads=keep_grads)
    decay = decay_mask(model)

    def train_step(state: TrainState, batch: dict):
        bind_params(model, state.params)
        params = state.params
        for p in params.values():
            p.grad = None
        loss = model.loss(batch, remat=remat)
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        if keep_grads:
            train_step.grads = {n: g.clone() for n, g in grads.items()
                                if keep_grads is True or n in keep_grads}
        _, new_opt, metrics = adamw_update(opt_cfg, params, grads,
                                           state.opt_state, decay=decay)
        for p in params.values():
            p.grad = None
        metrics["loss"] = loss.detach()
        return TrainState(params, new_opt, state.err), metrics

    train_step.grads = None
    return train_step


def _make_sharded_step(model: Model, opt_cfg: AdamWConfig, plan, *,
                       remat: bool, compress: bool, keep_grads):
    """The step of a sharded state (``parallel.train``)."""
    from repro_torch.parallel import compression
    from repro_torch.parallel.train import global_norm
    decay = decay_mask(model)
    checked = set()

    def keep(name: str) -> bool:
        return keep_grads is True or name in (keep_grads or ())

    def train_step(state: TrainState, batch: dict):
        lay = state.layout
        if lay is None or lay.plan.mesh is not plan.mesh:
            raise ValueError("a sharded step takes the state "
                             "init_train_state(plan=) made on its mesh")
        if compress and state.err is None:
            raise ValueError("compress_pods=True: the state has no "
                             "residual (init_train_state(n_pods=))")
        groups, dpc = lay.groups, lay.groups.comms["dp"]
        lay.compress = compress
        lay.grads = {}
        shape = tuple(next(iter(batch.values())).shape[:2])
        groups.set_phase("step")
        dev = next(iter(batch.values())).device
        if shape not in checked and dev.type != "meta":
            # the mean of the rank means is the global mean only when
            # every rank holds as many tokens (a batch on meta, as counted
            # without ranks, holds no values to compare)
            if dpc.backend == "gloo":
                dev = torch.device("cpu")
            every = dpc.all_gather_stack(torch.tensor(shape, device=dev))
            if not bool((every == every[0]).all()):
                raise ValueError(f"DP ranks hold batches of unequal shapes "
                                 f"{every.tolist()}")
            checked.add(shape)
        params = state.params
        with lay.computing(params):       # remat recomputes in backward
            groups.set_phase("fwd")
            loss = model.loss(batch, remat=remat)
            groups.set_phase("bwd")
            (loss / lay.batch_comm.size).backward()
        groups.set_phase("step")
        grads = lay.grads
        lay.grads = {}
        err = state.err
        if compress:
            pods = groups.comms["pod"]
            synced, err, kept = {}, state.err, {}
            for name in list(grads):
                g = grads.pop(name)           # freed leaf by leaf
                if keep(name):
                    kept[name] = g
                leaf = lay.leaves[name]
                amax = lay.model_comm if leaf.tp_dim is not None else None
                mean, _ = compression.compressed_mean(
                    g, err[name], pods, amax_comm=amax, inplace=True)
                if leaf.fs_dim is not None:
                    mean = mean[tuple(
                        leaf.block[d] if d == leaf.fs_dim else slice(None)
                        for d in range(mean.ndim))].clone()
                synced[name] = mean
            grads = synced
            if keep_grads:
                train_step.pod_grads = kept
        if keep_grads:
            train_step.grads = {n: g for n, g in grads.items() if keep(n)}
        gn = global_norm(lay, grads)
        _, new_opt, metrics = adamw_update(opt_cfg, params, grads,
                                           state.opt_state, decay=decay,
                                           grad_norm=gn)
        total = dpc.all_reduce_op(loss.detach().reshape(1), kind="loss")
        metrics["loss"] = (total / dpc.size)[0]
        groups.set_phase(None)
        return TrainState(params, new_opt, err, lay), metrics

    train_step.grads = train_step.pod_grads = None
    return train_step
