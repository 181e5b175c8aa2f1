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

Cross-pod int8 gradient compression (``compress_pods=True``, ``n_pods=``)
is a mesh feature and raises, naming ROADMAP Queue 1, 'Tensor
parallelism'.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.models.model import Model
from repro_torch.quant.linear import packed_leaves
from repro_torch.runtime.engine import _unported
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state

TP_ITEM = "Parallel training and the dry-run's meshes"


@dataclasses.dataclass
class TrainState:
    params: dict                 # name -> trainable nn.Parameter
    opt_state: dict              # {"m": {...}, "v": {...}, "step": int32}
    err: Any = None              # cross-pod compression residual (unported)

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
                     n_pods: int = 0,
                     state_dtype: str = "float32") -> TrainState:
    """A fresh training state for ``model``.  ``seed``: weights from
    ``Model.init(seed)``, in new tensors (a state made earlier keeps its
    own); None: copies of the weights the model holds (e.g. bridged from
    the reference).  f32 (or ``state_dtype``) moments on the model's
    device."""
    if n_pods:
        raise _unported("cross-pod gradient compression (n_pods=)", TP_ITEM)
    if any(True for _ in packed_leaves(model)):
        raise NotImplementedError("training a quantized view: its packed "
                                  "weights have no gradients")
    if seed is not None:
        _fresh_parameters(model)
        model.init(seed)
        params = {n: p.requires_grad_(True)
                  for n, p in model.named_parameters()}
    else:
        params = {n: nn.Parameter(p.detach().clone())
                  for n, p in model.named_parameters()}
    return TrainState(params=params,
                      opt_state=init_opt_state(params, state_dtype))


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    remat: bool = False, compress_pods: bool = False,
                    mesh=None):
    """Build ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds tensors on the model's device (``Model.loss``'s dict).  The
    returned state shares the updated tensors with the one passed in."""
    if compress_pods or mesh is not None:
        raise _unported("cross-pod int8 gradient compression "
                        "(compress_pods=True, mesh=)", TP_ITEM)
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
        _, new_opt, metrics = adamw_update(opt_cfg, params, grads,
                                           state.opt_state, decay=decay)
        for p in params.values():
            p.grad = None
        metrics["loss"] = loss.detach()
        return TrainState(params, new_opt, state.err), metrics

    return train_step
