"""Checkpointing with atomic commit, async save and elastic restore: the
port of ``repro/train/checkpoint.py``.

Layout::

    <dir>/step_<N>/arrays.npz     flattened leaves, key = joined tree path
    <dir>/step_<N>/tree.json      tree paths + dtypes/shapes
    <dir>/step_<N>/COMMIT         written last => checkpoint is valid

The leaves are written to ``step_<N>.tmp`` and the directory is renamed
once ``COMMIT`` is in it, so ``restore_latest``, which considers committed
checkpoints only, never restores a torn write.

A bf16 leaf is stored as its raw 16-bit words (uint16) with its dtype
named in ``tree.json``: numpy has no bf16 without ``ml_dtypes``, which the
card's machine lacks.  A restore puts each leaf on its template leaf's
device, in its dtype (a template ``nn.Parameter`` gives a parameter of
the same ``requires_grad``).

A sharded state (``init_train_state(plan=)``) saves its whole leaves:
every rank takes part in gathering each leaf (``TrainLayout.gather_full``;
a residual's pods stacked on a leading axis, the reference's layout), rank
0 writes the files, and the others wait at a barrier (an async save: rank
0's writer thread; the loop waits for it before reading).  So a one-device
checkpoint and a mesh checkpoint of one state are the same bytes.  A
restore onto a mesh (``shardings=``: a plan, or the ``TrainLayout`` of a
template made on the current mesh; a sharded template's own by default)
has each rank read each leaf and keep its shard, so a state saved on one
mesh restores onto another, onto one device and off it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
from torch import nn

from repro_torch.train.train_step import TrainState

_SEP = "/"


def _items(node):
    """(key, child) pairs of a tree node; None for a leaf."""
    if isinstance(node, TrainState):
        return [("params", node.params), ("opt_state", node.opt_state),
                ("err", node.err)]
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten_with_paths(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """{joined path: tensor} of every tensor leaf (None subtrees are
    empty, as in a pytree)."""
    if tree is None:
        return {}
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat = {}
    for key, child in items:
        flat.update(_flatten_with_paths(
            child, f"{prefix}{_SEP}{key}" if prefix else key))
    return flat


def _unflatten(template, leaves: dict, prefix: str = ""):
    """``template``'s structure with each leaf taken from ``leaves``."""
    if template is None:
        return None
    items = _items(template)
    if items is None:
        return leaves[prefix]
    kids = [_unflatten(child, leaves,
                       f"{prefix}{_SEP}{key}" if prefix else key)
            for key, child in items]
    if isinstance(template, TrainState):
        return TrainState(*kids, layout=template.layout)
    if isinstance(template, dict):
        return dict(zip(template.keys(), kids))
    return type(template)(kids)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    # a copy on the CPU too: the step updates the weights and moments in
    # place while an async save writes them
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.asarray(arr, order="C")          # keeps a 0-d leaf 0-d
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _whole_leaves(state: TrainState) -> dict[str, torch.Tensor]:
    """{path: whole leaf} of a sharded state, gathered from every rank
    (each rank calls this; the residual's pods on a leading axis)."""
    lay = state.layout
    out = {}
    for key, tree in (("params", state.params),
                      ("opt_state/m", state.opt_state["m"]),
                      ("opt_state/v", state.opt_state["v"])):
        for name, t in tree.items():
            out[f"{key}{_SEP}{name}"] = lay.gather_full(name, t.detach())
    out[f"opt_state{_SEP}step"] = state.opt_state["step"]
    if state.err is not None:
        for name, t in state.err.items():
            out[f"err{_SEP}{name}"] = lay.gather_pod_regions(name, t)
    return out


def is_writer(state) -> bool:
    """Whether this process writes ``state``'s checkpoints (rank 0 of a
    sharded state; the only process otherwise)."""
    lay = getattr(state, "layout", None)
    return lay is None or torch.distributed.get_rank() == 0


def save_checkpoint(ckpt_dir: str, step: int, state, *,
                    async_save: bool = False) -> str | threading.Thread | None:
    """Save ``state`` (a ``TrainState`` or a tree of dicts, lists and
    tensors).  The leaves come to the host here; with ``async_save`` the
    files are written by a thread, which is returned (else the path).  A
    sharded state: every rank calls this; rank 0 writes (and returns as
    above), the others return the path after the barrier (None after an
    async save, whose thread only rank 0 holds)."""
    lay = getattr(state, "layout", None)
    tensors = (_whole_leaves(state) if lay is not None
               else _flatten_with_paths(state))
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not is_writer(state):
        if not async_save:
            torch.distributed.barrier()
        return None if async_save else path
    flat = {k: _to_numpy(t) for k, t in tensors.items()}   # device->host
    meta = {"step": int(step), "treedef": sorted(flat),
            "leaves": {k: {"shape": list(t.shape), "dtype": _dtype_name(t)}
                       for k, t in tensors.items()}}

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    if lay is not None:
        torch.distributed.barrier()
    return path


def list_checkpoints(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "COMMIT")):
                steps.append(int(d[5:]))
    return sorted(steps)


def _layout_of(template, shardings):
    """The ``TrainLayout`` a restore slices by: ``shardings`` (a layout, or
    a plan that is the template's), else a sharded template's own."""
    lay = getattr(template, "layout", None)
    if shardings is None:
        return lay
    if hasattr(shardings, "leaves") and hasattr(shardings, "plan"):
        return shardings
    if lay is None or shardings is not lay.plan:
        raise ValueError(
            "shardings=: a restore onto a mesh takes the TrainLayout (or "
            "the plan) of a template made by init_train_state(plan=) on "
            "the current mesh")
    return lay


def _shard_of(lay, key: str, whole: torch.Tensor) -> torch.Tensor:
    """This rank's part of a checkpoint leaf at ``key``."""
    head, _, name = key.partition(_SEP)
    if head == "opt_state":
        sub, _, name = name.partition(_SEP)
        if sub == "step":
            return whole
    if head == "err":
        pod = lay.groups.coord["pod"]
        return whole[pod][lay.pod_region(name)].clone()
    return lay.shard(name, whole)


def restore_checkpoint(ckpt_dir: str, step: int, template, *,
                       shardings=None):
    """Restore into the structure of ``template``: each leaf on its
    template leaf's device and in its dtype.  On a mesh (a sharded
    template, or ``shardings=``) each rank keeps its shard of each leaf,
    whatever mesh wrote it."""
    lay = _layout_of(template, shardings)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)["leaves"]
    leaves = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for k, t in _flatten_with_paths(template).items():
            arr = data[k]
            x = _from_numpy(arr, meta[k]["dtype"])
            if lay is not None:
                x = _shard_of(lay, k, x)
            if list(x.shape) != list(t.shape):
                raise ValueError(f"checkpoint leaf {k} shape {arr.shape} "
                                 f"!= template {tuple(t.shape)}")
            x = x.to(device=t.device, dtype=t.dtype)
            leaves[k] = (nn.Parameter(x, requires_grad=t.requires_grad)
                         if isinstance(t, nn.Parameter) else x)
    return _unflatten(template, leaves)


def restore_latest(ckpt_dir: str, template, *, shardings=None):
    """Returns (state, step) from the newest committed checkpoint, or
    (None, -1) if none exists."""
    steps = list_checkpoints(ckpt_dir)
    if not steps:
        return None, -1
    step = steps[-1]
    return restore_checkpoint(ckpt_dir, step, template,
                              shardings=shardings), step
