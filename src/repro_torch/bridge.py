"""Weight bridge between the reference's parameter pytree and the port's
``Model``.

The reference (``repro.models.model.Model.init``) keeps a segment's layer
weights stacked along a leading layer axis, in bf16 (``ml_dtypes``) and
f32.  ``params_from_jax`` takes that pytree, already converted to numpy
(``jax.tree.map(np.asarray, params)``), into a ``Model``'s modules; bf16
crosses as raw bits (uint16 -> int16 -> ``torch.bfloat16`` views, never
through float), so the copy is exact.  ``params_to_numpy`` is the reverse,
for the round-trip test.  This module needs numpy only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.model import Model


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # jax-backed arrays are read-only views
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy()


def _leaf(np_params: dict, name: str, stacked: bool):
    """The reference leaf behind a port parameter name.

    ``layers.<i>.attn.wq`` -> ``stacks[0][0]["attn"]["wq"][i]`` (the layer
    index only when the segment is stacked, i.e. has more than one layer);
    top-level names (``embed``, ``head``, ``final_norm``) map one to one."""
    parts = name.split(".")
    if parts[0] != "layers":
        return np_params[name]
    (block,) = np_params["stacks"][0]
    node = block
    for key in parts[2:]:
        node = node[key]
    return node[int(parts[1])] if stacked else node


def params_from_jax(np_params: dict, cfg: ModelConfig,
                    device: str | torch.device = "cuda") -> Model:
    """A ``Model`` on ``device`` holding exactly the reference's weights."""
    if len(np_params["stacks"]) != 1 or len(np_params["stacks"][0]) != 1:
        raise NotImplementedError("the bridge maps single-segment attn_dense "
                                  "plans only")
    model = Model(cfg, device)
    stacked = cfg.n_layers > 1
    with torch.no_grad():
        for name, p in model.named_parameters():
            src = _to_torch(_leaf(np_params, name, stacked))
            if src.dtype != p.dtype or tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference leaf {src.dtype} "
                                 f"{tuple(src.shape)} vs port {p.dtype} "
                                 f"{tuple(p.shape)}")
            p.copy_(src)
    # every reference leaf must have landed somewhere: one per top-level
    # parameter, one per per-layer parameter (stacked over layers)
    names = [n for n, _ in model.named_parameters()]
    n_top = sum(1 for n in names if not n.startswith("layers."))
    expected = n_top + (len(names) - n_top) // cfg.n_layers
    if _count_leaves(np_params) != expected:
        raise ValueError(f"reference pytree has {_count_leaves(np_params)} "
                         f"leaves, the port maps {expected}")
    return model


def _count_leaves(node) -> int:
    if isinstance(node, dict):
        return sum(_count_leaves(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return sum(_count_leaves(v) for v in node)
    return 1


def params_to_numpy(model: Model) -> dict:
    """The reference-layout numpy pytree of ``model``'s weights (layer
    weights stacked along a leading axis when there is more than one)."""
    stacked = model.cfg.n_layers > 1
    per_layer: dict = {}
    out: dict = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "layers":
            out[name] = _to_numpy(p)
            continue
        node = per_layer
        for key in parts[2:-1]:
            node = node.setdefault(key, {})
        node.setdefault(parts[-1], []).append(_to_numpy(p))

    def stack(node):
        if isinstance(node, dict):
            return {k: stack(v) for k, v in node.items()}
        return np.stack(node) if stacked else node[0]

    out["stacks"] = [(stack(per_layer),)]
    return out
