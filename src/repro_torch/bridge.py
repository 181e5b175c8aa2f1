"""Weight bridge between the reference's parameter pytree and the port's
``Model``.

The reference (``repro.models.model.Model.init``) keeps a segment's layer
weights stacked along a leading layer axis, in bf16 (``ml_dtypes``) and
f32.  ``params_from_jax`` takes that pytree, already converted to numpy
(``jax.tree.map(np.asarray, params)``), into a ``Model``'s modules; bf16
and fp8 cross as raw bits (``torch`` views of the same bytes, never through
float), so the copy is exact.  A quantized pytree
(``jax.tree.map(np.asarray, quantize_params(params, fmt))``) carries packed
leaves (``PackedMXFP4`` and the other packed types, recognised by class
name); they become the port's packed classes with the same codes and
scales, in a model whose projections are packed as
``quant.linear.quantize_params`` would pack them.  ``params_to_numpy`` is
the reverse for dense models, for the round-trip test.  This module needs
numpy only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.model import Model
from repro_torch.quant import formats

_PACKED_BY_NAME = {cls.__name__: cls for cls in formats.PACKED_TYPES}


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # jax-backed arrays are read-only views
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _packed(leaf, index):
    """The port's packed tensor for a reference packed leaf (layer
    ``index`` of a stacked one, or the whole leaf when ``index`` is None);
    None when ``leaf`` is a plain array."""
    cls = _PACKED_BY_NAME.get(type(leaf).__name__)
    if cls is None:
        return None
    children, shape = leaf.tree_flatten()
    return cls(*(_to_torch(c if index is None else c[index])
                 for c in children), tuple(shape))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy()


def _leaf(np_params: dict, name: str, stacked: bool):
    """The reference leaf behind a port parameter name, as a torch tensor
    or a packed tensor.

    ``layers.<i>.attn.wq`` -> ``stacks[0][0]["attn"]["wq"][i]`` (the layer
    index only when the segment is stacked, i.e. has more than one layer);
    top-level names (``embed``, ``head``, ``final_norm``) map one to one."""
    parts = name.split(".")
    if parts[0] != "layers":
        return _to_torch(np_params[name])
    (block,) = np_params["stacks"][0]
    node = block
    for key in parts[2:]:
        node = node[key]
    index = int(parts[1]) if stacked else None
    packed = _packed(node, index)
    if packed is not None:
        return packed
    return _to_torch(node if index is None else node[index])


def params_from_jax(np_params: dict, cfg: ModelConfig,
                    device: str | torch.device = "cuda") -> Model:
    """A ``Model`` on ``device`` holding exactly the reference's weights."""
    if len(np_params["stacks"]) != 1 or len(np_params["stacks"][0]) != 1:
        raise NotImplementedError("the bridge maps single-segment attn_dense "
                                  "plans only")
    model = Model(cfg, device)
    stacked = cfg.n_layers > 1
    names = [n for n, _ in model.named_parameters()]
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            src = _leaf(np_params, name, stacked)
            if isinstance(src, formats.PACKED_TYPES):
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: packed reference leaf of "
                                     f"logical shape {src.shape} vs port "
                                     f"{tuple(p.shape)}")
                mod_name, _, attr = name.rpartition(".")
                mod = modules[mod_name]
                del mod._parameters[attr]
                setattr(mod, attr, src.map(lambda t: t.to(model.device)))
                continue
            if src.dtype != p.dtype or tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference leaf {src.dtype} "
                                 f"{tuple(src.shape)} vs port {p.dtype} "
                                 f"{tuple(p.shape)}")
            p.copy_(src)
    # every reference leaf must have landed somewhere: one per top-level
    # parameter, one per per-layer parameter (stacked over layers)
    n_top = sum(1 for n in names if not n.startswith("layers."))
    expected = n_top + (len(names) - n_top) // cfg.n_layers
    if _count_leaves(np_params) != expected:
        raise ValueError(f"reference pytree has {_count_leaves(np_params)} "
                         f"leaves, the port maps {expected}")
    return model


def _count_leaves(node) -> int:
    """Leaves of a reference pytree; a packed leaf counts once."""
    if isinstance(node, dict):
        return sum(_count_leaves(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return sum(_count_leaves(v) for v in node)
    return 1


def params_to_numpy(model: Model) -> dict:
    """The reference-layout numpy pytree of a dense ``model``'s weights
    (layer weights stacked along a leading axis when there is more than
    one)."""
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
