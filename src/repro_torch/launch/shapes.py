"""Assigned input shapes and ``meta`` stand-ins per (arch x shape), the
port of ``repro/launch/shapes.py``.

The four assigned LM shapes (seq_len x global_batch):
  train_4k     4,096 x 256    runs ``train_step``
  prefill_32k  32,768 x 32    runs the prefill forward
  decode_32k   32,768 x 128   runs the serve step (1 new token, KV$ of S)
  long_500k    524,288 x 1    runs the serve step; sub-quadratic archs only

The reference's stand-ins are ``jax.ShapeDtypeStruct`` trees; here they
are tensors on the ``meta`` device: shapes and dtypes with no storage, so
a full-size cell allocates nothing and a step runs on them eagerly (the
dry-run's op counter, ``core/op_cost.py``).  ``device=`` puts the same
specs on another device (uninitialised) to time a cell.  Frontends are
stubs per the assignment: ``[audio]`` provides frame embeddings,
``[vlm]`` provides patch embeddings.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.model import Model

# image tokens prepended for the VLM frontend stub (InternViT 448px ~ 256
# patch tokens per tile).
VLM_IMAGE_TOKENS = 256


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode | long_decode
    seq_len: int
    global_batch: int

    @property
    def step_kind(self) -> str:
        return {"train": "train", "prefill": "prefill",
                "decode": "decode", "long_decode": "decode"}[self.kind]


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "long_decode", 524288, 1),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether this (arch x shape) cell is runnable, with the skip reason."""
    if shape.kind in ("decode", "long_decode") and not cfg.has_decode:
        return False, "encoder-only: no decode step"
    if shape.kind == "long_decode" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, batch: int | None = None,
                device="meta") -> dict:
    """Stand-ins for the data batch of a train/prefill step (``batch``
    rows, the shape's global batch unless given)."""
    b, s = batch or shape.global_batch, shape.seq_len
    if cfg.frontend == "audio":
        return {"features": torch.empty((b, s, cfg.d_model),
                                        dtype=torch.bfloat16, device=device),
                "labels": torch.empty((b, s), dtype=torch.int32,
                                      device=device)}
    text = s - (VLM_IMAGE_TOKENS if cfg.frontend == "vision" else 0)
    out = {"tokens": torch.empty((b, text), dtype=torch.int32, device=device)}
    if cfg.frontend == "vision":
        out["image_embeds"] = torch.empty((b, VLM_IMAGE_TOKENS, cfg.d_model),
                                          dtype=torch.bfloat16, device=device)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeSpec, model: Model,
                 batch: int | None = None):
    """(tokens, cache, cur_pos) of a serve step: tokens and the cache
    (``Model.init_cache(b, s)``) on the model's device, cur_pos an int."""
    b, s = batch or shape.global_batch, shape.seq_len
    tokens = torch.empty((b,), dtype=torch.int32, device=model.device)
    cache = model.init_cache(b, s)
    return tokens, cache, s - 1


def param_specs(model: Model) -> dict:
    """{name: parameter} of the model (on ``meta`` for a ``meta`` model)."""
    return dict(model.named_parameters())
