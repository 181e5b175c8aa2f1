"""AdamW with f32 accumulators over bf16 params: the port of
``repro/train/optimizer.py``, plain functions over dicts of tensors
(``{name: tensor}``, e.g. a model's named parameters and their
gradients) in place of pytrees.

The reference's formula, not ``torch.optim.AdamW``'s: f32 math, the
gradients clipped by their global norm, weight decay added to the update
(``lr * (mhat / (sqrt(vhat) + eps) + wd * p)``) and only on the tensors it
marks, accumulators in ``state_dtype``, the result cast back to each
parameter's dtype.  ``torch.optim.AdamW`` decays the weight by a factor
before its step, which rounds differently.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # Accumulator dtype.  f32 is the default; 400B-class configs use bf16
    # accumulators (the Gopher/PaLM recipe) so params+opt fit the pod:
    # 2 (params) + 2+2 (m,v) = 6 bytes/param instead of 10.
    state_dtype: str = "float32"


# elements of a tensor the update handles at once
CHUNK_ELEMS = 1 << 26


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * lr (f32)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def init_opt_state(params: dict, state_dtype: str = "float32") -> dict:
    """Zero ``m`` and ``v`` beside each parameter (on its device, in
    ``state_dtype``) and an int32 step counter."""
    dt = _dtype(state_dtype)
    dev = next(iter(params.values())).device
    return {"m": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for n, p in params.items()},
            "v": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tree.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, opt_state: dict,
                 *, decay: dict | None = None,
                 grad_norm: torch.Tensor | None = None):
    """Writes the new values into ``params`` and the accumulators, one
    tensor (and ``CHUNK_ELEMS`` elements) at a time (no second copy of
    the model), and returns
    (params, new_opt_state, metrics): the same tensors, and a new step.

    ``decay``: {name: bool}, the tensors weight decay applies to; None
    decays those of ndim >= 2, the reference's rule on its own layout
    (``train_step.decay_mask`` maps a model's parameters onto it).

    ``grad_norm``: the whole gradient's global norm when ``grads`` are a
    rank's shards (``parallel.train.global_norm``: every leaf counted
    once); the update itself is elementwise, so it runs on the shards."""
    step = opt_state["step"] + 1
    gn = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gn, 1e-12), 1.0)
    lr = lr_schedule(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** sf
    b2c = 1 - cfg.b2 ** sf

    for name, p in params.items():
        decays = (p.ndim >= 2) if decay is None else decay[name]
        flat = [t.view(-1) for t in (p.data, grads[name].contiguous(),
                                      opt_state["m"][name],
                                      opt_state["v"][name])]
        # elementwise, so a chunk at a time: the f32 temporaries stay
        # CHUNK_ELEMS long whatever the tensor (the same numbers)
        for i in range(0, p.numel(), CHUNK_ELEMS):
            p_c, g_c, m, v = (t[i:i + CHUNK_ELEMS] for t in flat)
            g = g_c.float() * clip
            m_n = cfg.b1 * m.float() + (1 - cfg.b1) * g
            v_n = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
            mhat = m_n / b1c
            vhat = v_n / b2c
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            # decoupled weight decay on matrices only
            if decays:
                delta = delta + cfg.weight_decay * p_c.float()
            p_c.copy_(p_c.float() - lr * delta)     # cast to p's dtype
            m.copy_(m_n)                            # and to state_dtype
            v.copy_(v_n)
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, {"grad_norm": gn, "lr": lr}
