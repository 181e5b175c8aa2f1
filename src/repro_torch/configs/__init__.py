"""Architecture config registry of the port.

A copy of ``repro.configs`` for the architectures the port serves so far:
the ``attn_dense`` family (plain GQA, qk-norm, qkv bias).  ``get_config``
accepts the registry id (``qwen2.5-14b``) or the module name
(``qwen2_5_14b``); ``reduced_config`` is the reference's tiny same-family
config for CPU parity tests, field for field.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ModelConfig

_ARCH_MODULES = {
    "llama3-8b": "llama3_8b",
    "qwen3-14b": "qwen3_14b",
    "qwen2.5-14b": "qwen2_5_14b",
}


def get_config(name: str) -> ModelConfig:
    key = name if name in _ARCH_MODULES else None
    if key is None:
        for k, mod in _ARCH_MODULES.items():
            if mod == name.replace("-", "_").replace(".", "_"):
                key = k
                break
    if key is None:
        raise KeyError(f"unknown or unported architecture {name!r}; the "
                       f"port knows {list(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[key]}")
    return mod.CONFIG


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw: dict = dict(
        name=cfg.name + "-reduced",
        n_layers=2 if cfg.moe_layer_period <= 1 else 2 * cfg.moe_layer_period,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        vocab_pad_multiple=1,
    )
    if cfg.mla:
        kw.update(kv_lora_rank=32, rope_head_dim=8, head_dim=16)
    if cfg.moe:
        kw.update(n_experts=4, n_experts_per_token=min(2, cfg.n_experts_per_token),
                  moe_d_ff=64,
                  first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.ssm or cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=8, ssm_head_dim=8, ssm_heads=0, ssm_chunk=16)
    if cfg.sliding_window is not None:
        kw.update(sliding_window=8)
    return dataclasses.replace(cfg, **kw)
