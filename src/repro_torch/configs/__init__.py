"""Architecture config registry of the port.

A copy of ``repro.configs``, all 14 of its architectures:
the ``attn_dense`` family (plain GQA, qk-norm, qkv bias): llama3-8b,
-70b and -405b, qwen3-14b, qwen2.5-14b; deepseek-v2-lite-16b (MLA
attention, MoE with shared experts, a first dense layer); and the
``attn_moe`` family (GQA attention, top-1 MoE with one shared expert):
llama4-scout-109b-a17b (MoE every layer; the paper's simulator baseline)
and llama4-maverick-400b-a17b (dense and MoE layers alternating);
phi3-mini-3.8b (full MHA at head dim 96), h2o-danube-1.8b (GQA at
head dim 80, every layer a 4096-token sliding window), mamba2-370m (the
``ssm`` family: Mamba2 SSD blocks, no attention) and hymba-1.5b (the
``hybrid`` family: attention and SSM heads side by side in every layer,
a 1024-token window on all but three), and the two modality frontends:
hubert-xlarge (an encoder-only, non-causal audio model at head dim 80:
``in_proj`` of precomputed frame features, no decode step) and
internvl2-26b (an InternLM2 backbone with 256 image embeddings ahead of
the text tokens).  ``get_config``
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
    "llama3-70b": "llama3_70b",
    "llama3-405b": "llama3_405b",
    "qwen3-14b": "qwen3_14b",
    "qwen2.5-14b": "qwen2_5_14b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "llama4-scout-109b-a17b": "llama4_scout",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "mamba2-370m": "mamba2_370m",
    "hymba-1.5b": "hymba_1_5b",
    "hubert-xlarge": "hubert_xlarge",
    "internvl2-26b": "internvl2_26b",
}

# the dry-run's ten (``launch/dryrun.py --all``): the reference's
# assigned architectures, in its order (the rest are the paper's models)
ASSIGNED_ARCHS = ["h2o-danube-1.8b", "qwen2.5-14b", "qwen3-14b",
                  "phi3-mini-3.8b", "hubert-xlarge",
                  "llama4-maverick-400b-a17b", "deepseek-v2-lite-16b",
                  "hymba-1.5b", "internvl2-26b", "mamba2-370m"]


def list_configs() -> list[str]:
    return list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    key = name if name in _ARCH_MODULES else None
    if key is None:
        for k, mod in _ARCH_MODULES.items():
            if mod == name.replace("-", "_").replace(".", "_"):
                key = k
                break
    if key is None:
        raise KeyError(f"unknown architecture {name!r}; know "
                       f"{list(_ARCH_MODULES)}")
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
