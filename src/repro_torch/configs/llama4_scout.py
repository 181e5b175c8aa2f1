"""Llama4-Scout 109B-A17B (paper simulator baseline): 16 experts top-1,
MoE every layer, one shared expert."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-109b-a17b", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=202048, vocab_pad_multiple=512,
    moe=True, n_experts=16, n_experts_per_token=1, n_shared_experts=1,
    moe_d_ff=8192, moe_layer_period=1, rope_theta=500000.0,
)
