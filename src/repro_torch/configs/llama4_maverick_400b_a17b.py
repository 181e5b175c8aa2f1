"""Llama4-Maverick 400B-A17B — MoE 128 experts top-1, alternating
dense/MoE layers, one shared expert.  [hf:meta-llama/Llama-4-Maverick]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,                # dense layers' FFN
    vocab_size=202048, vocab_pad_multiple=512,
    moe=True,
    n_experts=128,
    n_experts_per_token=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    moe_layer_period=2,       # every other layer is MoE
    rope_theta=500000.0,
)
