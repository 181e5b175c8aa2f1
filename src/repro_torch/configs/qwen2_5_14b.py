"""Qwen2.5-14B — GQA with QKV bias.  [hf:Qwen/Qwen2.5-14B]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064, vocab_pad_multiple=512,
    qkv_bias=True,
    rope_theta=1000000.0,
)
