"""Qwen3-14B — GQA with per-head qk-norm.  [hf:Qwen/Qwen3-14B]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936, vocab_pad_multiple=512,
    qk_norm=True,
    rope_theta=1000000.0,
)
