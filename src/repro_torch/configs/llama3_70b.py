"""Llama3-70B (paper simulator baseline)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-70b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=28672,
    vocab_size=128256, vocab_pad_multiple=512, rope_theta=500000.0,
)
