"""Llama3-405B (paper simulator baseline)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense", n_layers=126, d_model=16384,
    n_heads=128, n_kv_heads=8, head_dim=128, d_ff=53248,
    vocab_size=128256, vocab_pad_multiple=512, rope_theta=500000.0,
)
