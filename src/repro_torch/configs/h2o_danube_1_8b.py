"""H2O-Danube-1.8B — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000, vocab_pad_multiple=512,
    sliding_window=4096,      # SWA => runs the long_500k shape
    rope_theta=10000.0,
)
