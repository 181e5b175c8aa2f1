"""HuBERT-XLarge — encoder-only audio transformer; the conv feature
frontend is a stub (input_specs provides precomputed frame embeddings).
[arXiv:2106.07447]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504, vocab_pad_multiple=512,           # cluster targets
    causal=False,             # bidirectional; no decode step
    frontend="audio",
)
