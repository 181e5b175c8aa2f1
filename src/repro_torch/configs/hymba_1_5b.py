"""Hymba-1.5B — hybrid heads: attention and Mamba(2) SSM in parallel in
every layer; SWA except a few global layers.  [arXiv:2411.13676]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001, vocab_pad_multiple=512,
    sliding_window=1024,
    global_attn_every=16,      # global attention at layers 0, 16, 31
    ssm=True,
    hybrid=True,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,              # d_inner = 3200 -> 50 ssm heads
    ssm_chunk=256,
)
