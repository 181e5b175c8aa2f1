"""Mamba2-370M — attention-free SSD (state-space duality) stack.
[arXiv:2405.21060]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                    # no MLP: pure mamba blocks
    vocab_size=50280, vocab_pad_multiple=512,
    ssm=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,              # d_inner = 2048 -> 32 heads
    ssm_chunk=256,
    conv_kernel=4,
    tie_embeddings=True,
)
