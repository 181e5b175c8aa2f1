"""InternVL2-26B — InternViT frontend (stubbed: input_specs provides patch
embeddings) + InternLM2 LM backbone.  [arXiv:2404.16821]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553, vocab_pad_multiple=512,
    frontend="vision",
    n_frontend_tokens=256,     # image patch tokens prepended
    rope_theta=1000000.0,
)
