"""DeepSeek-V2-Lite 16B — MLA (kv_lora=512) + MoE 64 routed experts
top-6 with 2 shared experts; first layer dense.  [arXiv:2405.04434]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,               # first dense layer FFN
    vocab_size=102400, vocab_pad_multiple=512,
    mla=True,
    kv_lora_rank=512,
    rope_head_dim=64,
    v_head_dim=128,
    moe=True,
    n_experts=64,
    n_experts_per_token=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=10000.0,
)
