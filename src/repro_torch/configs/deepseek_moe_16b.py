"""DeepSeekMoE 16B [arXiv:2401.06066].

28L d_model=2048 16H (kv=16) vocab=102400; fine-grained MoE: 64 routed
experts top-6 + 2 shared experts, expert d_ff=1408; first layer dense
(d_ff=10944).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,                   # dense first layer
    vocab_size=102400,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_k_dense=1,
    activation="swiglu",
    source="arXiv:2401.06066 (DeepSeekMoE)",
)
