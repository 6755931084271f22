"""Kimi K2 — trillion-param MoE [arXiv:2501.kimi2 / paper-table].

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384 experts top-8 + 1 shared expert, first layer dense.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,                 # dense first layer (DeepSeek-V3 lineage)
    vocab_size=163840,
    rope_theta=50_000.0,
    num_experts=384,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_k_dense=1,
    activation="swiglu",
    source="arXiv:2501.kimi2 (Kimi K2 paper table)",
)
