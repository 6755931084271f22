"""Zamba2 2.7B [arXiv:2411.15242].

54 Mamba2 layers d_model=2560 with a shared attention block (32H kv=32)
applied every 6 layers; d_ff=10240; ssm_state=64; vocab=32000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,                 # shared block cadence
    activation="swiglu",
    source="arXiv:2411.15242 (Zamba2)",
)
