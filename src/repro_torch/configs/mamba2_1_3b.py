"""Mamba2 1.3B [arXiv:2405.21060] — SSD (state-space duality).

48L d_model=2048, attention-free, ssm_state=128, vocab=50280.
Mamba2 blocks have no separate MLP (d_ff=0).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,                  # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba2 / SSD)",
)
