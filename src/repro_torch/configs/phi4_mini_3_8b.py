"""Phi-4-mini 3.8B [arXiv:2412.08905].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064; RoPE + SwiGLU + GQA.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    rope_theta=10_000.0,
    activation="swiglu",
    tie_embeddings=True,
    source="arXiv:2412.08905 (Phi-4)",
)
