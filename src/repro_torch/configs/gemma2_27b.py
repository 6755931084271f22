"""Gemma 2 27B [arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000;
alternating local(4096)/global attention, attn softcap 50, final softcap 30.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    arch_type="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    rope_theta=10_000.0,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    local_global_alternating=True,
    activation="geglu",
    tie_embeddings=True,
    source="arXiv:2408.00118 (Gemma 2)",
)
