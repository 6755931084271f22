"""InternVL2-1B [arXiv:2404.16821].

LM backbone (Qwen2-0.5B lineage): 24L d_model=896 14H (GQA kv=2)
d_ff=4864 vocab=151655.  The InternViT vision encoder + MLP projector is a
stub per spec — the model consumes precomputed 1024-d patch embeddings
(256 patches) prepended to the text sequence.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    arch_type="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    rope_theta=1_000_000.0,
    activation="swiglu",
    modality="image_patches",
    frontend_tokens=256,          # ViT patches per image (stubbed)
    frontend_dim=1024,
    source="arXiv:2404.16821 (InternVL2)",
)
