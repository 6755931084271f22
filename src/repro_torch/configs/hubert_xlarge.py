"""HuBERT X-Large [arXiv:2106.07447].

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (cluster targets);
encoder-only (bidirectional), same backbone as wav2vec 2.0.  The
mel/conv feature extractor is a stub per spec — the model consumes
precomputed 512-d frame embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,                 # encoder-only
    activation="gelu",
    modality="audio_frames",
    frontend_dim=512,             # conv feature extractor output (stubbed)
    source="arXiv:2106.07447 (HuBERT)",
)
