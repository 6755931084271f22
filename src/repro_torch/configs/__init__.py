"""Assigned-architecture registry (+ the paper's own LDA config)."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as kimi_k2_1t_a32b
from repro_torch.configs.gemma2_27b import CONFIG as gemma2_27b
from repro_torch.configs.hubert_xlarge import CONFIG as hubert_xlarge
from repro_torch.configs.zamba2_2_7b import CONFIG as zamba2_2_7b
from repro_torch.configs.internvl2_1b import CONFIG as internvl2_1b
from repro_torch.configs.mamba2_1_3b import CONFIG as mamba2_1_3b
from repro_torch.configs.phi4_mini_3_8b import CONFIG as phi4_mini_3_8b
from repro_torch.configs.deepseek_moe_16b import CONFIG as deepseek_moe_16b
from repro_torch.configs.granite_3_2b import CONFIG as granite_3_2b
from repro_torch.configs.qwen3_8b import CONFIG as qwen3_8b

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        kimi_k2_1t_a32b, gemma2_27b, hubert_xlarge, zamba2_2_7b,
        internvl2_1b, mamba2_1_3b, phi4_mini_3_8b, deepseek_moe_16b,
        granite_3_2b, qwen3_8b,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return ARCHS[name[:-6]].smoke()
    return ARCHS[name]


# ---------------------------------------------------------------------------
# Input shapes (assigned).
# ---------------------------------------------------------------------------
INPUT_SHAPES = {
    "train_4k":    dict(seq_len=4_096,   global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768,  global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32_768,  global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524_288, global_batch=1,   kind="decode"),
}


def shape_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """DESIGN.md §5 policy.  Returns (runnable, note)."""
    spec = INPUT_SHAPES[shape_name]
    if spec["kind"] == "decode" and cfg.is_encoder_only:
        return False, "encoder-only: no decode step (DESIGN §5)"
    if shape_name == "long_500k":
        eff = cfg if cfg.sub_quadratic else cfg.with_long_context()
        if not eff.sub_quadratic:
            return False, "full attention at 500k (no sub-quadratic variant)"
        note = "" if cfg.sub_quadratic else \
            "runs the sliding-window variant (DESIGN §5)"
        return True, note
    return True, ""
