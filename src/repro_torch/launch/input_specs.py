"""Shape-only stand-ins for every model input (``repro/launch/
input_specs.py``): the dry-run's batch, with no memory behind it.

``input_specs(cfg, shape_name)`` returns the batch of one step of that
shape's kind (train / prefill / decode) as tensors on the ``meta``
device, or on a fake device under ``FakeTensorMode``: the counterpart
of the reference's ``ShapeDtypeStruct``.  Shapes and branches are the
reference's.  So are the dtypes: the port's models take int32 tokens,
positions and labels and f32 frames and patches, as the reference's do.
"""
from __future__ import annotations

import torch

from repro_torch.configs import INPUT_SHAPES
from repro_torch.models.config import ModelConfig

__all__ = ["input_specs", "abstract_batch"]

I32 = torch.int32
F32 = torch.float32


def abstract_batch(cfg: ModelConfig, *, batch: int, seq: int, kind: str,
                   device="meta") -> dict:
    """The inputs of one step of ``kind`` as empty tensors on ``device``
    (``meta`` unless given; a fake device under ``FakeTensorMode``)."""
    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)
    if kind == "decode":
        return {"tokens": sds((batch, 1), I32), "pos": sds((batch,), I32)}
    if cfg.modality == "audio_frames":
        out = {"frames": sds((batch, seq, cfg.frontend_dim), F32)}
        if kind == "train":
            out["labels"] = sds((batch, seq), I32)
        return out
    if cfg.modality == "image_patches":
        text = seq - cfg.frontend_tokens
        return {"tokens": sds((batch, text), I32),
                "patches": sds((batch, cfg.frontend_tokens,
                                cfg.frontend_dim), F32)}
    return {"tokens": sds((batch, seq), I32)}


def input_specs(cfg: ModelConfig, shape_name: str, device="meta") -> dict:
    spec = INPUT_SHAPES[shape_name]
    return abstract_batch(cfg, batch=spec["global_batch"],
                          seq=spec["seq_len"], kind=spec["kind"],
                          device=device)
