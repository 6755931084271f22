"""Serving steps (``repro/serve/serve_step.py``): prefill (fill the
cache) and decode (one token)."""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.models import sharded, transformer
from repro_torch.models.config import ModelConfig

__all__ = ["prefill", "decode_step", "make_decode_step", "init_cache"]

init_cache = transformer.init_cache


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch, cache):
    """Run the whole prompt through the model, filling the cache."""
    logits, cache, _ = transformer.forward(params, cfg, batch, cache=cache)
    return logits, cache


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, tokens, pos, cache, *,
                temperature: float = 0.0, key=None):
    """One decode step.  tokens: (B,1) current token; pos: (B,) its index.

    Greedy (``argmax``) unless ``temperature > 0`` and a ``key`` is given:
    then :func:`repro_torch.rng.categorical`, bit for bit
    ``jax.random.categorical`` under the same key.  Returns (next_tokens
    (B,1) int32, logits (B,1,V), cache)."""
    batch = {"tokens": tokens, "pos": pos}
    logits, cache, _ = transformer.forward(params, cfg, batch, cache=cache)
    # the pick reads the whole vocabulary: a DTensor row is gathered
    # first (DTensor's sharded argmax refuses an unsharded batch)
    last = sharded.unshard(logits[:, -1], -1)
    if temperature > 0.0 and key is not None:
        nxt = rng.categorical(key, last / temperature)
    else:
        nxt = torch.argmax(last, dim=-1)
    return nxt[:, None].to(torch.int32), logits, cache


def make_decode_step(cfg: ModelConfig):
    def step(params, tokens, pos, cache):
        return decode_step(params, cfg, tokens, pos, cache)
    return step
