"""Batched serving engine (``repro/serve/engine.py``): static-batch
prefill, then a decode loop.

The prompts are right-padded to a rectangle and the rectangle is
prefilled; the cache lengths are then set back to the true lengths, the
last prompt token is decoded again at ``pos = len - 1`` to give the
first new token, and each step draws from a key split off the last.
Every step is the reference's, so both engines give the same tokens from
the same weights.  As there, an SSM layer's state has taken the padding
and the last prompt token twice by the time decoding starts: only an
attention cache is masked back to the true lengths.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import rng
from repro_torch._device import resolve
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serve.serve_step import decode_step, init_cache

__all__ = ["generate"]


@torch.inference_mode()
def generate(params, cfg: ModelConfig, prompts: list[list[int]], *,
             max_new_tokens: int = 16, eos_id: int = -1,
             temperature: float = 0.0, key=None, ring: bool = False,
             device=None, dtype=torch.float32,
             step_logits: list | None = None,
             timings: dict | None = None) -> list[list[int]]:
    """Greedy or sampled continuations of variable-length prompts.

    ``key`` is a :mod:`repro_torch.rng` key (``rng.key(0)`` when None).
    ``device``: CUDA unless ``"cpu"``; the weights must live there.
    ``dtype``: the cache's.  ``step_logits``, when given, receives each
    step's last-position logits (B, V), on the device.  ``timings``, when
    given, receives ``prefill_ms`` (the device synchronised after it) and
    ``step_ms``, each decode step's host time until its tokens reached
    the host."""
    dev, wdev = resolve(device), params.embed.device
    if wdev.type != dev.type or dev.index not in (None, wdev.index):
        raise ValueError(f"the weights are on {wdev}, not on {dev}")
    dev = wdev
    B = len(prompts)
    max_len = max(len(p) for p in prompts)
    S_max = max_len + max_new_tokens + 1
    key = rng.key(0, dev) if key is None else key.to(dev)

    tok = np.zeros((B, max_len), np.int32)
    lens = np.zeros((B,), np.int32)
    for i, p in enumerate(prompts):
        tok[i, :len(p)] = p
        lens[i] = len(p)
    tokens = torch.as_tensor(tok, device=dev)
    lens = torch.as_tensor(lens, device=dev)

    t0 = time.perf_counter()
    cache = init_cache(cfg, B, S_max, dtype=dtype, ring=ring, device=dev)
    # padded positions write garbage past each row's length; "len" is then
    # reset to the true length, so decode masks them out
    _, cache, _ = transformer.forward(
        params, cfg, {"tokens": tokens,
                      "pos": torch.zeros((B,), dtype=torch.int32,
                                         device=dev)}, cache=cache)
    cache = _set_lens(cache, lens)
    if timings is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        timings["step_ms"] = []

    last_tok = tokens[torch.arange(B, device=dev), lens.long() - 1][:, None]
    out = [[] for _ in range(B)]
    done = np.zeros(B, bool)
    pos = lens - 1

    for _ in range(max_new_tokens):
        t0 = time.perf_counter()
        key, sub = rng.split(key)
        cache_step = _set_lens(cache, pos)     # attend up to current pos
        nxt, logits, cache = decode_step(params, cfg, last_tok, pos,
                                         cache_step, temperature=temperature,
                                         key=sub)
        if step_logits is not None:
            step_logits.append(logits[:, -1])
        nxt_np = nxt[:, 0].cpu().numpy()
        if timings is not None:
            timings["step_ms"].append((time.perf_counter() - t0) * 1e3)
        for i in range(B):
            if not done[i]:
                if int(nxt_np[i]) == eos_id:
                    done[i] = True
                else:
                    out[i].append(int(nxt_np[i]))
        if done.all():
            break
        last_tok = nxt
        pos = pos + 1
    return out


def _set_lens(cache, lens):
    """A copy of ``cache`` whose every ``len`` entry is ``lens``; the
    other tensors are shared."""
    def fix(node):
        if isinstance(node, dict):
            return {k: (lens.to(v.dtype).expand(v.shape).clone()
                        if k == "len" else fix(v)) for k, v in node.items()}
        if isinstance(node, list):
            return [fix(v) for v in node]
        return node
    return fix(cache)
