"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule (``repro/train/optimizer.py``), as plain functions on dicts of
tensors keyed by parameter name.

The reference's order of operations is kept: the clip scale from the
global norm, then the two moments, then the bias corrections
``1 - b**step`` in f32, then ``delta = mh/(sqrt(vh)+eps) + wd*p``.  Each
step is its own PyTorch op, so nothing is contracted into a fused
multiply-add, as the reference run eagerly contracts nothing.  ``b**step``
is XLA CPU's f32 ``pow``: the C library's ``powf`` with a result below
the smallest normal flushed to zero.  It is taken on the host, where a
0-d PyTorch ``pow`` calls that ``powf``.

Unlike the reference, :func:`adamw_update` writes the new params, m and v
into the tensors it is given: the state of a training run stays at 16 B
a parameter (f32 params, grads, m and v) instead of growing by the three
new copies a functional update would hold at its peak.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule"]

_MIN_NORMAL = torch.finfo(torch.float32).tiny


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32, steps taken
    m: dict                  # name -> f32 tensor, the first moment
    v: dict                  # name -> f32 tensor, the second moment


def adamw_init(params: dict) -> AdamWState:
    """Zero moments in f32 beside each of ``params`` (name -> tensor)."""
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v={k: z.clone() for k, z in zeros.items()})


def _global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's sum of squares, in
    f32, the leaves taken in the order of ``grads``."""
    total = None
    for g in grads.values():
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _bias_correction(b: float, step: int) -> torch.Tensor:
    """``1 - b**step`` in f32 as XLA CPU rounds it (module docstring)."""
    powed = torch.pow(torch.tensor(b, dtype=torch.float32),
                      torch.tensor(float(step), dtype=torch.float32))
    if abs(float(powed)) < _MIN_NORMAL:
        powed = torch.zeros((), dtype=torch.float32)
    return 1 - powed


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One AdamW step with global-norm clipping.  ``lr``: a number or a
    callable of the new step (a () int32 tensor).

    ``params``, ``grads``, ``state.m`` and ``state.v`` share their keys.
    Params, m and v are updated in place; returns (params, the new
    state, the global norm of the grads before clipping)."""
    step = state.step + 1
    if callable(lr):
        lr = lr(step)
    if isinstance(lr, torch.Tensor):
        lr = lr.to(torch.float32)
    n_step = int(step)
    gnorm = _global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    bc1, bc2 = (_bias_correction(b, n_step).to(gnorm.device)
                for b in (b1, b2))
    for k, p in params.items():
        m, v = state.m[k], state.v[k]
        g = grads[k].float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        mh = m / bc1
        vh = v / bc2
        pf = p.float()
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm


def cosine_schedule(peak_lr: float, warmup: int, total: int):
    """lr(step): linear warm-up to ``peak_lr`` over ``warmup`` steps,
    then a half cosine down to 0 at ``total``; f32 throughout."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = 0.5 * peak_lr * (1 + torch.cos(
            torch.tensor(math.pi, dtype=torch.float32) * frac))
        return torch.where(step < warmup, warm, cos)
    return lr
