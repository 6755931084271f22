"""Shared neural building blocks (``repro/models/layers.py``), as plain
PyTorch functions and the small modules that hold their weights.

Weights are stored ``(d_in, d_out)`` and applied as ``x @ w``, as the
reference stores them, so carrying them across is a copy.  The init
functions take an explicit ``torch.Generator`` and draw from the
reference's laws: a normal truncated to [-2, 2], scaled by
``1/sqrt(d_in)`` for a projection.  They do not reproduce the
reference's bits (those come from its threefry keys); the tests carry
the reference's weights across with :mod:`repro_torch.convert`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import sharded

__all__ = ["rmsnorm", "softcap", "dense_init", "embed_init", "mlp_forward",
           "MLP", "param"]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, scaled by ``1 + scale``, cast back to x's dtype.
    A DTensor holding partial sums (a row-sharded product's output) is
    summed first (an all-reduce): the norm is not linear, and a partial
    result would leave every product after it unsharded.  For the same
    reason the output's gradient, which the column-sharded products
    after the norm return as partial sums, is summed too."""
    x = sharded.summed(x)
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return sharded.pin_grad((out * (1.0 + scale.float())).to(x.dtype))


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2 logit soft-capping: cap·tanh(x/cap); identity at cap 0."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def param(t: torch.Tensor) -> nn.Parameter:
    """A weight, frozen until a trainer asks for its gradient
    (``train.train_step.init_train_state`` turns gradients on for the
    whole model).  Serving runs under ``torch.inference_mode`` either
    way, so it never builds an autograd graph."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> nn.Parameter:
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return param((w * (1.0 / math.sqrt(d_in))).to(dtype))


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> nn.Parameter:
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return param(w.to(dtype))


def _act(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation in ("swiglu", "silu"):
        return F.silu(x)
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """The gated (swiglu / geglu) or plain (gelu) MLP: ``w_up``,
    ``w_down`` and, when gated, ``w_gate``."""

    def __init__(self, gen, d: int, d_ff: int, activation: str, dtype,
                 device):
        super().__init__()
        self.w_up = dense_init(gen, d, d_ff, dtype, device)
        self.w_down = dense_init(gen, d_ff, d, dtype, device)
        if activation in ("swiglu", "geglu"):
            self.w_gate = dense_init(gen, d, d_ff, dtype, device)


def mlp_forward(p, x: torch.Tensor, activation: str) -> torch.Tensor:
    up = x @ p.w_up
    if hasattr(p, "w_gate"):
        up = _act(x @ p.w_gate, activation) * up
    else:
        up = _act(up, activation)
    return up @ p.w_down
