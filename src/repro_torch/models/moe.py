"""Mixture-of-Experts block (``repro/models/moe.py``): capacity-based
top-k routing with bucket dispatch.

    router → top-k (weights, expert ids) per token
    dispatch: tokens into per-expert capacity buckets (overflow drops)
    expert FFN: one batched matmul over the expert axis
    combine: gather back, weight, sum over the k choices

A choice ranked at or past its expert's capacity goes to the extra bucket
E and its output is zeroed, as the reference does: a gather that kept
every token would answer differently whenever an expert overflows.  The
expert-parallel path (``moe_forward_ep``) is not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import MLP, dense_init, param

__all__ = ["MoE", "moe_forward", "dispatch_indices", "route", "capacity"]


class MoE(nn.Module):
    """``router``, the stacked experts ``w_gate``/``w_up`` (E, d, f) and
    ``w_down`` (E, f, d), and the shared experts as one ``shared`` MLP."""

    def __init__(self, gen, cfg, dtype, device):
        super().__init__()
        d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
        self.router = dense_init(gen, d, E, dtype, device)

        def normal(shape, scale):
            w = torch.empty(shape, dtype=torch.float32, device=device)
            nn.init.normal_(w, generator=gen)
            return param((w * scale).to(dtype))

        self.w_gate = normal((E, d, f), 1.0 / math.sqrt(d))
        self.w_up = normal((E, d, f), 1.0 / math.sqrt(d))
        self.w_down = normal((E, f, d), 1.0 / math.sqrt(f))
        if cfg.num_shared_experts:
            self.shared = MLP(gen, d, f * cfg.num_shared_experts, "swiglu",
                              dtype, device)
        self.cfg = cfg

    def forward(self, x: torch.Tensor):
        """x: (B,S,d) → (y, aux_loss) through :func:`moe_forward`."""
        return moe_forward(self, self.cfg, x)


def dispatch_indices(experts: torch.Tensor, E: int, cap: int):
    """experts: (n, k) top-k ids.  Returns (dest, rank, keep), each (n·k,):
    dest the expert id (E for a dropped choice), rank the slot within the
    expert (arrival order, from a stable sort, clipped to cap - 1), keep
    whether the choice fits its expert's capacity."""
    flat = experts.reshape(-1)
    nk = flat.shape[0]
    order = torch.sort(flat, stable=True).indices
    sorted_e = flat[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank_sorted = torch.arange(nk, device=flat.device) - first
    rank = torch.zeros(nk, dtype=torch.int32, device=flat.device)
    rank[order] = rank_sorted.to(torch.int32)
    keep = rank < cap
    dest = torch.where(keep, flat, E).to(torch.int32)
    return dest, torch.clamp(rank, max=cap - 1), keep


def route(p, cfg, x_flat: torch.Tensor):
    """Softmax in f32, top-k (ties to the lower expert id, as
    ``lax.top_k``), weights renormalised by max(sum, 1e-9), and the
    load-balance term.  Returns (weights, experts, aux)."""
    logits = x_flat @ p.router
    probs = torch.softmax(logits.float(), dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    weights, experts = srt.values[:, :k], srt.indices[:, :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    E = cfg.num_experts
    frac = torch.zeros(E, dtype=torch.float32, device=x_flat.device)
    frac = frac.index_add(0, experts.reshape(-1),
                          torch.ones(experts.numel(), device=x_flat.device))
    aux = E * torch.sum(frac / experts.numel() * probs.mean(0))
    return weights, experts.to(torch.int32), aux


def _expert_ffn(bucket, p):
    """bucket: (E, C, d) → (E, C, d) through each expert's gated FFN."""
    h = torch.bmm(bucket, p.w_gate)
    u = torch.bmm(bucket, p.w_up)
    return torch.bmm(F.silu(h) * u, p.w_down)


def _shared_ffn(x, p):
    h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down


def _dispatch_combine(p, cfg, x_flat, cap):
    """Route x_flat (n, d) through capacity buckets.  Returns (y, aux)."""
    n, d = x_flat.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    weights, experts, aux = route(p, cfg, x_flat)
    dest, rank, keep = dispatch_indices(experts, E, cap)
    dl, rl = dest.long(), rank.long()
    tok_idx = torch.arange(n, device=x_flat.device).repeat_interleave(k)
    bucket = torch.zeros((E + 1, cap, d), dtype=x_flat.dtype,
                         device=x_flat.device)
    # kept choices own distinct slots; dropped ones all land in bucket E
    bucket[dl, rl] = x_flat[tok_idx]
    y_bucket = _expert_ffn(bucket[:E], p)
    y_choice = y_bucket[torch.clamp(dl, max=E - 1), rl]
    y_choice = torch.where(keep[:, None], y_choice, 0.0)
    y_choice = (y_choice * weights.reshape(-1)[:, None].to(y_choice.dtype)
                ).reshape(n, k, d)
    # the reference's scatter-add takes a token's choices in order
    y = torch.zeros_like(x_flat)
    for j in range(k):
        y = y + y_choice[:, j]
    return y, aux


def moe_forward(p, cfg, x: torch.Tensor, *, capacity_factor: float = 1.25):
    """x: (B,S,d) → (y, aux_loss)."""
    B, S, d = x.shape
    n = B * S
    x_flat = x.reshape(n, d)
    cap = capacity(n, cfg, capacity_factor)
    y, aux = _dispatch_combine(p, cfg, x_flat, cap)
    if cfg.num_shared_experts:
        y = y + _shared_ffn(x_flat, p.shared)
    return y.reshape(B, S, d), aux


def capacity(n: int, cfg, factor: float = 1.25) -> int:
    """Slots an expert has for n tokens: at least 8, at most n."""
    cap = int(n * cfg.experts_per_token / max(cfg.num_experts, 1) * factor)
    return max(8, min(cap, n))
