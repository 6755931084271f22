"""Mixture-of-Experts block (``repro/models/moe.py``): capacity-based
top-k routing with bucket dispatch.

    router → top-k (weights, expert ids) per token
    dispatch: tokens into per-expert capacity buckets (overflow drops)
    expert FFN: one batched matmul over the expert axis
    combine: gather back, weight, sum over the k choices

A choice ranked at or past its expert's capacity goes to the extra bucket
E and its output is zeroed, as the reference does: a gather that kept
every token would answer differently whenever an expert overflows.

Expert parallelism (``moe_forward_ep``, the reference's ``shard_map``
body) has two forms that compute the same thing: over a
``torch.distributed`` group, one rank a process, and in lock step, the
ranks stacked in one process (:func:`moe_forward_ep_lockstep`), which is
the form one card runs.  ``launch/ep.py`` installs either in
``transformer.forward``.
"""
from __future__ import annotations

import math
import warnings
from types import SimpleNamespace

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.models import sharded
from repro_torch.models.layers import MLP, dense_init, param

__all__ = ["MoE", "moe_forward", "moe_forward_ep", "moe_forward_ep_lockstep",
           "dispatch_indices", "route", "capacity"]


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


def _expert_ffn(bucket, w_gate, w_up, w_down):
    """bucket: (E, C, d) → (E, C, d) through each expert's gated FFN."""
    h = torch.bmm(bucket, w_gate)
    u = torch.bmm(bucket, w_up)
    return torch.bmm(F.silu(h) * u, w_down)


def _shared_ffn(x, p):
    h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    return h @ p.w_down


def _dispatch(p, cfg, x_flat, cap):
    """Route x_flat (n, d) into capacity buckets.  Returns the buckets
    (E, cap, d), the routing that :func:`_combine` reads back, and aux."""
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
    return bucket[:E], (weights, dl, rl, keep), aux


def _combine(y_bucket, routing, x_flat):
    """Each token's kept choices gathered from y_bucket (E, cap, d),
    weighted and summed in choice order, as the reference's scatter-add
    takes them."""
    weights, dl, rl, keep = routing
    n, d = x_flat.shape
    E, k = y_bucket.shape[0], weights.shape[1]
    y_choice = y_bucket[torch.clamp(dl, max=E - 1), rl]
    y_choice = torch.where(keep[:, None], y_choice, 0.0)
    y_choice = (y_choice * weights.reshape(-1)[:, None].to(y_choice.dtype)
                ).reshape(n, k, d)
    y = torch.zeros_like(x_flat)
    for j in range(k):
        y = y + y_choice[:, j]
    return y


def moe_forward(p, cfg, x: torch.Tensor, *, capacity_factor: float = 1.25):
    """x: (B,S,d) → (y, aux_loss).  On DTensors the routed experts run
    shard by shard (``sharded.routed_experts``)."""
    B, S, d = x.shape
    n = B * S
    cap = capacity(n, cfg, capacity_factor)
    if sharded.is_sharded(x):
        y, aux = sharded.routed_experts(
            lambda *a: _routed_local(cfg, cap, *a), x, p)
    else:
        x_flat = x.reshape(n, d)
        bucket, routing, aux = _dispatch(p, cfg, x_flat, cap)
        y = _combine(_expert_ffn(bucket, p.w_gate, p.w_up, p.w_down),
                     routing, x_flat).reshape(B, S, d)
    if cfg.num_shared_experts:
        y = y + _shared_ffn(x.reshape(n, d), p.shared).reshape(B, S, d)
    return y, aux


def _routed_local(cfg, cap, x_l, router, w_gate, w_up, w_down, r):
    """The routed experts on one rank's tokens x_l (b, s, d): routed over
    all E experts into buckets of ``cap`` slots (the whole batch's), only
    the rank's own E_l experts [r·E_l, (r+1)·E_l) (the weights given)
    run, and the rest return zero.  Returns (y_l, aux)."""
    b, s, d = x_l.shape
    x_flat = x_l.reshape(b * s, d)
    bucket, routing, aux = _dispatch(SimpleNamespace(router=router), cfg,
                                     x_flat, cap)
    own = slice(r * w_gate.shape[0], (r + 1) * w_gate.shape[0])
    y_bucket = torch.zeros_like(bucket)
    y_bucket[own] = _expert_ffn(bucket[own], w_gate, w_up, w_down)
    return _combine(y_bucket, routing, x_flat).reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Expert parallelism: M ranks, each owning E/M experts and a chunk of the
# tokens.  A rank buckets its tokens for all E experts, sends each owner
# its E/M experts' buckets, runs its own experts on what it receives and
# sends the results back.  The exchange is the reference's
# ``lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)``: what rank
# r receives from rank j is block r of what rank j sends.
# ---------------------------------------------------------------------------
def _ep_capacity(n: int, cfg, M: int, factor: float) -> int:
    """A rank's slots an expert: :func:`capacity` rounded up to a
    multiple of M, at least 8."""
    cap = capacity(n, cfg, factor)
    return max(8, -(-cap // M) * M)


def _ep_send(p, cfg, x_local, M, capacity_factor):
    """A rank's buckets, (M, E/M, cap, d) by owner, its routing and aux."""
    B, S, d = x_local.shape
    x_flat = x_local.reshape(B * S, d)
    cap = _ep_capacity(B * S, cfg, M, capacity_factor)
    bucket, routing, aux = _dispatch(p, cfg, x_flat, cap)
    return bucket.reshape(M, -1, cap, d), routing, aux


def _ep_experts(p, recv, r):
    """Rank r's experts on what it received, (M, E/M, cap, d) by sender:
    one batched FFN over (E/M, M·cap, d), the result again by sender.
    ``p`` holds all E experts, of which rank r takes its E/M, or only
    rank r's E/M (a shard of an expert-sharded weight)."""
    M, E_loc, cap, d = recv.shape
    w = (p.w_gate, p.w_up, p.w_down)
    if w[0].shape[0] != E_loc:
        own = slice(r * E_loc, (r + 1) * E_loc)
        w = tuple(t[own] for t in w)
    h = recv.transpose(0, 1).reshape(E_loc, M * cap, d)
    y = _expert_ffn(h, *w)
    return y.reshape(E_loc, M, cap, d).transpose(0, 1)


def _ep_finish(p, cfg, back, routing, x_local):
    """A rank's output from the results sent back, (M, E/M, cap, d)."""
    B, S, d = x_local.shape
    x_flat = x_local.reshape(B * S, d)
    y = _combine(back.reshape(-1, *back.shape[2:]), routing, x_flat)
    if cfg.num_shared_experts:
        y = y + _shared_ffn(x_flat, p.shared)
    return y.reshape(B, S, d)


def _ep_aux(auxes) -> torch.Tensor:
    """The ranks' aux terms averaged, summed in rank order."""
    total = auxes[0]
    for a in auxes[1:]:
        total = total + a
    return total / len(auxes)


def moe_forward_ep(p, cfg, x_local: torch.Tensor, *, group,
                   capacity_factor: float = 1.25):
    """Expert parallelism over a ``torch.distributed`` group of M ranks.

    x_local: this rank's chunk of the tokens, (B, S/M, d).  ``p`` holds
    all E experts on every rank, and the rank runs experts [r·E/M,
    (r+1)·E/M) of them, or holds only those (a shard of expert-sharded
    weights).  Dispatch, ``all_to_all_single`` to the owners, the owners'
    FFN, ``all_to_all_single`` back, combine; gradients flow back through
    both exchanges.  Returns (y_local, aux averaged over the ranks, the
    same on every rank).  A rank's weight gradients hold its own tokens
    and experts; their sum over the group is the whole gradient."""
    M, r = dist.get_world_size(group), dist.get_rank(group)
    send, routing, aux = _ep_send(p, cfg, x_local, M, capacity_factor)
    recv = _all_to_all(send, group)
    back = _all_to_all(_ep_experts(p, recv, r), group)
    y = _ep_finish(p, cfg, back, routing, x_local)
    return y, _ep_aux(list(gather_replicated(aux.reshape(1), group)))


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Block j of t (split on dim 0) to rank j; block j of the result
    from rank j.  Differentiable."""
    from torch.distributed.nn import functional as dist_fn
    t = t.contiguous()
    with warnings.catch_warnings():      # the autograd form is deprecated
        warnings.simplefilter("ignore", FutureWarning)
        return dist_fn.all_to_all_single(torch.empty_like(t), t,
                                         group=group)


class _GatherReplicated(torch.autograd.Function):
    """Forward: every rank's t, concatenated along ``dim`` in rank order.
    Backward: this rank's part of the gradient only.  That is the
    gradient where every rank goes on to compute the same thing from the
    whole, as the ranks of ``launch/ep.py`` do; summing the ranks'
    gradients, as a plain all-gather's backward does, would count it M
    times."""

    @staticmethod
    def forward(ctx, t, group, dim):
        M, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.dim, ctx.r, ctx.n = dim, r, t.shape[dim]
        parts = [torch.empty_like(t) for _ in range(M)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.r * ctx.n, ctx.n), None, None


def gather_replicated(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """:class:`_GatherReplicated`: every rank's t along ``dim``."""
    return _GatherReplicated.apply(t, group, dim)


def moe_forward_ep_lockstep(p, cfg, x_locals: torch.Tensor, *,
                            capacity_factor: float = 1.25):
    """The M ranks of :func:`moe_forward_ep` run in lock step in one
    process: x_locals (M, B, S/M, d), rank r's chunk at r.  The exchange
    is a permutation of the stacked (M, M, E/M, cap, d) buckets, every
    rank's step the same ops on the same shapes as there, so the two
    forms give equal bits.  Returns (y_locals (M, B, S/M, d), aux)."""
    M = x_locals.shape[0]
    sent = [_ep_send(p, cfg, x_locals[r], M, capacity_factor)
            for r in range(M)]
    recv = torch.stack([s[0] for s in sent]).transpose(0, 1)
    y_own = torch.stack([_ep_experts(p, recv[r], r) for r in range(M)])
    back = y_own.transpose(0, 1)
    y = torch.stack([_ep_finish(p, cfg, back[r], sent[r][1], x_locals[r])
                     for r in range(M)])
    return y, _ep_aux([s[2] for s in sent])


def capacity(n: int, cfg, factor: float = 1.25) -> int:
    """Slots an expert has for n tokens: at least 8, at most n."""
    cap = int(n * cfg.experts_per_token / max(cfg.num_experts, 1) * factor)
    return max(8, min(cap, n))
