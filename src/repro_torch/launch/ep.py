"""Expert-parallel execution context for MoE layers (``repro/launch/ep.py``).

``make_ep_ctx`` returns a callable ``ep_ctx(moe, x) -> (y, aux)`` that
``transformer.forward(ep_ctx=...)`` runs in place of each MoE layer's
own forward.  The tokens of x (B, S, d) are chunked over M ranks along
the sequence, as the reference's ``shard_map`` chunks them over its
'model' axis, and each rank's experts run on what the others send them
(``models/moe.py``):

* with ``group``, a ``torch.distributed`` group of M processes: this
  process is one rank, takes its chunk of x (every rank holds all of x
  and all the weights, the rest of the model run alike on every rank),
  and the chunks' outputs are gathered back along the sequence, as the
  reference's global output is.  In the backward the gather hands each
  rank its own chunk's gradient and the chunking gathers the chunks'
  gradients back, so the gradient of x is whole on every rank; a MoE
  weight's gradient holds this rank's tokens and experts only, and its
  sum over the group (``all_reduce``) is the whole gradient;
* without, the M ranks run in lock step on x's device.  NCCL puts no
  two ranks on one GPU, so this is the form one card runs.

Both forms give the same bits.  Where S is not a multiple of M (decode
shapes) the layer falls back to ``moe_forward``, as the reference does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models import moe as moe_mod

__all__ = ["make_ep_ctx"]


class _Chunk(torch.autograd.Function):
    """Forward: this rank's chunk of x along dim 1.  Backward: the
    chunks' gradients gathered from every rank, so x's gradient is whole
    on each."""

    @staticmethod
    def forward(ctx, x, group, M, r):
        ctx.group, ctx.M = group, M
        n = x.shape[1] // M
        return x[:, r * n:(r + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        parts = [torch.empty_like(g) for _ in range(ctx.M)]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts, dim=1), None, None, None


def make_ep_ctx(M: int, cfg, *, group=None, capacity_factor: float = 1.25):
    """ep_ctx(moe_params, x) -> (y, aux), or None where EP is not viable
    (M = 1, no experts, or E not a multiple of M)."""
    if M == 1 or not cfg.num_experts or cfg.num_experts % M != 0:
        return None
    if group is not None:
        if dist.get_world_size(group) != M:
            raise ValueError(f"the group has {dist.get_world_size(group)} "
                             f"ranks, not M = {M}")

    def ep_ctx(p, x):
        B, S, d = x.shape
        if S % M != 0:
            # decode shapes: the single-program path
            return moe_mod.moe_forward(p, cfg, x,
                                       capacity_factor=capacity_factor)
        if group is None:
            chunks = x.reshape(B, M, S // M, d).transpose(0, 1)
            y, aux = moe_mod.moe_forward_ep_lockstep(
                p, cfg, chunks, capacity_factor=capacity_factor)
            return y.transpose(0, 1).reshape(B, S, d), aux
        r = dist.get_rank(group)
        y, aux = moe_mod.moe_forward_ep(
            p, cfg, _Chunk.apply(x, group, M, r), group=group,
            capacity_factor=capacity_factor)
        return moe_mod.gather_replicated(y, group, dim=1), aux

    return ep_ctx
