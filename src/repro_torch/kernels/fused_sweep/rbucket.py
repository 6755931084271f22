"""Doc-sparse r-bucket: compacted ``(topics, counts)`` vectors, the port of
``repro/kernels/fused_sweep/rbucket.py``.

The r-term of the F+LDA draw, ``r_t = n_td·q_t``, is drawn from a
capacity-``cap`` compacted vector: the document's active topics ascending,
padded with ``(0, 0)`` slots.  ``r_mode="dense"`` recomputes it from the
``n_td`` row per token (:func:`compact_row`), ``"sparse"`` keeps it as a
per-doc side table updated with integer shifts (:func:`decrement`,
:func:`increment`); both draw from the same vector, so their chains are
bit-equal.  ``cap`` itself changes the chain (the cumsum runs over
``cap`` entries), so compared runs share it.

Every function is batched over leading dims (one row per document or per
worker stream) where the reference is ``vmap``-ed.  Out-of-range slot
reads clamp, as a ``jnp`` gather does, so a full table behaves as the
reference's does.
"""
from __future__ import annotations

import torch

from repro_torch.numerics import blocked_cumsum

__all__ = ["compact_row", "build_side_table", "decrement", "increment",
           "r_cumsum", "pick"]


def compact_row(row: torch.Tensor, cap: int):
    """Compact count rows ``(..., T)`` into capacity-``cap`` int32
    ``(topics, counts)``: active topics ascending, padded with ``(0, 0)``;
    active topics past ``cap`` are dropped."""
    T = row.shape[-1]
    row = row.to(torch.int32)
    active = row > 0
    rank = torch.cumsum(active.to(torch.int64), -1) - 1
    pos = torch.where(active, rank, cap).clamp(max=cap)
    shape = (*row.shape[:-1], cap + 1)
    ar = torch.arange(T, dtype=torch.int32, device=row.device).expand_as(row)
    topics = torch.zeros(shape, dtype=torch.int32, device=row.device)
    counts = torch.zeros(shape, dtype=torch.int32, device=row.device)
    topics.scatter_(-1, pos, torch.where(active, ar, 0))
    counts.scatter_(-1, pos, torch.where(active, row, 0))
    return (topics[..., :cap].contiguous(),
            counts[..., :cap].contiguous())


def build_side_table(n_td: torch.Tensor, cap: int):
    """Side tables of a whole ``(I, T)`` doc-topic table: ``(I, cap)``
    int32 ``(topics, counts)``."""
    return compact_row(n_td, cap)


def _slot(topics, counts, t):
    """``Σ (topics < t) & (counts > 0)``: where topic ``t`` sits or would
    be inserted, per row."""
    return ((topics < t.unsqueeze(-1)) & (counts > 0)).sum(-1)


def _shift(x, step: int):
    """``x`` moved one slot left (``step=1``) or right (``step=-1``),
    zero-filled."""
    z = torch.zeros_like(x[..., :1])
    return (torch.cat([x[..., 1:], z], -1) if step == 1
            else torch.cat([z, x[..., :-1]], -1))


def decrement(topics, counts, t, valid):
    """Remove one occurrence of topic ``t`` per row where ``valid``; a
    count reaching zero shifts the tail left."""
    cap = topics.shape[-1]
    j = torch.arange(cap, device=topics.device)
    pos = _slot(topics, counts, t).unsqueeze(-1)
    newc = counts.gather(-1, pos.clamp(max=cap - 1)) - 1
    remove = newc == 0
    topics2 = torch.where(remove & (j >= pos), _shift(topics, 1), topics)
    counts2 = torch.where(remove,
                          torch.where(j >= pos, _shift(counts, 1), counts),
                          torch.where(j == pos, newc, counts))
    v = valid.unsqueeze(-1)
    return torch.where(v, topics2, topics), torch.where(v, counts2, counts)


def increment(topics, counts, t, valid):
    """Add one occurrence of topic ``t`` per row where ``valid``: bump its
    count, or shift the tail right and insert ``(t, 1)``."""
    cap = topics.shape[-1]
    j = torch.arange(cap, device=topics.device)
    pos = _slot(topics, counts, t).unsqueeze(-1)
    at = pos.clamp(max=cap - 1)
    present = ((counts.gather(-1, at) > 0)
               & (topics.gather(-1, at) == t.unsqueeze(-1)))
    tt = t.to(torch.int32).unsqueeze(-1)
    ins_t = torch.where(j > pos, _shift(topics, -1),
                        torch.where(j == pos, tt, topics))
    ins_c = torch.where(j > pos, _shift(counts, -1),
                        torch.where(j == pos, 1, counts))
    topics2 = torch.where(present, topics, ins_t)
    counts2 = torch.where(present,
                          torch.where(j == pos, counts + 1, counts), ins_c)
    v = valid.unsqueeze(-1)
    return torch.where(v, topics2, topics), torch.where(v, counts2, counts)


def r_cumsum(topics, counts, q):
    """Cumulative r masses ``cumsum(counts·q[topics])``: each product
    rounded to f32, then the blocked-16 scan of ``numerics``.  ``q`` has
    the rows' leading shape plus ``(T,)``, or is one ``(T,)`` vector."""
    qt = (q[topics.long()] if q.ndim == 1
          else q.gather(-1, topics.long()))
    return blocked_cumsum(counts.to(torch.float32) * qt)


def pick(topics, counts, c, u_val):
    """Guarded LSearch on the compacted cumsum: slot ``#{c ≤ u_val}``,
    capped at the last active slot, so a boundary ``u_val`` never lands on
    a zero-count pad; returns the slot's topic, int64."""
    m = (counts > 0).sum(-1)
    j = torch.minimum((c <= u_val.unsqueeze(-1)).sum(-1),
                      (m - 1).clamp(min=0))
    return topics.gather(-1, j.unsqueeze(-1)).squeeze(-1).to(torch.int64)
