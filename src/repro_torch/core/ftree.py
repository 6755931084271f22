"""F+tree: the paper's O(log T) multinomial sampling structure (paper §3.1),
the port of ``repro/core/ftree.py``.

A complete binary tree over ``T`` unnormalized parameters ``p``, heap-style
in a flat f32 array ``F`` of length ``2T``: ``F[0]`` unused (0), ``F[1]``
the root ``Σ p``, node ``i`` with children ``2i`` and ``2i+1``, leaf ``t``
at ``F[T + t]``.  ``T`` is a power of two (:func:`pad_pow2` zero-pads).

Every function takes a batch of trees along the leading dims of ``F``
(``(..., 2T)``), where the reference takes one tree and is ``vmap``-ed;
:func:`sample_batch` draws many times from one tree, as the reference's
does.  Each float op is the reference's, in its order under ``jit``:
``build`` sums sibling pairs level by level except at the root, which XLA
CPU folds into one reduction over all leaves (:func:`_root_sum`);
``update`` adds the same delta to the leaf and each ancestor; ``sample``
walks down with the zero-mass-right-subtree guard.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F_

__all__ = ["build", "depth", "leaves", "pad_pow2", "sample", "sample_batch",
           "set_leaf", "total", "update", "update_batch"]


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def depth(T: int) -> int:
    """Tree depth = number of traversal steps = log2(T)."""
    if not _is_pow2(T):
        raise ValueError(f"F+tree size must be a power of two, got {T}")
    return T.bit_length() - 1


def pad_pow2(p: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last axis of ``p`` up to the next power of two."""
    T = p.shape[-1]
    Tp = 1 << max(0, (T - 1).bit_length())
    return p if Tp == T else F_.pad(p, (0, Tp - T))


#: Leaves summed in one sequential run before the run totals are added.
ROOT_RUN = 32
#: Largest ``T`` whose root rounding is pinned against the reference.
MAX_TOPICS = 1024


def _root_sum(p: torch.Tensor) -> torch.Tensor:
    """``Σ p`` along the last dim as XLA CPU reduces a row of at most 1024
    f32 values: each run of 32 summed in order, then the run totals in
    order.  The reference's ``build`` computes its root this way under
    ``jit``, not as the sum of the two level-1 nodes."""
    runs = p.reshape(*p.shape[:-1], -1, min(ROOT_RUN, p.shape[-1]))
    acc = runs[..., 0]
    for j in range(1, runs.shape[-1]):
        acc = acc + runs[..., j]
    total = acc[..., 0]
    for j in range(1, acc.shape[-1]):
        total = total + acc[..., j]
    return total


def build(p: torch.Tensor) -> torch.Tensor:
    """The tree over parameters ``p`` (``(..., T)``): ``(..., 2T)``, with
    ``T`` a power of two of at most :data:`MAX_TOPICS`."""
    T = p.shape[-1]
    if not _is_pow2(T):
        raise ValueError(f"F+tree size must be a power of two, got {T} "
                         "(use pad_pow2)")
    if T > MAX_TOPICS:
        raise ValueError(f"F+tree build is pinned to the reference's "
                         f"rounding for T <= {MAX_TOPICS}; got {T}")
    levels = [p]
    cur = p
    while cur.shape[-1] > 2:
        cur = cur[..., 0::2] + cur[..., 1::2]
        levels.append(cur)
    if T > 1:
        levels.append(_root_sum(p).unsqueeze(-1))
    zero = torch.zeros_like(p[..., :1])
    return torch.cat([zero] + levels[::-1], dim=-1)


def total(F: torch.Tensor) -> torch.Tensor:
    """Normalizer Σ_t p_t, stored at the root."""
    return F[..., 1]


def leaves(F: torch.Tensor) -> torch.Tensor:
    """The parameter vector ``p`` (leaf values)."""
    return F[..., F.shape[-1] // 2:]


def _walk(F: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Descend from the root with ``u`` (same leading shape as the draws;
    ``F`` broadcast against it): right when ``u >= left`` and the right
    subtree holds mass, then ``u -= left``."""
    T = F.shape[-1] // 2
    i = torch.ones(u.shape, dtype=torch.int64, device=u.device)
    Fb = F.expand(*u.shape, 2 * T) if F.ndim == 1 else F
    for _ in range(depth(T)):
        left = Fb.gather(-1, (2 * i).unsqueeze(-1)).squeeze(-1)
        right = Fb.gather(-1, (2 * i + 1).unsqueeze(-1)).squeeze(-1)
        go = (u >= left) & (right > 0)
        i = 2 * i + go.to(i.dtype)
        u = torch.where(go, u - left, u)
    return i - T


def sample(F: torch.Tensor, u01: torch.Tensor) -> torch.Tensor:
    """One draw per tree: ``min{t : Σ_{s≤t} p_s > u01·F[1]}`` (Alg. 1),
    ``F`` ``(..., 2T)`` and ``u01`` ``(...)``; int64.  Never enters a
    zero-mass right subtree, so ``u01·F[1]`` rounding up to ``F[1]`` still
    lands on the last positive leaf."""
    return _walk(F, u01 * F[..., 1])


def sample_batch(F: torch.Tensor, u01: torch.Tensor) -> torch.Tensor:
    """Any-shape draws ``u01`` from ONE tree ``F`` (``(2T,)``)."""
    if F.ndim != 1:
        raise ValueError(f"sample_batch draws from one (2T,) tree; got "
                         f"{tuple(F.shape)}")
    return _walk(F, u01 * F[1])


def _path(T: int, t: torch.Tensor) -> torch.Tensor:
    """Heap indices of leaf ``t`` and its ancestors: ``t.shape + (d+1,)``."""
    shifts = torch.arange(depth(T) + 1, device=t.device)
    return (t.to(torch.int64) + T).unsqueeze(-1) >> shifts


def update(F: torch.Tensor, t: torch.Tensor, delta: torch.Tensor
           ) -> torch.Tensor:
    """``p_t += delta`` on each tree: the delta is added to leaf ``t`` and
    every ancestor (Alg. 2).  ``t``/``delta`` have ``F``'s leading shape."""
    idx = _path(F.shape[-1] // 2, torch.as_tensor(t, device=F.device))
    d = torch.as_tensor(delta, dtype=F.dtype, device=F.device)
    add = d.unsqueeze(-1).expand(idx.shape)
    return F.scatter_add(-1, idx.expand(*F.shape[:-1], idx.shape[-1]),
                         add.expand(*F.shape[:-1], idx.shape[-1]))


def update_batch(F: torch.Tensor, ts: torch.Tensor, deltas: torch.Tensor
                 ) -> torch.Tensor:
    """``p_{ts[k]} += deltas[k]`` on one tree ``(2T,)``; duplicate paths
    accumulate, in the order of ``ts`` (leaf first along each path)."""
    idx = _path(F.shape[-1] // 2, ts)
    vals = deltas.to(F.dtype).unsqueeze(-1).expand(idx.shape)
    return F.clone().index_add_(0, idx.reshape(-1), vals.reshape(-1))


def set_leaf(F: torch.Tensor, t: torch.Tensor, value: torch.Tensor
             ) -> torch.Tensor:
    """``p_t = value`` in the Alg. 3 form ``update(t, value - F[T+t])``:
    the difference is added down the path, nothing is re-summed, so the
    leaf can end up one rounding away from ``value``."""
    T = F.shape[-1] // 2
    t = torch.as_tensor(t, device=F.device).to(torch.int64)
    cur = F.gather(-1, (t + T).unsqueeze(-1)).squeeze(-1)
    return update(F, t, value - cur)
