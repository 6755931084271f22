"""Multinomial samplers compared in paper Table 1, the port of
``repro/core/samplers.py``.

Four ways to draw ``z`` with ``Pr(z=t) ∝ p_t`` from unnormalized ``p``:

    =============  ==========  ============  ================
    sampler        init        generation    parameter update
    =============  ==========  ============  ================
    LSearch        Θ(T)        Θ(T)          Θ(1)
    BSearch        Θ(T)        Θ(log T)      Θ(T)   (rebuild)
    Alias          Θ(T)        Θ(1)          Θ(T)   (rebuild)
    F+tree         Θ(T)        Θ(log T)      Θ(log T)
    =============  ==========  ============  ================

All samplers share one API: ``init(p) -> state``, ``draw(state, u01) ->
t``, ``update(state, t, delta) -> state``.  States are ``NamedTuple``s
with the reference's fields, on ``p``'s device.  A draw takes ``u01`` of
any shape, where the reference's is ``vmap``-ed, and returns int32 of
that shape.  Each float op is the reference's under ``jit`` on XLA CPU,
in its order: normalizers are :func:`repro_torch.numerics.xla_sum` and
cumulative sums :func:`repro_torch.numerics.blocked_cumsum`; no product
here is contracted into a fused multiply-add.

Only :func:`ftree_draw` has a kernel: its draws on the card, of any
shape, go through ``kernels/ftree_sample``.  The rest is plain PyTorch on every
device, as the reference's is plain XLA; nothing syncs with the host,
so Vose's loop runs its T pairings with the stopped ones masked.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import ftree
from repro_torch.numerics import blocked_cumsum, xla_sum

__all__ = [
    "AliasState", "BSearchState", "FTreeState", "LSearchState",
    "alias_draw", "alias_init", "alias_update",
    "bsearch_draw", "bsearch_init", "bsearch_update",
    "ftree_draw", "ftree_init", "ftree_update",
    "lsearch_draw", "lsearch_guarded", "lsearch_init", "lsearch_update",
    "SAMPLERS",
]


def lsearch_guarded(c: torch.Tensor, u_val: torch.Tensor) -> torch.Tensor:
    """Zero-mass-aware LSearch, batched over rows: for ``c`` of shape
    ``(..., T)`` and ``u_val`` of shape ``(...)``, returns
    ``min(Σ(c ≤ u), Σ(c < c[-1]))`` as int64.

    The guard ``Σ(c < c[-1])`` is the index of the last entry with
    positive mass, so a boundary draw whose ``u`` reaches ``c[-1]``, and a
    row of all-zero mass, stay on a valid topic.  Both terms are integer
    counts, so the result does not depend on the order of the sums.
    """
    last = (c < c[..., -1:]).sum(-1)
    return torch.minimum((c <= u_val.unsqueeze(-1)).sum(-1), last)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _index(t, device) -> torch.Tensor:
    """A topic (an int or an integer tensor of one element) as a 1-element
    int64 tensor on ``device``, for scatters that do not sync."""
    return torch.as_tensor(t, device=device).to(torch.int64).reshape(1)


# --------------------------------------------------------------------------
# LSearch — linear search on p; only the normalizer is cached.
# --------------------------------------------------------------------------
class LSearchState(NamedTuple):
    p: torch.Tensor       # (T,) unnormalized parameters
    c_T: torch.Tensor     # () normalizer Σ p


def lsearch_init(p: torch.Tensor) -> LSearchState:
    return LSearchState(p=p, c_T=xla_sum(p))


def lsearch_draw(state: LSearchState, u01) -> torch.Tensor:
    """``min{t : c_t > u01·c_T}`` over the blocked cumsum, guarded onto
    the last positive-mass topic (the cached normalizer is another float
    reduction, and drifts under Θ(1) updates)."""
    u01 = _f32(u01, state.p.device)
    c = blocked_cumsum(state.p)
    return lsearch_guarded(c, u01 * state.c_T).to(torch.int32)


def lsearch_update(state: LSearchState, t, delta) -> LSearchState:
    """Θ(1) bookkeeping: ``p_t += delta`` and the normalizer with it."""
    d = _f32(delta, state.p.device)
    p = state.p.index_add(0, _index(t, state.p.device), d.reshape(1))
    return LSearchState(p=p, c_T=state.c_T + d)


# --------------------------------------------------------------------------
# BSearch — binary search on the cached cumulative sums.
# --------------------------------------------------------------------------
class BSearchState(NamedTuple):
    c: torch.Tensor       # (T,) cumsum(p)


def bsearch_init(p: torch.Tensor) -> BSearchState:
    return BSearchState(c=blocked_cumsum(p))


def bsearch_draw(state: BSearchState, u01) -> torch.Tensor:
    u = _f32(u01, state.c.device) * state.c[-1]
    return torch.searchsorted(state.c, u, right=True).to(torch.int32)


def bsearch_update(state: BSearchState, t, delta) -> BSearchState:
    """Θ(T): every cumsum entry at or after ``t`` shifts by ``delta``."""
    c = state.c
    ar = torch.arange(c.shape[-1], device=c.device)
    t = torch.as_tensor(t, device=c.device)
    bump = torch.where(ar >= t, _f32(delta, c.device), 0.0)
    return BSearchState(c=c + bump)


# --------------------------------------------------------------------------
# Alias method — Walker/Vose table; Θ(1) generation, Θ(T) (re)build.
# --------------------------------------------------------------------------
class AliasState(NamedTuple):
    prob: torch.Tensor    # (T,) acceptance probability per bucket
    alias: torch.Tensor   # (T,) int32 alias index per bucket
    c_T: torch.Tensor     # () normalizer Σ p


def alias_init(p: torch.Tensor) -> AliasState:
    """Vose's construction, the reference's pairing for pairing.

    Buckets with scaled mass < 1 go on the small stack, ≥ 1 on the large
    one, each in index order (a stable sort).  A pairing pops the top
    small bucket ``s``, finalizes it against the top large bucket ``l``,
    and leaves ``l`` with ``scaled[l] − (1 − scaled[s])``; if that is
    below 1, ``l`` moves onto the small stack.  The loop stops when either
    stack is empty, after at most T pairings; leftovers keep probability 1
    and alias themselves.  Here all T pairings run, each masked once the
    reference's loop would have stopped, so the host never waits on the
    device.
    """
    T = p.shape[-1]
    dev = p.device
    c_T = xla_sum(p)
    # ``T / c_T``: the weakly typed T is an f32 in the division.
    scaled = torch.where(c_T > 0, p * (_f32(T, dev) / c_T),
                         torch.ones_like(p))
    is_small = scaled < 1.0
    small = torch.argsort((~is_small).to(torch.int8), stable=True)
    large = torch.argsort(is_small.to(torch.int8), stable=True)
    n_s = is_small.sum().reshape(1)
    n_l = T - n_s
    prob = torch.ones_like(p)
    alias = torch.arange(T, dtype=torch.int64, device=dev)
    for _ in range(T):
        live = (n_s > 0) & (n_l > 0)
        s = small.gather(0, (n_s - 1).clamp(min=0))
        l = large.gather(0, (n_l - 1).clamp(min=0))
        n_s = n_s - live.long()
        sc_s, sc_l = scaled.gather(0, s), scaled.gather(0, l)
        prob.scatter_(0, s, torch.where(live, sc_s, prob.gather(0, s)))
        alias.scatter_(0, s, torch.where(live, l, alias.gather(0, s)))
        new_l = sc_l - (1.0 - sc_s)
        scaled.scatter_(0, l, torch.where(live, new_l, sc_l))
        goes = live & (new_l < 1.0)
        # A push onto the small stack writes slot n_s (at most T - 1).
        slot = n_s.clamp(max=T - 1)
        small.scatter_(0, slot, torch.where(goes, l, small.gather(0, slot)))
        n_s = n_s + goes.long()
        n_l = n_l - goes.long()
    return AliasState(prob=prob, alias=alias.to(torch.int32), c_T=c_T)


def alias_draw(state: AliasState, u01) -> torch.Tensor:
    """Bucket ``j = ⌊u01·T⌋``, then ``j`` if ``u01·T − j < prob[j]``, else
    its alias.  XLA CPU does not contract ``u01·T − j``: the product is
    rounded before the subtraction."""
    prob = state.prob
    T = prob.shape[-1]
    u01 = _f32(u01, prob.device)
    u = u01 * T
    j = torch.floor(u).to(torch.int64).clamp(0, T - 1)
    frac = u - j.to(torch.float32)
    keep = frac < prob[j]
    return torch.where(keep, j, state.alias[j].to(torch.int64)).to(
        torch.int32)


def alias_update(state: AliasState, t, delta, p: torch.Tensor | None = None
                 ) -> AliasState:
    """Θ(T): the alias table cannot absorb a single-parameter change — full
    rebuild from the (caller-maintained) parameter vector."""
    if p is None:
        raise ValueError("alias_update needs the full parameter vector p "
                         "(the table is rebuilt — paper Table 1, Θ(T)).")
    if t is not None:
        p = p.index_add(0, _index(t, p.device),
                        _f32(delta, p.device).reshape(1))
    return alias_init(p)


# --------------------------------------------------------------------------
# F+tree — paper §3.1.
# --------------------------------------------------------------------------
class FTreeState(NamedTuple):
    F: torch.Tensor       # (2T,) heap array


def ftree_init(p: torch.Tensor) -> FTreeState:
    return FTreeState(F=ftree.build(p))


def ftree_draw(state: FTreeState, u01) -> torch.Tensor:
    """Draws from the tree: on the card every shape of ``u01`` goes
    through the ``ftree_sample`` kernel as one flat batch (or raises); on
    the CPU the plain version walks it."""
    from repro_torch.kernels.ftree_sample.ops import ftree_sample
    F = state.F
    u01 = _f32(u01, F.device)
    if F.is_cuda:
        return ftree_sample(F, u01.reshape(-1)).reshape(u01.shape)
    return ftree.sample_batch(F, u01).to(torch.int32)


def ftree_update(state: FTreeState, t, delta) -> FTreeState:
    return FTreeState(F=ftree.update(state.F, t, delta))


SAMPLERS = {
    "lsearch": (lsearch_init, lsearch_draw, lsearch_update),
    "bsearch": (bsearch_init, bsearch_draw, bsearch_update),
    "alias": (alias_init, alias_draw, None),   # update needs full p
    "ftree": (ftree_init, ftree_draw, ftree_update),
}
