"""Multinomial draw over a cumulative vector (``repro/core/samplers.py``);
only the guarded LSearch that the fold-in chain uses is ported so far."""
from __future__ import annotations

import torch

__all__ = ["lsearch_guarded"]


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
