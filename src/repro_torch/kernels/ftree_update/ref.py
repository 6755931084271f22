"""Plain PyTorch version of the batched F+tree update kernel, the port of
``repro/kernels/ftree_update/ref.py``: ``core/ftree.py:update_batch``,
which returns a new tree and leaves the given one unchanged."""
from __future__ import annotations

import torch

from repro_torch.core import ftree

__all__ = ["ftree_update_ref"]


def ftree_update_ref(F: torch.Tensor, ts: torch.Tensor,
                     deltas: torch.Tensor) -> torch.Tensor:
    """The tree ``F`` ``(2T,)`` after ``p[ts[k]] += deltas[k]`` for all
    ``k``."""
    return ftree.update_batch(F, ts, deltas)
