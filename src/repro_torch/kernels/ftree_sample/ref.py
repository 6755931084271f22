"""Plain PyTorch version of the batched F+tree sampling kernel, the port of
``repro/kernels/ftree_sample/ref.py``: ``core/ftree.py:sample_batch``, as
int32 draws."""
from __future__ import annotations

import torch

from repro_torch.core import ftree

__all__ = ["ftree_sample_ref"]


def ftree_sample_ref(F: torch.Tensor, u01: torch.Tensor) -> torch.Tensor:
    """``(N,)`` int32 draws from the one tree ``F`` ``(2T,)``."""
    return ftree.sample_batch(F, u01).to(torch.int32)
