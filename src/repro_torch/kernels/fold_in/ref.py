"""Plain PyTorch version of the fold-in kernel: the same precomputed
``(z0, u)`` draws as the CUDA kernel (``ops.fold_in_draws``), the same
per-token chain, batched over documents with a loop over sweeps ×
positions.  The CPU path and the CUDA kernel's yardstick on the card
(``repro/kernels/fold_in/ref.py`` in the JAX package)."""
from __future__ import annotations

import torch

from repro_torch.core.heldout import _fold_chain

__all__ = ["fold_in_kernel_ref"]


def fold_in_kernel_ref(word_ids: torch.Tensor, valid: torch.Tensor,
                       z0: torch.Tensor, u: torch.Tensor, alpha,
                       phi: torch.Tensor) -> torch.Tensor:
    """``word_ids``/``valid``/``z0``: (D, L); ``u``: (D, sweeps, L) f32;
    returns (D, T) int32 counts."""
    T = phi.shape[1]
    z = z0.to(torch.int64).clone()
    v = valid.to(torch.int32)
    n_td = torch.zeros((z.shape[0], T), dtype=torch.int32,
                       device=z.device)
    n_td.scatter_add_(1, z, v)
    return _fold_chain(word_ids, v, z, n_td, u.unbind(1), alpha, phi)
