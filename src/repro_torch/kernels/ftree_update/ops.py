"""Public wrapper of the batched F+tree update kernel (the reference's
``repro/kernels/ftree_update/ops.py:ftree_update_batch``): dtype plumbing
and the device dispatch.  A CUDA tree launches the kernel (or raises); a
CPU tree runs the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.ftree_update.ftree_update import ftree_update_cuda
from repro_torch.kernels.ftree_update.ref import ftree_update_ref

__all__ = ["ftree_update_batch"]


def ftree_update_batch(F: torch.Tensor, ts: torch.Tensor,
                       deltas: torch.Tensor) -> torch.Tensor:
    """F+tree after ``p[ts[k]] += deltas[k]`` for all ``k`` (duplicates
    accumulate); a new tree, ``F`` is not changed.  All three on one
    device."""
    for name, x in (("ts", ts), ("deltas", deltas)):
        if x.device != F.device:
            raise ValueError(f"{name} is on {x.device}, F on {F.device}")
    F = F.to(torch.float32)
    ts = ts.to(torch.int32)
    deltas = deltas.to(torch.float32)
    if F.device.type == "cuda":
        return ftree_update_cuda(F.contiguous(), ts.contiguous(),
                                 deltas.contiguous())
    return ftree_update_ref(F, ts, deltas)
