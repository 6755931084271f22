"""Public wrapper of the batched F+tree sampling kernel (the reference's
``repro/kernels/ftree_sample/ops.py:ftree_sample``): dtype plumbing and
the device dispatch.  A CUDA tree launches the kernel (or raises); a CPU
tree runs the plain version.  Any ``N``: there is no padding to the TPU's
1024-draw tile."""
from __future__ import annotations

import torch

from repro_torch.kernels.ftree_sample.ftree_sample import ftree_sample_cuda
from repro_torch.kernels.ftree_sample.ref import ftree_sample_ref

__all__ = ["ftree_sample"]


def ftree_sample(F: torch.Tensor, u01: torch.Tensor) -> torch.Tensor:
    """Batched F+tree draws: ``F`` ``(2T,)``, ``u01`` ``(N,)`` on one
    device → ``(N,)`` int32."""
    if u01.device != F.device:
        raise ValueError(f"u01 is on {u01.device}, F on {F.device}")
    F = F.to(torch.float32)
    u01 = u01.to(torch.float32)
    if F.device.type == "cuda":
        return ftree_sample_cuda(F.contiguous(), u01.contiguous())
    return ftree_sample_ref(F, u01)
