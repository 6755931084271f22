"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means CUDA.  Raises when CUDA is wanted and absent: the
    port never falls back to the CPU on its own, only when asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
