"""Launch wrapper of the CUDA batched F+tree sampling kernel
(``csrc/ftree_sample.cu``), the port of the Pallas kernel
``repro/kernels/ftree_sample/ftree_sample.py:ftree_sample_pallas``.

:func:`ftree_sample_cuda` checks what the kernel takes and raises on
anything else, allocates the draws, launches on PyTorch's current stream
and counts the launch in :data:`launches`.  It never falls back to the
plain version: ``ops.ftree_sample`` picks the plain version for CPU
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["ftree_sample_cuda", "check_fits", "MAX_TOPICS", "launches"]

#: The largest tree: its heap indices, up to 2T - 1, fit an int32.
MAX_TOPICS = 1 << 30

#: Kernel launches since the count was last set to 0.
launches = 0


def check_fits(T: int) -> None:
    """Raise ``ValueError`` unless ``T`` is a power of two whose heap
    indices fit an int32 (T <= 2^30).  The kernel keeps the top 15
    levels in shared memory and reads any deeper ones from device memory,
    so the tree's size is not bound by a CTA's shared memory."""
    if T < 1 or T & (T - 1):
        raise ValueError(f"F+tree size must be a power of two, got T={T}")
    if T > MAX_TOPICS:
        raise ValueError(f"an F+tree of T={T} leaves has heap indices past "
                         f"int32 (T <= {MAX_TOPICS})")


def _refuse(F: torch.Tensor, u01: torch.Tensor) -> None:
    """Raise ``ValueError`` naming what the kernel does not take."""
    dev = F.device
    if dev.type != "cuda":
        raise ValueError(f"ftree_sample_cuda runs on a CUDA device; F is on "
                         f"{dev}")
    for name, x in (("F", F), ("u01", u01)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, F on {dev}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32; got {x.dtype}")
        if x.ndim != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor; got "
                             f"shape {tuple(x.shape)}")
    if F.shape[0] % 2:
        raise ValueError(f"F must hold 2T entries; got {F.shape[0]}")


def ftree_sample_cuda(F: torch.Tensor, u01: torch.Tensor) -> torch.Tensor:
    """``z[n] = sample(F, u01[n])`` on the card: ``F`` ``(2T,)`` f32 for
    any power-of-two T up to :data:`MAX_TOPICS`, ``u01`` ``(N,)`` f32,
    both contiguous on one CUDA device (a view at any offset will do);
    ``(N,)`` int32."""
    global launches
    index = F.get_device()
    if not (F.is_cuda and u01.get_device() == index
            and F.dtype == u01.dtype == torch.float32
            and F.dim() == u01.dim() == 1 and F.shape[0] % 2 == 0
            and F.is_contiguous() and u01.is_contiguous()):
        _refuse(F, u01)
    T, N = F.shape[0] // 2, u01.shape[0]
    check_fits(T)
    z = torch.empty(N, dtype=torch.int32, device=F.device)
    if N:
        # The current stream's handle as PyTorch's own kernel launchers
        # read it, without building a torch.cuda.Stream at every call.
        _build.launch("ftree_sample_launch", F.data_ptr(), u01.data_ptr(),
                      z.data_ptr(), N, T,
                      torch._C._cuda_getCurrentRawStream(index))
        launches += 1
    return z
