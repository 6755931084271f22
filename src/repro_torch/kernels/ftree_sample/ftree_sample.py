"""Launch wrapper of the CUDA batched F+tree sampling kernel
(``csrc/ftree_sample.cu``), the port of the Pallas kernel
``repro/kernels/ftree_sample/ftree_sample.py:ftree_sample_pallas``.

:func:`ftree_sample_cuda` checks what the kernel takes and raises on
anything else (a tree too large for one CTA's shared memory among it),
allocates the draws, launches on PyTorch's current stream and counts the
launch in :data:`launches`.  It never falls back to the plain version:
``ops.ftree_sample`` picks the plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["ftree_sample_cuda", "check_fits", "SMEM_LIMIT_BYTES",
           "launches"]

#: Dynamic shared memory one block may use on Hopper (sm_90).
SMEM_LIMIT_BYTES = 232_448

#: Kernel launches since the count was last set to 0.
launches = 0


def check_fits(T: int) -> None:
    """Raise ``ValueError`` unless ``T`` is a power of two whose tree
    (8·T bytes) fits one CTA's shared memory."""
    if T < 1 or T & (T - 1):
        raise ValueError(f"F+tree size must be a power of two, got T={T}")
    if 8 * T > SMEM_LIMIT_BYTES:
        raise ValueError(f"an F+tree of T={T} leaves ({8 * T} B) exceeds the "
                         f"{SMEM_LIMIT_BYTES} B of shared memory a block may "
                         f"use")


def ftree_sample_cuda(F: torch.Tensor, u01: torch.Tensor) -> torch.Tensor:
    """``z[n] = sample(F, u01[n])`` on the card: ``F`` ``(2T,)`` f32,
    ``u01`` ``(N,)`` f32, both contiguous on one CUDA device; ``(N,)``
    int32."""
    global launches
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
    check_fits(F.shape[0] // 2)
    z = torch.empty(u01.shape[0], dtype=torch.int32, device=dev)
    if u01.shape[0]:
        _build.launch("ftree_sample_launch", F.data_ptr(), u01.data_ptr(),
                      z.data_ptr(), u01.shape[0], F.shape[0] // 2,
                      torch.cuda.current_stream(dev).cuda_stream)
        launches += 1
    return z
