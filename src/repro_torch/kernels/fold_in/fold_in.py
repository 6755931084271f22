"""Launch wrapper of the CUDA fold-in kernel (``csrc/fold_in.cu``), the
port of the Pallas kernel ``repro/kernels/fold_in/fold_in.py:
fold_in_pallas``.

:func:`fold_in_cuda` checks what the kernel takes and raises on anything
else, allocates the output, launches on PyTorch's current stream and
counts the launch in :data:`launches`.  It never falls back to the plain
version: ``ops.fold_in_fused`` picks the plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.numerics import SCAN_BLOCK

__all__ = ["fold_in_cuda", "fold_in_smem_bytes", "check_fits",
           "SMEM_LIMIT_BYTES", "MAX_TOPICS", "launches"]

#: Dynamic shared memory one block may use on Hopper (sm_90).
SMEM_LIMIT_BYTES = 232_448
#: One thread per 16-topic scan block, at most 1024 threads a block.
MAX_TOPICS = SCAN_BLOCK * 1024

#: Kernel launches since the count was last set to 0.
launches = 0


def _scan_scratch(T: int) -> int:
    """f32 entries of the kernel's upper scan levels (``scan_levels``)."""
    size, n = 0, -(-T // SCAN_BLOCK)
    while True:
        size += n
        if n <= SCAN_BLOCK:
            return size
        n = -(-n // SCAN_BLOCK)


def fold_in_smem_bytes(L: int, T: int) -> int:
    """Shared memory of one CTA: i32 ``n_td`` and the current f32 φ row
    (T each, plus one pad word per 16), i32 ``z``, word ids, mask and
    valid positions (L each), 66 i32 of reduction scratch, and the f32
    upper scan levels.  φ itself stays in global memory."""
    padded = T + -(-T // SCAN_BLOCK)
    return 4 * (2 * padded + 4 * L + 66 + _scan_scratch(T))


def check_fits(L: int, T: int) -> None:
    """Raise ``ValueError`` for a ``(L, T)`` the kernel cannot run."""
    if T > MAX_TOPICS:
        raise ValueError(f"the fold-in kernel takes T <= {MAX_TOPICS} "
                         f"topics; got T={T}")
    smem = fold_in_smem_bytes(L, T)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"fold-in kernel state ({smem / 2**10:.1f} KiB) exceeds the "
            f"{SMEM_LIMIT_BYTES // 2**10} KiB of shared memory a block may "
            f"use; lower the length bucket L={L} or use inner_mode='scan'")


def fold_in_cuda(word_ids: torch.Tensor, valid: torch.Tensor,
                 z0: torch.Tensor, u: torch.Tensor, alpha: float,
                 phi: torch.Tensor) -> torch.Tensor:
    """Fused multi-sweep fold-in of a padded batch on the card.

    ``word_ids``/``valid``/``z0``: (D, L) int32 (``valid`` a 0/1 mask);
    ``u``: (D, sweeps·L) f32, sweep-major per row; ``phi``: (J, T) f32.
    All contiguous on one CUDA device.  Returns (D, T) int32 counts.
    """
    global launches
    if phi.device.type != "cuda":
        raise ValueError(f"fold_in_cuda runs on a CUDA device; phi is on "
                         f"{phi.device}")
    named = {"word_ids": (word_ids, torch.int32),
             "valid": (valid, torch.int32), "z0": (z0, torch.int32),
             "u": (u, torch.float32), "phi": (phi, torch.float32)}
    for name, (x, dtype) in named.items():
        if x.device != phi.device:
            raise ValueError(f"{name} is on {x.device}, phi on "
                             f"{phi.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}; got {x.dtype}")
        if x.ndim != 2 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor; got "
                             f"shape {tuple(x.shape)}")
    D, L = word_ids.shape
    J, T = phi.shape
    if D < 1 or L < 1 or J < 1 or T < 1:
        raise ValueError(f"empty fold-in batch: word_ids {(D, L)}, phi "
                         f"{(J, T)}")
    if valid.shape != (D, L) or z0.shape != (D, L):
        raise ValueError(f"valid {tuple(valid.shape)} and z0 "
                         f"{tuple(z0.shape)} must match word_ids {(D, L)}")
    if u.shape[0] != D or u.shape[1] < L or u.shape[1] % L:
        raise ValueError(f"u must be (D, sweeps·L) = ({D}, k·{L}); got "
                         f"{tuple(u.shape)}")
    check_fits(L, T)
    out = torch.empty((D, T), dtype=torch.int32, device=phi.device)
    _build.launch(
        "fold_in_launch", word_ids.data_ptr(), valid.data_ptr(),
        z0.data_ptr(), u.data_ptr(), phi.data_ptr(), out.data_ptr(),
        float(alpha), D, L, T, J, u.shape[1] // L, fold_in_smem_bytes(L, T),
        torch.cuda.current_stream(phi.device).cuda_stream)
    launches += 1
    return out
