"""Public fused-sweep ops: the device dispatch between the CUDA kernel and
its plain version.

:func:`sweep_streams` is the primitive every caller goes through: on CUDA
tensors it launches the kernel (``fused_sweep.sweep_streams_cuda``), on
CPU tensors it runs the plain version (``ref.sweep_streams_ref``); it
never falls back.  :func:`fused_sweep_tokens` and
:func:`fused_sweep_ragged` keep the reference's signatures
(``repro/kernels/fused_sweep/ops.py``): the r-mode resolution and the
tile/cell sub-ranges are ``ref.py``'s, with this dispatch underneath.
The kernel needs no padding: a stream is one tile
(``fused_sweep_tokens``) or the layout's own tiles
(``fused_sweep_ragged``), and the reference's padding tokens are masked
no-ops.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_sweep.fused_sweep import sweep_streams_cuda
from repro_torch.kernels.fused_sweep.ref import (fused_sweep_ragged_ref,
                                                 fused_sweep_ref,
                                                 sweep_streams_ref)

__all__ = ["sweep_streams", "fused_sweep_tokens", "fused_sweep_ragged"]


def sweep_streams(*args, kernel: str = "fused_sweep_ragged",
                  **kw) -> torch.Tensor:
    """W token streams through the kernel (CUDA tensors) or its plain
    version (CPU tensors); arguments as ``ref.sweep_streams_ref``.
    ``kernel`` names the launch count a kernel launch adds to."""
    if args[9].device.type == "cuda":
        return sweep_streams_cuda(*args, kernel=kernel, **kw)
    return sweep_streams_ref(*args, **kw)


def _sweep_one(*args, **kw) -> torch.Tensor:
    return sweep_streams(*args, kernel="fused_sweep", **kw)


def _check_pow2(T: int) -> None:
    if T < 1 or T & (T - 1):
        raise ValueError(f"fused sweep needs a power-of-two T, got {T}")


def fused_sweep_tokens(*args, **kw):
    """One fused sweep over one token stream against one ``(J, T)``
    block; signature and returns as ``ref.fused_sweep_ref``."""
    _check_pow2(args[8].shape[-1])
    return fused_sweep_ref(*args, sweep=_sweep_one, **kw)


def fused_sweep_ragged(*args, **kw):
    """One fused sweep over a ragged cell stream (a nomad queue);
    signature and returns as ``ref.fused_sweep_ragged_ref``."""
    _check_pow2(args[9].shape[-1])
    return fused_sweep_ragged_ref(*args, sweep=sweep_streams, **kw)
