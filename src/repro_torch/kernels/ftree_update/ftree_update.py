"""Launch wrapper of the CUDA batched F+tree update kernel
(``csrc/ftree_update.cu``), the port of the Pallas kernel
``repro/kernels/ftree_update/ftree_update.py:ftree_update_pallas``.

:func:`ftree_update_cuda` checks what the kernel takes and raises on
anything else, allocates the new tree (the given one is not changed),
launches on PyTorch's current stream and counts the launch in
:data:`launches`.  It never falls back to the plain version:
``ops.ftree_update_batch`` picks the plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["ftree_update_cuda", "check_fits", "SMEM_LIMIT_BYTES", "BATCH",
           "launches"]

#: Dynamic shared memory one block may use on Hopper (sm_90).
SMEM_LIMIT_BYTES = 232_448
#: Updates a CTA stages in shared memory at once (``kBatch``).
BATCH = 4096

#: Kernel launches since the count was last set to 0.
launches = 0


def check_fits(T: int) -> None:
    """Raise ``ValueError`` unless ``T`` is a power of two whose leaf level
    and one staged batch (4·T + 8·BATCH bytes) fit one CTA's shared
    memory."""
    if T < 1 or T & (T - 1):
        raise ValueError(f"F+tree size must be a power of two, got T={T}")
    smem = 4 * T + 8 * BATCH
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"the update kernel's state for T={T} ({smem} B) "
                         f"exceeds the {SMEM_LIMIT_BYTES} B of shared memory "
                         f"a block may use")


def ftree_update_cuda(F: torch.Tensor, ts: torch.Tensor,
                      deltas: torch.Tensor) -> torch.Tensor:
    """The tree after ``p[ts[k]] += deltas[k]`` on the card: ``F`` ``(2T,)``
    f32, ``ts`` ``(K,)`` int32 in ``[0, T)``, ``deltas`` ``(K,)`` f32, all
    contiguous on one CUDA device.  Each node adds its deltas in the order
    of ``k``, as the plain version does on the CPU."""
    global launches
    dev = F.device
    if dev.type != "cuda":
        raise ValueError(f"ftree_update_cuda runs on a CUDA device; F is on "
                         f"{dev}")
    for name, x, dtype in (("F", F, torch.float32), ("ts", ts, torch.int32),
                           ("deltas", deltas, torch.float32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, F on {dev}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}; got {x.dtype}")
        if x.ndim != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor; got "
                             f"shape {tuple(x.shape)}")
    if F.shape[0] % 2 or ts.shape != deltas.shape:
        raise ValueError(f"F (2T,) and ts, deltas (K,) expected; got "
                         f"{tuple(F.shape)}, {tuple(ts.shape)}, "
                         f"{tuple(deltas.shape)}")
    T = F.shape[0] // 2
    check_fits(T)
    if ts.shape[0] >= 2**31:
        raise ValueError(f"at most 2**31 - 1 updates a launch; got "
                         f"{ts.shape[0]}")
    out = torch.empty_like(F)
    _build.launch("ftree_update_launch", F.data_ptr(), ts.data_ptr(),
                  deltas.data_ptr(), out.data_ptr(), ts.shape[0], T,
                  torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    return out
