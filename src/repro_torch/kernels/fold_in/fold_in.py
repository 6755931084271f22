"""Launch wrapper of the CUDA fold-in kernel (``csrc/fold_in.cu``), the
port of the Pallas kernel ``repro/kernels/fold_in/fold_in.py:
fold_in_pallas``.

:func:`fold_in_cuda` checks what the kernel takes and raises on anything
else, allocates the output, launches on PyTorch's current stream and
counts the launch in :data:`launches`.  It also allocates the documents'
rows of device scratch where the kernel keeps state there: ``n_td`` above
:data:`WIDE_TOPICS`, and the chain's four per-token arrays where they do
not fit shared memory beside the state (:func:`long_placement`).  It never
falls back to the plain version: ``ops.fold_in_fused`` picks the plain
version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.numerics import SCAN_BLOCK

__all__ = ["fold_in_cuda", "fold_in_smem_bytes", "least_smem_bytes",
           "long_placement", "scratch_words", "check_fits",
           "SMEM_LIMIT_BYTES", "WIDE_TOPICS", "DEEP_TOPICS", "MAX_TOPICS",
           "MAX_STEPS", "launches"]

#: Dynamic shared memory one block may use on Hopper (sm_90).
SMEM_LIMIT_BYTES = 232_448
#: Above this T the kernel keeps ``n_td`` in device memory and reads φ rows
#: where they lie (``csrc/fold_in.cu:kWideTopics``): a warp for each 1024
#: topics, 16 at most, each thread one 32-topic line.
WIDE_TOPICS = SCAN_BLOCK * 1024
#: Up to this T each thread of the 16 warps keeps its (at most four) lines'
#: level-1 values between the step's two passes
#: (``csrc/fold_in.cu:kDeepTopics``); above it it forms them again and the
#: group totals take a fifth scan level.
DEEP_TOPICS = 4 * WIDE_TOPICS
#: The largest T the kernel takes (``csrc/fold_in.cu:kMaxTopics``): the
#: largest the reference's guard admits (``repro/kernels/fold_in/ops.py:
#: fold_in_vmem_bytes`` at L = 1, one sweep), 64 lines a thread.
MAX_TOPICS = 1_048_574
#: The most chain steps (``sweeps · L``) a launch takes: the kernel's step
#: indices, with their look-ahead, stay inside int32
#: (``csrc/fold_in.cu:kMaxSteps``).  The reference's guard admits at most
#: about 3.1 million.
MAX_STEPS = 2**31 - 1 - 64

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


def _huge_words(T: int) -> int:
    """f32 words of the warps' exchange above :data:`DEEP_TOPICS`
    (``csrc/fold_in.cu:huge_words``): the group totals and their prefixes,
    the last block's two values, 16 warps' two counts, the supergroup
    totals and their prefixes."""
    ng = -(-T // SCAN_BLOCK ** 2)
    return 2 * ng + 2 + 2 * 16 + 2 * -(-ng // SCAN_BLOCK)


def _fitting_smem_bytes(L: int, T: int) -> int:
    """The least shared memory with the four L-arrays in it, in bytes."""
    if T > DEEP_TOPICS:
        return 4 * (4 * L + _huge_words(T))
    lines = 0 if T > WIDE_TOPICS else -(-T // 32) * 32
    return 4 * (2 * lines + 4 * L + _scan_scratch(T))


def long_placement(L: int, T: int) -> bool:
    """Whether the kernel keeps the chain's four per-token arrays (topic,
    φ row, weight and position of each valid token) in the document's row
    of device scratch: where beside the state they would pass
    :data:`SMEM_LIMIT_BYTES` (``csrc/fold_in.cu:long_rows``; at T = 1024
    every L above 13,999)."""
    return _fitting_smem_bytes(L, T) > SMEM_LIMIT_BYTES


def least_smem_bytes(L: int, T: int) -> int:
    """The least shared memory one CTA needs, in bytes: i32 ``n_td`` and
    one f32 φ row (T each, in whole 32-topic lines; neither above
    :data:`WIDE_TOPICS`), i32 topic, φ row, weight and position of each
    valid token (L each; none in the long placement) and the f32 upper
    scan levels (above :data:`DEEP_TOPICS` the warps' exchange instead).
    The kernel adds ring slots from what the block has left
    (``csrc/fold_in.cu:smem_bytes``, which its launcher computes itself);
    this formula is kept here so that :func:`check_fits` runs without the
    built library."""
    return _fitting_smem_bytes(0 if long_placement(L, T) else L, T)


def scratch_words(L: int, T: int) -> int:
    """i32 words of device memory a document takes: its ``n_td`` row in
    whole 32-topic lines above :data:`WIDE_TOPICS`, then its four
    L-arrays in the long placement, else none
    (``csrc/fold_in.cu:scratch_words``)."""
    ntd = -(-T // 32) * 32 if T > WIDE_TOPICS else 0
    return ntd + (4 * L if long_placement(L, T) else 0)


def fold_in_smem_bytes(L: int, T: int) -> int:
    """Shared memory one CTA takes, in bytes, ring slots included
    (``csrc/fold_in.cu:smem_bytes``, read from the built library)."""
    return int(_build.library().fold_in_smem_bytes(int(L), int(T)))


def check_fits(L: int, T: int, sweeps: int = 1) -> None:
    """Raise ``ValueError`` for a ``(L, T, sweeps)`` the kernel cannot
    run: T past :data:`MAX_TOPICS`, or a chain or a scratch row past int32
    (``sweeps · L`` past :data:`MAX_STEPS`, a document's scratch past
    2^31 − 1 bytes).  Every length takes a placement that fits shared
    memory, so it takes every ``(L, T, sweeps)`` the reference's guard
    (``fold_in_vmem_bytes``) admits."""
    if T > MAX_TOPICS:
        raise ValueError(f"the fold-in kernel takes T <= {MAX_TOPICS} "
                         f"topics; got T={T}")
    if sweeps * L > MAX_STEPS or 4 * scratch_words(L, T) > 2**31 - 1:
        raise ValueError(
            f"fold-in chain of sweeps={sweeps} x L={L} positions passes the "
            f"kernel's int32 indices (at most {MAX_STEPS} steps and 2^31 - 1 "
            f"bytes of scratch a document); lower the length bucket")


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
    sweeps = u.shape[1] // L
    check_fits(L, T, sweeps)
    out = torch.empty((D, T), dtype=torch.int32, device=phi.device)
    scratch = None
    if scratch_words(L, T):
        scratch = torch.empty((D, scratch_words(L, T)), dtype=torch.int32,
                              device=phi.device)
    _build.launch(
        "fold_in_launch", word_ids.data_ptr(), valid.data_ptr(),
        z0.data_ptr(), u.data_ptr(), phi.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else 0,
        float(alpha), D, L, T, J, sweeps,
        torch.cuda.current_stream(phi.device).cuda_stream)
    launches += 1
    return out
