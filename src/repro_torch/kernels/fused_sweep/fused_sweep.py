"""Launch wrapper of the CUDA fused-sweep kernel (``csrc/fused_sweep.cu``),
the port of the Pallas kernels ``repro/kernels/fused_sweep/fused_sweep.py:
fused_sweep_pallas`` and ``fused_sweep_ragged_pallas``.

:func:`sweep_streams_cuda` takes the arguments of the plain version
``ref.sweep_streams_ref``, checks what the kernel takes and raises on
anything else, launches one CTA per stream on PyTorch's current stream
and counts the launch in :data:`launches`, under the name of the TPU
kernel the call stands for: ``"fused_sweep"`` (one stream, the serial
sweep) or ``"fused_sweep_ragged"`` (a round of nomad worker streams).  It
never falls back to the plain version: ``ops.sweep_streams`` picks the
plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.numerics import SCAN_BLOCK

__all__ = ["sweep_streams_cuda", "fused_sweep_smem_bytes", "check_fits",
           "SMEM_LIMIT_BYTES", "MAX_TOPICS", "launches"]

#: Dynamic shared memory one block may use on Hopper (sm_90).
SMEM_LIMIT_BYTES = 232_448
#: One thread per topic, at most 1024 threads a block.
MAX_TOPICS = 1024
_ROOT_RUN, _RED = 32, 32

#: Kernel launches since the counts were last set to 0, by TPU kernel.
launches = {"fused_sweep": 0, "fused_sweep_ragged": 0}


def _scan_scratch(n: int) -> int:
    """f32 entries of the upper scan levels of an ``n``-long scan."""
    size, n = 0, -(-n // SCAN_BLOCK)
    while True:
        size += n
        if n <= SCAN_BLOCK:
            return size
        n = -(-n // SCAN_BLOCK)


def fused_sweep_smem_bytes(T: int, cap: int) -> int:
    """Shared memory of one CTA: the f32 F+tree (2T), the i32 ``n_t`` copy
    (T), the compacted vector (2 cap), 72 i32 of reduction scratch, 32 f32
    root run totals and the f32 upper scan levels of ``cap``."""
    return 4 * (3 * T + 2 * cap + 2 * _RED + 8 + _ROOT_RUN
                + _scan_scratch(cap))


def check_fits(T: int, cap: int) -> None:
    """Raise ``ValueError`` for a ``(T, cap)`` the kernel cannot run."""
    if T < 2 or T > MAX_TOPICS or T & (T - 1):
        raise ValueError(f"the fused-sweep kernel takes a power-of-two T in "
                         f"[2, {MAX_TOPICS}]; got T={T}")
    if not 1 <= cap <= T:
        raise ValueError(f"r_cap must be in [1, T={T}], got {cap}")
    smem = fused_sweep_smem_bytes(T, cap)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"fused-sweep state ({smem} B) exceeds the "
                         f"{SMEM_LIMIT_BYTES} B of shared memory a block "
                         f"may use")


def sweep_streams_cuda(tok_doc, tok_wrd, tok_valid, tok_bound, z, u, cot,
                       n_td, n_wt, n_t, *, r: int, k: int, tile: int,
                       tile_start: int, num_tiles: int, I_max: int,
                       J_max: int, alpha: float, beta: float,
                       beta_bar: float, cap: int, topics=None, counts=None,
                       kernel: str = "fused_sweep_ragged") -> torch.Tensor:
    """The kernel on the card; arguments and in-place updates as
    ``ref.sweep_streams_ref``.  Returns the final F+trees ``(W, 2T)``.
    ``kernel`` names the launch count it adds to."""
    if kernel not in launches:
        raise ValueError(f"kernel must be one of {sorted(launches)}")
    dev = n_t.device
    if dev.type != "cuda":
        raise ValueError(f"sweep_streams_cuda runs on a CUDA device; n_t is "
                         f"on {dev}")
    named = {"tok_doc": tok_doc, "tok_wrd": tok_wrd,
             "tok_valid": tok_valid, "tok_bound": tok_bound, "z": z,
             "cot": cot, "n_td": n_td, "n_wt": n_wt, "n_t": n_t, "u": u}
    if (topics is None) != (counts is None):
        raise ValueError("topics and counts come together (sparse r-mode)")
    if topics is not None:
        named.update(topics=topics, counts=counts)
    for name, x in named.items():
        want = torch.float32 if name == "u" else torch.int32
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, n_t on {dev}")
        if x.dtype != want:
            raise ValueError(f"{name} must be {want}; got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tok_doc.ndim != 3:
        raise ValueError(f"token arrays must be (W, C, S); got "
                         f"{tuple(tok_doc.shape)}")
    W, C, S = tok_doc.shape
    T = n_t.shape[-1]
    n_tiles = cot.shape[-1]
    for name in ("tok_wrd", "tok_valid", "tok_bound", "z"):
        if named[name].shape != tok_doc.shape:
            raise ValueError(f"{name} {tuple(named[name].shape)} must match "
                             f"tok_doc {tuple(tok_doc.shape)}")
    if tuple(u.shape) != (W, S) or tuple(cot.shape) != (W, C, n_tiles):
        raise ValueError(f"u must be (W, S) = {(W, S)} and cot (W, C, "
                         f"n_tiles); got {tuple(u.shape)}, "
                         f"{tuple(cot.shape)}")
    if tuple(n_t.shape) != (W, T) or n_td.shape != (W * I_max, T) \
            or n_wt.ndim != 2 or n_wt.shape[1] != T:
        raise ValueError(f"n_t (W, T), n_td (W·I_max, T), n_wt (B·J_max, "
                         f"T) expected; got {tuple(n_t.shape)}, "
                         f"{tuple(n_td.shape)}, {tuple(n_wt.shape)}")
    if topics is not None and (topics.shape != (W * I_max, cap)
                               or counts.shape != topics.shape):
        raise ValueError(f"side tables must be (W·I_max, cap) = "
                         f"{(W * I_max, cap)}; got {tuple(topics.shape)}")
    if tile < 1 or n_tiles * tile > S or tile_start < 0 or num_tiles < 0 \
            or tile_start + num_tiles > n_tiles:
        raise ValueError(f"tiles [{tile_start}, {tile_start + num_tiles}) "
                         f"of {tile} tokens do not fit a {n_tiles}-tile "
                         f"stream of {S}")
    check_fits(T, cap)
    F = torch.empty((W, 2 * T), dtype=torch.float32, device=dev)
    null = 0
    _build.launch(
        "fused_sweep_launch", tok_doc.data_ptr(), tok_wrd.data_ptr(),
        tok_valid.data_ptr(), tok_bound.data_ptr(), z.data_ptr(),
        u.data_ptr(), cot.data_ptr(), n_td.data_ptr(), n_wt.data_ptr(),
        n_t.data_ptr(), F.data_ptr(),
        topics.data_ptr() if topics is not None else null,
        counts.data_ptr() if counts is not None else null,
        W, C, S, n_tiles, tile, tile_start, num_tiles, int(r), int(k),
        int(I_max), int(J_max), T, int(cap), float(alpha), float(beta),
        float(beta_bar), fused_sweep_smem_bytes(T, cap),
        torch.cuda.current_stream(dev).cuda_stream)
    launches[kernel] += 1
    return F
