"""Launch wrapper of the CUDA ``lda_scores`` kernel
(``csrc/lda_scores.cu``), the port of the Pallas kernel
``repro/kernels/lda_scores/lda_scores.py:lda_scores_pallas``.

:func:`lda_scores_cuda` (the rows form) and :func:`lda_scores_pass_cuda`
(the pass form of the vectorized nomad pass) take the arguments of their
plain versions in ``ref.py``, check what the kernel takes and raise on
anything else, allocate the outputs (and, at T above 108,944, the
device scratch of the upper scan levels), launch on PyTorch's current
stream and count the launch in :data:`launches`.  The kernel takes any T
from 1 to :data:`MAX_TOPICS` (:func:`placement` says where it keeps each
token's scan).  They never fall back to the
plain version: ``ops.py`` picks the plain version for CPU tensors.  The
batch needs no padding: the TPU kernel's 256-token tile is the TPU's, and
the CUDA kernel masks its own ragged edge.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.numerics import SCAN_BLOCK

__all__ = ["lda_scores_cuda", "lda_scores_pass_cuda", "placement",
           "smem_bytes", "level_floats", "scratch_slots", "check_fits",
           "SMEM_LIMIT_BYTES", "WARPS", "MAX_TOPICS", "launches"]

#: Dynamic shared memory one block may use on Hopper (sm_90).
SMEM_LIMIT_BYTES = 232_448
#: Warps a CTA, one token each at a time (``kWarps``).
WARPS = 8
#: Topics of a chunk, one 32-topic line a lane (``kChunk``).
CHUNK = 1024
#: CTAs an SM at most (``kMinBlocks``): the grid of the layout whose
#: levels lie in device memory, and so its scratch, is at most this many
#: CTAs an SM.
MIN_BLOCKS = 2
#: The largest T: every topic index a lane forms, up to T + 2·CHUNK, fits
#: an int32 (``kMaxT``).
MAX_TOPICS = 2**31 - 1 - 2 * CHUNK

#: Kernel launches since the counts were last set to 0, by form.
launches = {"lda_scores": 0, "lda_scores_pass": 0}


def _scan_scratch(T: int) -> int:
    """f32 entries of the upper scan levels (``scan_levels``)."""
    size, n = 0, -(-T // SCAN_BLOCK)
    while True:
        size += n
        if n <= SCAN_BLOCK:
            return size
        n = -(-n // SCAN_BLOCK)


def level_floats(T: int) -> int:
    """f32 entries of one warp's upper scan levels, padded to 16 bytes
    (``deep_floats`` in the kernel)."""
    return -(-_scan_scratch(T) // 4) * 4


def _stored_bytes(T: int) -> int:
    """Shared memory of one CTA in the stored layout (``warp_floats``):
    for each warp, the upper levels and, for T > 1024, the level-0 cdf of
    its lines of every chunk but the last."""
    return WARPS * 4 * (level_floats(T) + (T - 1) // CHUNK * CHUNK)


def placement(T: int) -> str:
    """Where the kernel keeps a token's scan at ``T``: ``"registers"``
    (T <= 1024), ``"stored"`` (the earlier chunks' level-0 cdf and the
    upper levels in shared memory, T <= 7,168), else the deep layout,
    which forms each line twice and keeps only the upper levels, in
    ``"shared levels"`` (T <= 108,944) or ``"device levels"`` (a scratch
    the wrapper allocates)."""
    if T <= CHUNK:
        return "registers"
    if T <= 8 * CHUNK and _stored_bytes(T) <= SMEM_LIMIT_BYTES:
        return "stored"
    if WARPS * 4 * level_floats(T) <= SMEM_LIMIT_BYTES:
        return "shared levels"
    return "device levels"


def smem_bytes(T: int) -> int:
    """Shared memory of one CTA (``smem_for`` in the kernel)."""
    where = placement(T)
    if where in ("registers", "stored"):
        return _stored_bytes(T)
    return WARPS * 4 * level_floats(T) if where == "shared levels" else 0


def scratch_slots(N: int, T: int, dev) -> int:
    """Warps whose upper levels the device scratch holds: 0 unless the
    levels lie in device memory, else those of MIN_BLOCKS CTAs on every
    SM, or of as many CTAs as ``N`` tokens need at one a warp, whichever
    is fewer."""
    if placement(T) != "device levels":
        return 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return min(sms * MIN_BLOCKS, -(-N // WARPS)) * WARPS


def check_fits(T: int) -> None:
    """Raise ``ValueError`` for a ``T`` the kernel cannot run: below 1, or
    past :data:`MAX_TOPICS`."""
    if not 1 <= T <= MAX_TOPICS:
        raise ValueError(f"the lda_scores kernel takes 1 <= T <= "
                         f"{MAX_TOPICS} (its topic indices are int32); got "
                         f"T={T}")


def _launch(dev, n_td, n_wt, n_t, u, doc_row, wrd_row, nt_row, z_in, z_out,
            norm, N: int, T: int, alpha, beta, beta_bar) -> None:
    """Allocate the levels' scratch where they lie in device memory and
    launch; the ids of absent arguments are 0."""
    slots = scratch_slots(N, T, dev)
    levels = (torch.empty(slots * level_floats(T), dtype=torch.float32,
                          device=dev) if slots else None)
    _build.launch("lda_scores_launch", n_td, n_wt, n_t, u, doc_row, wrd_row,
                  nt_row, z_in, z_out, norm,
                  levels.data_ptr() if levels is not None else 0, slots, N,
                  T, float(alpha), float(beta), float(beta_bar),
                  smem_bytes(T), _stream(dev))


def _check(dev, named: dict, what: str) -> None:
    for name, (x, dtype, ndim) in named.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, {what} on {dev}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}; got {x.dtype}")
        if x.ndim != ndim or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-D tensor; "
                             f"got shape {tuple(x.shape)}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def lda_scores_cuda(n_td_rows, n_wt_rows, n_t, u01, *, alpha, beta,
                    beta_bar):
    """Rows form on the card: ``n_td_rows``/``n_wt_rows`` ``(n, T)``
    int32, ``n_t`` ``(T,)`` int32, ``u01`` ``(n,)`` f32 → ``z`` ``(n,)``
    int32 and ``norm`` ``(n,)`` f32."""
    dev = n_t.device
    if dev.type != "cuda":
        raise ValueError(f"lda_scores_cuda runs on a CUDA device; n_t is on "
                         f"{dev}")
    i32 = torch.int32
    _check(dev, {"n_td_rows": (n_td_rows, i32, 2),
                 "n_wt_rows": (n_wt_rows, i32, 2), "n_t": (n_t, i32, 1),
                 "u01": (u01, torch.float32, 1)}, "n_t")
    n, T = n_td_rows.shape
    if n_wt_rows.shape != (n, T) or n_t.shape != (T,) or u01.shape != (n,):
        raise ValueError(f"rows (n, T), n_t (T,) and u01 (n,) expected; got "
                         f"{tuple(n_td_rows.shape)}, "
                         f"{tuple(n_wt_rows.shape)}, {tuple(n_t.shape)}, "
                         f"{tuple(u01.shape)}")
    if not 1 <= n < 2**31:
        raise ValueError(f"the batch must hold 1 to 2**31 - 1 tokens; got "
                         f"{n}")
    check_fits(T)
    z = torch.empty(n, dtype=i32, device=dev)
    norm = torch.empty(n, dtype=torch.float32, device=dev)
    _launch(dev, n_td_rows.data_ptr(), n_wt_rows.data_ptr(),
            n_t.data_ptr(), u01.data_ptr(), 0, 0, 0, 0, z.data_ptr(),
            norm.data_ptr(), n, T, alpha, beta, beta_bar)
    launches["lda_scores"] += 1
    return z, norm


def lda_scores_pass_cuda(doc_row, wrd_row, nt_row, z, u, n_td, n_wt, n_t, *,
                         alpha, beta, beta_bar) -> torch.Tensor:
    """Pass form on the card; arguments and result as
    ``ref.lda_scores_pass_ref``: the new ``z`` ``(N,)`` int32, the tables
    unchanged."""
    dev = n_t.device
    if dev.type != "cuda":
        raise ValueError(f"lda_scores_pass_cuda runs on a CUDA device; n_t "
                         f"is on {dev}")
    i32 = torch.int32
    tok = {name: (x, i32, 1) for name, x in (
        ("doc_row", doc_row), ("wrd_row", wrd_row), ("nt_row", nt_row),
        ("z", z))}
    tok["u"] = (u, torch.float32, 1)
    tok.update(n_td=(n_td, i32, 2), n_wt=(n_wt, i32, 2), n_t=(n_t, i32, 2))
    _check(dev, tok, "n_t")
    N = z.shape[0]
    T = n_t.shape[1]
    for name in ("doc_row", "wrd_row", "nt_row", "u"):
        if tok[name][0].shape != (N,):
            raise ValueError(f"{name} {tuple(tok[name][0].shape)} must match "
                             f"z ({N},)")
    if n_td.shape[1] != T or n_wt.shape[1] != T:
        raise ValueError(f"n_td, n_wt and n_t must be (rows, T={T}); got "
                         f"{tuple(n_td.shape)}, {tuple(n_wt.shape)}")
    check_fits(T)
    out = torch.empty_like(z)
    if N:
        _launch(dev, n_td.data_ptr(), n_wt.data_ptr(), n_t.data_ptr(),
                u.data_ptr(), doc_row.data_ptr(), wrd_row.data_ptr(),
                nt_row.data_ptr(), z.data_ptr(), out.data_ptr(), 0, N, T,
                alpha, beta, beta_bar)
        launches["lda_scores_pass"] += 1
    return out
