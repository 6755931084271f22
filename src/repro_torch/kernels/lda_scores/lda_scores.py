"""Launch wrapper of the CUDA ``lda_scores`` kernel
(``csrc/lda_scores.cu``), the port of the Pallas kernel
``repro/kernels/lda_scores/lda_scores.py:lda_scores_pallas``.

:func:`lda_scores_cuda` (the rows form) and :func:`lda_scores_pass_cuda`
(the pass form of the vectorized nomad pass) take the arguments of their
plain versions in ``ref.py``, check what the kernel takes and raise on
anything else, allocate the outputs, launch on PyTorch's current stream
and count the launch in :data:`launches`.  They never fall back to the
plain version: ``ops.py`` picks the plain version for CPU tensors.  The
batch needs no padding: the TPU kernel's 256-token tile is the TPU's, and
the CUDA kernel masks its own ragged edge.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.numerics import SCAN_BLOCK

__all__ = ["lda_scores_cuda", "lda_scores_pass_cuda", "smem_bytes",
           "check_fits", "SMEM_LIMIT_BYTES", "WARPS", "launches"]

#: Dynamic shared memory one block may use on Hopper (sm_90).
SMEM_LIMIT_BYTES = 232_448
#: Warps a CTA, one token each at a time (``kWarps``).
WARPS = 8

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


def smem_bytes(T: int) -> int:
    """Shared memory of one CTA: for each warp, the f32 row of T (one pad
    word per 16) and the upper scan levels."""
    return WARPS * 4 * (T + -(-T // SCAN_BLOCK) + _scan_scratch(T))


def check_fits(T: int) -> None:
    """Raise ``ValueError`` for a ``T`` the kernel cannot run."""
    if T < 1 or smem_bytes(T) > SMEM_LIMIT_BYTES:
        raise ValueError(f"the lda_scores kernel's rows for T={T} "
                         f"({smem_bytes(T)} B) exceed the {SMEM_LIMIT_BYTES} "
                         f"B of shared memory a block may use")


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
    _build.launch("lda_scores_launch", n_td_rows.data_ptr(),
                  n_wt_rows.data_ptr(), n_t.data_ptr(), u01.data_ptr(), 0, 0,
                  0, 0, z.data_ptr(), norm.data_ptr(), n, T, float(alpha),
                  float(beta), float(beta_bar), smem_bytes(T), _stream(dev))
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
        _build.launch("lda_scores_launch", n_td.data_ptr(), n_wt.data_ptr(),
                      n_t.data_ptr(), u.data_ptr(), doc_row.data_ptr(),
                      wrd_row.data_ptr(), nt_row.data_ptr(), z.data_ptr(),
                      out.data_ptr(), 0, N, T, float(alpha), float(beta),
                      float(beta_bar), smem_bytes(T), _stream(dev))
        launches["lda_scores_pass"] += 1
    return out
