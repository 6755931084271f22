"""Public ``lda_scores`` ops: the device dispatch between the CUDA kernel
and its plain version, and the vectorized nomad pass built on it.

:func:`lda_scores_draw` keeps the reference's signature
(``repro/kernels/lda_scores/ops.py``).  :func:`lda_scores_pass` is the
pass form, and :func:`vectorized_pass` the whole delayed-count pass of
``repro/core/nomad.py:_vectorized_pass`` over the tokens it is given (the
reference's masked-in tokens): the draws, then the exact integer deltas
applied to the tables in place.  On CUDA tensors the ops
launch the kernel (or raise); on CPU tensors they run the plain version.
There is no padding to the TPU's 256-token tile.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.lda_scores.lda_scores import (lda_scores_cuda,
                                                       lda_scores_pass_cuda)
from repro_torch.kernels.lda_scores.ref import (lda_scores_draw_ref,
                                                lda_scores_pass_ref)

__all__ = ["lda_scores_draw", "lda_scores_pass", "apply_deltas",
           "vectorized_pass"]


def lda_scores_draw(n_td_rows, n_wt_rows, n_t, u01, *, alpha: float,
                    beta: float, beta_bar: float):
    """``(z, norm)`` for a batch of tokens: ``n_td_rows``/``n_wt_rows``
    ``(n, T)``, ``n_t`` ``(T,)``, ``u01`` ``(n,)``; any ``n``."""
    kw = dict(alpha=float(alpha), beta=float(beta), beta_bar=float(beta_bar))
    if n_t.device.type == "cuda":
        return lda_scores_cuda(
            n_td_rows.to(torch.int32).contiguous(),
            n_wt_rows.to(torch.int32).contiguous(),
            n_t.to(torch.int32).contiguous(),
            u01.to(torch.float32).contiguous(), **kw)
    return lda_scores_draw_ref(n_td_rows, n_wt_rows, n_t, u01, **kw)


def lda_scores_pass(*args, **kw) -> torch.Tensor:
    """The pass form's draws (the new ``z``); arguments as
    ``ref.lda_scores_pass_ref``."""
    if args[7].device.type == "cuda":
        return lda_scores_pass_cuda(*args, **kw)
    return lda_scores_pass_ref(*args, **kw)


def apply_deltas(z, z_new, rows, tables) -> None:
    """``table[row, z] -= 1`` and ``table[row, z_new] += 1`` for each token
    whose topic changed, for each ``(row, table)`` pair, in place.  Integer
    adds, so the result is exact in any order.  Every token's row and
    topics must lie in its table: a token that kept its topic adds 0 to
    its own entries, which spreads the adds over the table (sending them
    all to one entry would serialise the atomics on the card)."""
    one = (z_new != z).to(torch.int32)
    vals = torch.cat([-one, one])
    zz = torch.cat([z, z_new]).long()
    for row, table in zip(rows, tables):
        idx = row.long().repeat(2) * table.shape[-1] + zz
        table.view(-1).index_add_(0, idx, vals)


def vectorized_pass(doc_row, wrd_row, nt_row, z, u, n_td, n_wt, n_t, *,
                    alpha, beta, beta_bar) -> torch.Tensor:
    """One delayed-count pass over the given tokens (one cell's): every
    token is drawn against the tables as they are on entry, minus its own
    count, then the deltas go to ``n_td``, ``n_wt`` and ``n_t`` in place.
    Returns the new ``z``."""
    z_new = lda_scores_pass(doc_row, wrd_row, nt_row, z, u, n_td, n_wt, n_t,
                            alpha=alpha, beta=beta, beta_bar=beta_bar)
    apply_deltas(z, z_new, (doc_row, wrd_row, nt_row), (n_td, n_wt, n_t))
    return z_new
