"""Plain PyTorch version of the ``lda_scores`` kernel, the port of
``repro/kernels/lda_scores/ref.py``: the CGS conditional (paper eq. (2))

    p_t = (n_td + α)(n_wt + β) / (n_t + β̄)

over T, its cumsum in XLA CPU's blocked-16 order
(``numerics.blocked_cumsum``), ``norm = c[T-1]`` and the inverse-CDF
draw ``#{t : c_t ≤ u01·norm}``.  Each op rounds to f32 where the
reference rounds it; there is no multiply-add to contract.

Two forms share :func:`conditional` and :func:`inverse_cdf_draw`, as do
``core/cgs.py``'s dense oracle and the CUDA kernel's two forms:

* :func:`lda_scores_draw_ref`, the *rows form*: gathered ``(n, T)`` count
  rows against one shared ``n_t``; ``(z, norm)``, as ``lda_scores_pallas``.
* :func:`lda_scores_pass_ref`, the *pass form*: the draw of the
  vectorized nomad pass (``repro/core/nomad.py:_vectorized_pass``) for the
  tokens it is given, the masked-in tokens of one cell.  Each token names
  its rows in flat ``n_td``/``n_wt``/``n_t`` tables, its own count is
  excluded from all three rows (one-hot of its ``z``), and the draw is
  clipped to ``[0, T-1]``.
"""
from __future__ import annotations

import torch

from repro_torch.numerics import blocked_cumsum

__all__ = ["conditional", "inverse_cdf_draw", "lda_scores_draw_ref",
           "lda_scores_pass_ref"]

F32 = torch.float32


def conditional(n_td, n_wt, n_t, alpha, beta, beta_bar) -> torch.Tensor:
    """``(n_td + α)(n_wt + β) / (n_t + β̄)`` in f32, broadcast over rows."""
    return ((n_td.to(F32) + alpha) * (n_wt.to(F32) + beta)
            / (n_t.to(F32) + beta_bar))


def inverse_cdf_draw(p: torch.Tensor, u01: torch.Tensor):
    """``(#{c ≤ u01·c[T-1]}, c[T-1])`` along the last dim of ``p``, with
    ``c`` its blocked-16 cumsum: int32 draws and the f32 norm."""
    c = blocked_cumsum(p)
    norm = c[..., -1]
    z = (c <= (u01 * norm).unsqueeze(-1)).sum(-1, dtype=torch.int32)
    return z, norm


def lda_scores_draw_ref(n_td_rows, n_wt_rows, n_t, u01, *, alpha, beta,
                        beta_bar):
    """Rows form: ``n_td_rows``/``n_wt_rows`` ``(n, T)`` int, ``n_t``
    ``(T,)``, ``u01`` ``(n,)`` f32 → ``z`` ``(n,)`` int32, ``norm`` ``(n,)``
    f32."""
    p = conditional(n_td_rows, n_wt_rows, n_t.unsqueeze(0), alpha, beta,
                    beta_bar)
    return inverse_cdf_draw(p, u01.to(F32))


def lda_scores_pass_ref(doc_row, wrd_row, nt_row, z, u, n_td, n_wt, n_t, *,
                        alpha, beta, beta_bar) -> torch.Tensor:
    """Pass form: one delayed-count draw per token.

    ``doc_row``/``wrd_row``/``nt_row``/``z`` ``(N,)`` int32 and ``u``
    ``(N,)`` f32; ``n_td``, ``n_wt``, ``n_t`` 2-D int32 tables (``(R,
    T)``).  Returns the new ``z`` ``(N,)`` int32; the tables are not
    changed (the caller applies the deltas)."""
    T = n_t.shape[-1]
    own = torch.nn.functional.one_hot(z.long(), T).to(torch.int32)
    p = conditional(n_td[doc_row.long()] - own, n_wt[wrd_row.long()] - own,
                    n_t[nt_row.long()] - own, alpha, beta, beta_bar)
    draw, _ = inverse_cdf_draw(p, u.to(F32))
    return draw.clamp(0, T - 1)
