"""SparseLDA baseline (Yao, Mimno, McCallum — paper §3.3), the port of
``repro/core/sparse_lda.py``.

Three-term decomposition of the CGS conditional, doc-by-doc order:

    p_t = αβ/(n_t+β̄)  +  β·n_td/(n_t+β̄)  +  n_wt·(n_td+α)/(n_t+β̄)
          └─ smoothing ─┘  └─ doc-sparse ──┘  └──── word-sparse ─────┘

LSearch in each bucket: draw u ~ U[0, s+r+q_mass); the word bucket is
checked first, then the doc bucket, then the dense smoothing term.

The reference has no Pallas kernel here, so the port is plain PyTorch on
every device, one token after another as the reference's ``lax.scan``
(:func:`token_loop`, which AliasLDA shares), in its float order under
``jit`` (:func:`_sparse_draw`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.cgs import LDAState
from repro_torch.core.samplers import lsearch_guarded
from repro_torch.numerics import blocked_cumsum, fma, xla_sum

__all__ = ["host_index", "sweep_sparse_lda", "token_loop"]


def host_index(x) -> np.ndarray:
    """An index array on the host (numpy, or a tensor on any device)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def token_loop(state: LDAState, doc_ids, word_ids, order, key, draw,
               stat_dtype: torch.dtype):
    """The baselines' sweep, one token after another in ``order``: take
    the token's topic out of the counts, ``draw(i, w, n_td_row, n_wt_row,
    n_t)`` its new topic and a stat (tensors of one element) for the
    ``i``-th token of the sweep, of word ``w``, and put the topic back.

    Returns the next state with ``key`` (the given one is not changed)
    and the stats in sweep order.  The documents and words are read on
    the host; topics and counts stay on the device (one-element
    scatters), so nothing syncs with the host within the sweep."""
    dev = state.z.device
    order = host_index(order).reshape(-1)
    docs = host_index(doc_ids)[order].tolist()
    words = host_index(word_ids)[order].tolist()
    z, n_td, n_wt, n_t = (x.clone() for x in state[:4])
    stats = torch.empty(order.shape[0], dtype=stat_dtype, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    for i, (k, d, w) in enumerate(zip(order.tolist(), docs, words)):
        t_old = z[k:k + 1].long()
        for row in (n_td[d], n_wt[w], n_t):
            row.index_add_(0, t_old, -one)
        t_new, stat = draw(i, w, n_td[d], n_wt[w], n_t)
        for row in (n_td[d], n_wt[w], n_t):
            row.index_add_(0, t_new, one)
        z[k:k + 1] = t_new
        stats[i:i + 1] = stat
    return LDAState(z=z, n_td=n_td, n_wt=n_wt, n_t=n_t, key=key), stats


def _sparse_draw(n_td_row, n_wt_row, n_t, u01, alpha, beta, alpha_beta,
                 beta_bar):
    """One SparseLDA draw from the post-decrement counts: ``(topic,
    bucket)`` as int64 tensors of one element (bucket 0 = smoothing, 1 =
    doc, 2 = word).  The scalars are f32 tensors; ``alpha_beta`` is the
    f64 product ``α·β`` rounded once.

    The three masses are XLA's row sums (:func:`xla_sum`), the walks
    guarded LSearches over blocked cumsums.  XLA CPU contracts
    ``u01·norm − q_mass`` into one fused multiply-add where it is the doc
    bucket's ``u`` and the first term of the smoothing bucket's; the word
    bucket and the dispatch read ``u01·norm`` rounded.
    """
    denom = n_t.to(torch.float32) + beta_bar
    n_d = n_td_row.to(torch.float32)
    vecs = torch.stack([alpha_beta / denom, beta * n_d / denom,
                        n_wt_row.to(torch.float32) * (n_d + alpha) / denom])
    s_mass, r_mass, q_mass = xla_sum(vecs).unbind(0)
    norm = s_mass + r_mass + q_mass
    u_val = u01 * norm
    in_q = u_val < q_mass
    in_r = ~in_q & (u_val < q_mass + r_mass)
    u_r = fma(u01, norm, -q_mass)
    t = lsearch_guarded(blocked_cumsum(vecs),
                        torch.stack([u_r - r_mass, u_r, u_val]))
    pick = torch.where(in_q, 2, torch.where(in_r, 1, 0)).reshape(1)
    return t.gather(0, pick), pick


def sweep_sparse_lda(state: LDAState, doc_ids, word_ids, order,
                     alpha: float, beta: float,
                     return_bucket_stats: bool = False):
    """One exact doc-by-doc SparseLDA sweep over the tokens in ``order``.
    Returns the next state (the given one is not changed) and, with
    ``return_bucket_stats``, each token's bucket in sweep order (int32;
    0 = smoothing, 1 = doc, 2 = word).  The uniforms come from the chain
    key as the reference draws them, so from the same state both packages
    run the same chain bit for bit."""
    dev = state.z.device
    f32 = lambda x: torch.tensor(float(x), dtype=torch.float32, device=dev)
    a, b = f32(alpha), f32(beta)
    ab, bb = f32(alpha * beta), f32(beta * state.n_wt.shape[0])
    key, sweep_key = rng.split(state.key).unbind(-2)
    u = rng.uniform(sweep_key, (host_index(order).size,))
    new, buckets = token_loop(
        state, doc_ids, word_ids, order, key,
        lambda i, w, n_td_row, n_wt_row, n_t: _sparse_draw(
            n_td_row, n_wt_row, n_t, u[i], a, b, ab, bb),
        torch.int32)
    if return_bucket_stats:
        return new, buckets
    return new
