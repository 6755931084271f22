"""AliasLDA baseline (Li, Ahmed, Ravi, Smola — paper §3.3), the port of
``repro/core/alias_lda.py``.

Decomposition (doc-by-doc):

    p_t = α·(n_wt+β)/(n_t+β̄) + n_td·(n_wt+β)/(n_t+β̄).

The first (dense word-proposal) term is drawn from a **stale** table per
word, built once a sweep from a snapshot of ``(n_wt, n_t)``; the second
(|T_d|-sparse) term fresh.  Because the proposal is stale, each draw is
corrected by ``num_mh`` Metropolis–Hastings steps, so the sampler is not
exact (paper Table 2, "Fresh samples: No").

The reference has no Pallas kernel here, so the port is plain PyTorch on
every device, one token after another as the reference's ``lax.scan``
(:func:`repro_torch.core.sparse_lda.token_loop`), in its float order
under ``jit`` (:func:`_alias_token`).
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.core.cgs import LDAState
from repro_torch.core.samplers import lsearch_guarded
from repro_torch.core.sparse_lda import host_index, token_loop
from repro_torch.kernels.fused_sweep.ref import U_MAX
from repro_torch.numerics import blocked_cumsum, fma

__all__ = ["sweep_alias_lda"]

#: The floor of the MH ratio's denominator, ``1e-30`` in f32.
RATIO_FLOOR = 1e-30


def _alias_token(n_td_row, n_wt_row, n_t, stale_q_row, stale_cdf_row,
                 stale_mass, u01, u_acc, u_pp, alpha, beta, beta_bar):
    """One token's draw from the post-decrement counts: ``(topic, ok)``,
    an int64 and a bool tensor of one element.  ``ok`` holds iff every MH
    step saw a finite ratio and an acceptance probability in (0, 1].

    XLA CPU contracts three sums into fused multiply-adds: the proposal's
    mass ``α·stale_mass + r_mass``, the q side's numerator ``u·prop_mass
    − r_mass``, and the proposal density ``α·stale_q[t] + r_vec[t]`` (with
    ``r_vec`` rounded, as the cumsum reads it).  ``α·stale_mass`` as the
    divisor and every other product are rounded first.
    """
    denom = n_t.to(torch.float32) + beta_bar
    q_vec = (n_wt_row.to(torch.float32) + beta) / denom
    n_d = n_td_row.to(torch.float32)
    r_vec = n_d * q_vec
    r_cdf = blocked_cumsum(r_vec)
    r_mass = r_cdf[-1]
    a_mass = alpha * stale_mass
    prop_mass = fma(alpha, stale_mass, r_mass)
    cdfs = torch.stack([r_cdf, stale_cdf_row])

    def propose(uu):
        uval = uu * prop_mass
        u_q = (fma(uu, prop_mass, -r_mass) / a_mass).clamp(0.0, U_MAX) \
            * stale_mass
        t = lsearch_guarded(cdfs, torch.stack([uval, u_q]))
        return torch.where(uval < r_mass, t[0], t[1]).reshape(1)

    def p_true(t):
        return (n_d.gather(0, t) + alpha) * q_vec.gather(0, t)

    def prop_density(t):
        return fma(alpha, stale_q_row.gather(0, t), r_vec.gather(0, t))

    t_cur = propose(u01)
    ok = torch.ones(1, dtype=torch.bool, device=n_t.device)
    for i in range(u_acc.shape[0]):
        t_prop = propose(u_pp[i])
        ratio = (p_true(t_prop) * prop_density(t_cur)) / (
            p_true(t_cur) * prop_density(t_prop)).clamp(min=RATIO_FLOOR)
        acc = torch.minimum(ratio, torch.ones_like(ratio))
        ok = ok & torch.isfinite(ratio) & (acc > 0.0) & (acc <= 1.0)
        t_cur = torch.where(u_acc[i] < acc, t_prop, t_cur)
    return t_cur, ok


def sweep_alias_lda(state: LDAState, doc_ids, word_ids, order,
                    alpha: float, beta: float, num_mh: int = 2,
                    return_mh_stats: bool = False):
    """One AliasLDA sweep over the tokens in ``order`` with ``num_mh`` MH
    steps a token.  Returns the next state (the given one is not changed)
    and, with ``return_mh_stats``, a bool per token in sweep order: True
    iff every MH step of that token had a finite ratio and an acceptance
    probability in (0, 1].

    The stale proposal for word w is ``q̃_t ∝ (ñ_wt+β)/(ñ_t+β̄)`` from the
    counts at the sweep's start, drawn by guarded inverse CDF over its
    blocked cumsum.  The key splits in four, as the reference's; the
    uniforms are ``u_r`` ``(N,)``, ``u_mh`` and ``u_prop`` ``(N,
    num_mh)``, so from the same state both packages run the same chain
    bit for bit."""
    dev = state.z.device
    f32 = lambda x: torch.tensor(float(x), dtype=torch.float32, device=dev)
    a, b = f32(alpha), f32(beta)
    bb = f32(beta * state.n_wt.shape[0])
    key, k1, k2, k3 = rng.split(state.key, 4).unbind(-2)
    N = host_index(order).size
    stale_q = (state.n_wt.to(torch.float32) + b) / (
        state.n_t.to(torch.float32) + bb)                       # (J, T)
    stale_cdf = blocked_cumsum(stale_q, dim=1)                   # (J, T)
    stale_mass = stale_cdf[:, -1]                                # (J,)
    u_r = rng.uniform(k1, (N,))
    u_mh = rng.uniform(k2, (N, num_mh))
    u_prop = rng.uniform(k3, (N, num_mh))

    def draw(i, w, n_td_row, n_wt_row, n_t):
        return _alias_token(n_td_row, n_wt_row, n_t, stale_q[w],
                            stale_cdf[w], stale_mass[w], u_r[i], u_mh[i],
                            u_prop[i], a, b, bb)

    new, mh_ok = token_loop(state, doc_ids, word_ids, order, key, draw,
                            torch.bool)
    if return_mh_stats:
        return new, mh_ok
    return new
