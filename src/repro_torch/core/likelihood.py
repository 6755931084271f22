"""Training log-likelihood (paper §5), the port of
``repro/core/likelihood.py``: the collapsed joint likelihood of a CGS
state (Griffiths & Steyvers),

    log p(w, z | α, β) =
        Σ_i [ logΓ(Tα) − logΓ(Tα + n_i)  + Σ_t ( logΓ(α + n_td) − logΓ(α) ) ]
      + Σ_t [ logΓ(Jβ) − logΓ(Jβ + n_t) + Σ_w ( logΓ(β + n_wt) − logΓ(β) ) ]

from the count tables.  ``gammaln`` becomes ``torch.lgamma``, each term in
f32 as the reference rounds its arguments; the sums are taken in f64.
The reference sums in f32 in XLA's order, so the two agree to a relative
tolerance (``tests/test_torch_cgs.py`` states it), not bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["log_likelihood", "per_token_ll", "lgamma_sum"]

F32, F64 = torch.float32, torch.float64


def lgamma_sum(x: torch.Tensor, mask=None) -> float:
    """``Σ lgamma(x)`` of an f32 tensor, each term in f32, summed in f64
    (over ``mask`` where given)."""
    g = torch.lgamma(x.to(F32)).to(F64)
    if mask is not None:
        g = torch.where(mask, g, 0.0)
    return float(g.sum())


def _lg(x: float) -> float:
    """``gammaln`` of a Python float as the reference takes it: the
    argument rounded to f32, the result an f32."""
    return float(torch.lgamma(torch.tensor(x, dtype=F32)))


def log_likelihood(state, alpha: float, beta: float) -> float:
    """Joint log p(w, z) of a :class:`repro_torch.core.cgs.LDAState`."""
    n_td, n_wt, n_t = state.n_td, state.n_wt, state.n_t
    I, T = n_td.shape
    J = n_wt.shape[0]
    a = float(torch.tensor(alpha, dtype=F32))
    b = float(torch.tensor(beta, dtype=F32))
    n_i = n_td.to(F32).sum(1)
    doc = (I * (_lg(T * a) - T * _lg(a)) - lgamma_sum(T * a + n_i)
           + lgamma_sum(a + n_td.to(F32)))
    topic = (T * (_lg(J * b) - J * _lg(b)) - lgamma_sum(J * b + n_t.to(F32))
             + lgamma_sum(b + n_wt.to(F32)))
    return doc + topic


def per_token_ll(state, alpha: float, beta: float) -> float:
    n_tokens = int(state.n_t.sum())
    return log_likelihood(state, alpha, beta) / max(n_tokens, 1)
