"""Collapsed Gibbs sampling for LDA (paper §2.1, §3.2), the port of
``repro/core/cgs.py``: the serial state, the word-by-word F+LDA sweep
(Algorithm 3) and its doc-by-doc twin (decomposition (4)).

State layout (the paper's count tables, eq. (1)), all on one device:

    z     (N,)   int32  current topic assignment per occurrence
    n_td  (I,T)  int32  doc-topic counts
    n_wt  (J,T)  int32  word-topic counts
    n_t   (T,)   int32  global topic counts
    key   (2,)   int64  the chain's threefry key (``repro_torch.rng``)

:func:`sweep_reference` is the dense oracle every other sweep is tested
against: per token the whole conditional (:func:`conditional_probs`, the
``lda_scores`` kernel's, in its float order) and an inverse-CDF draw over
its blocked-16 cumsum.  It and :func:`sweep_fplda_word` draw their
uniforms from the chain key exactly as the reference does, so from the
same state both packages run the same chain bit for bit.
``backend="scan"`` runs the plain version (``kernels/fused_sweep/ref.py``)
on any device; ``backend="fused"`` the CUDA kernel on the card, and the
plain version on the CPU.

:func:`sweep_fplda_doc` is the doc-by-doc F+LDA sweep: ``β·q`` with
``q_t = (n_td + α)/(n_t + β̄)`` in the F+tree, ``r_t = n_wt·q_t`` drawn
from its cumsum.  The reference has no Pallas kernel for it, so the port
is plain PyTorch on every device, one token after another, in the
reference's float order under ``jit`` (:func:`_doc_draw`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch._device import resolve
from repro_torch.core import ftree
from repro_torch.data.corpus import Corpus
from repro_torch.kernels.fused_sweep.ref import U_MAX
from repro_torch.kernels.lda_scores.ref import conditional, inverse_cdf_draw
from repro_torch.numerics import blocked_cumsum, fma

__all__ = ["LDAState", "init_state", "counts_from_assignments",
           "state_to_checkpoint", "state_from_checkpoint",
           "check_invariants", "conditional_probs", "sweep_reference",
           "sweep_fplda_word", "sweep_fplda_doc"]


class LDAState(NamedTuple):
    z: torch.Tensor       # (N,)  int32
    n_td: torch.Tensor    # (I,T) int32
    n_wt: torch.Tensor    # (J,T) int32
    n_t: torch.Tensor     # (T,)  int32
    key: torch.Tensor     # (2,)  threefry key of the chain


def counts_from_assignments(doc_ids, word_ids, z, I, J, T):
    """Rebuild the three count tables from ``z`` (Θ(N) scatter-adds)."""
    z = z.long()
    d, w = doc_ids.long(), word_ids.long()
    one = torch.ones_like(z, dtype=torch.int32)
    n_td = torch.zeros((I, T), dtype=torch.int32, device=z.device)
    n_wt = torch.zeros((J, T), dtype=torch.int32, device=z.device)
    n_t = torch.zeros((T,), dtype=torch.int32, device=z.device)
    n_td.index_put_((d, z), one, accumulate=True)
    n_wt.index_put_((w, z), one, accumulate=True)
    n_t.index_put_((z,), one, accumulate=True)
    return n_td, n_wt, n_t


def init_state(corpus: Corpus, T: int, key: torch.Tensor) -> LDAState:
    """Random uniform topic init, drawn as the reference draws it: split
    the key, then ``randint`` over the tokens.  The state lives on the
    key's device."""
    key, sub = rng.split(key).unbind(-2)
    z = rng.randint(sub, T, (corpus.num_tokens,))
    dev = key.device
    n_td, n_wt, n_t = counts_from_assignments(
        torch.as_tensor(corpus.doc_ids, device=dev),
        torch.as_tensor(corpus.word_ids, device=dev), z,
        corpus.num_docs, corpus.num_words, T)
    return LDAState(z=z, n_td=n_td, n_wt=n_wt, n_t=n_t, key=key)


def state_to_checkpoint(state: LDAState) -> dict[str, np.ndarray]:
    """Flatten a serial chain state for :func:`repro_torch.train.checkpoint.
    save_chain`, as the reference does: int32 tables and the key as the
    uint32 words of ``jax.random.key_data``, so a chain checkpointed by
    either package resumes in the other bit for bit."""
    out = {k: getattr(state, k).cpu().numpy().astype(np.int32)
           for k in ("z", "n_td", "n_wt", "n_t")}
    out["key_data"] = rng.key_data(state.key)
    return out


def state_from_checkpoint(d: dict[str, np.ndarray],
                          device=None) -> LDAState:
    """Inverse of :func:`state_to_checkpoint`, on ``device`` (``None``
    means CUDA)."""
    dev = resolve(device)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    return LDAState(z=i32(d["z"]), n_td=i32(d["n_td"]), n_wt=i32(d["n_wt"]),
                    n_t=i32(d["n_t"]),
                    key=rng.wrap_key_data(d["key_data"], dev))


def check_invariants(state: LDAState, corpus: Corpus) -> dict:
    """Count-table consistency: violation counts, all 0 for a sound state."""
    I, T = state.n_td.shape
    J = state.n_wt.shape[0]
    dev = state.z.device
    n_td, n_wt, n_t = counts_from_assignments(
        torch.as_tensor(corpus.doc_ids, device=dev),
        torch.as_tensor(corpus.word_ids, device=dev), state.z, I, J, T)
    return {
        "n_td_mismatch": int((n_td - state.n_td).abs().sum()),
        "n_wt_mismatch": int((n_wt - state.n_wt).abs().sum()),
        "n_t_mismatch": int((n_t - state.n_t).abs().sum()),
        "negatives": int((state.n_td < 0).sum() + (state.n_wt < 0).sum()
                         + (state.n_t < 0).sum()),
        "z_range": int(((state.z < 0) | (state.z >= T)).sum()),
    }


def conditional_probs(n_td_row, n_wt_row, n_t, alpha, beta, beta_bar):
    """Unnormalized CGS conditional p_t (paper eq. (2)/(4)), in f32."""
    return conditional(n_td_row, n_wt_row, n_t, alpha, beta, beta_bar)


def _inverse_cdf_draw(p: torch.Tensor, u01) -> torch.Tensor:
    """``#{t : cumsum(p)_t ≤ u01·Σp}``, the cumsum in the blocked-16
    order; unclipped, as the reference's."""
    return inverse_cdf_draw(p, torch.as_tensor(u01))[0]


def sweep_reference(state: LDAState, doc_ids, word_ids, order,
                    alpha: float, beta: float) -> LDAState:
    """One full Gibbs sweep over ``order`` with the dense conditional, the
    exact chain one token after another (Θ(N·T)).  Returns the next state;
    the given one is not changed.  A draw can only reach ``T`` if ``u01``
    rounds ``u01·Σp`` up to ``Σp``; the reference then stores it in ``z``
    and drops its count updates (jnp scatters skip out-of-range indices),
    and so does this."""
    T = state.n_t.shape[0]
    beta_bar = beta * state.n_wt.shape[0]
    key, sweep_key = rng.split(state.key).unbind(-2)
    order = np.asarray(order).reshape(-1)
    u = rng.uniform(sweep_key, (order.shape[0],))
    doc_ids, word_ids = np.asarray(doc_ids), np.asarray(word_ids)
    z, n_td, n_wt, n_t = (x.clone() for x in state[:4])
    for k, u01 in zip(order.tolist(), u.unbind(0)):
        d, w, t_old = int(doc_ids[k]), int(word_ids[k]), int(z[k])
        if 0 <= t_old < T:
            n_td[d, t_old] -= 1
            n_wt[w, t_old] -= 1
            n_t[t_old] -= 1
        p = conditional_probs(n_td[d], n_wt[w], n_t, alpha, beta, beta_bar)
        t_new = int(_inverse_cdf_draw(p, u01))
        if t_new < T:
            n_td[d, t_new] += 1
            n_wt[w, t_new] += 1
            n_t[t_new] += 1
        z[k] = t_new
    return LDAState(z=z, n_td=n_td, n_wt=n_wt, n_t=n_t, key=key)


def sweep_fplda_word(state: LDAState, doc_ids, word_ids, order, boundary,
                     alpha: float, beta: float, *, backend: str = "scan",
                     r_mode: str = "dense",
                     r_cap: int | None = None) -> LDAState:
    """Paper Algorithm 3 over the tokens in ``order`` (sorted by word;
    ``boundary[k]`` marks the first occurrence of a new word).  Returns
    the next state; the given one is not changed.

    ``backend``: ``"scan"`` is the plain version of the per-token chain,
    ``"fused"`` the fused-sweep op (the CUDA kernel on the card).  Both
    run the same chain bit for bit.  ``r_mode``/``r_cap`` as in
    ``kernels/fused_sweep/rbucket.py``; the sparse side tables are built
    from ``n_td`` per call and dropped.
    """
    from repro_torch.kernels.fused_sweep.ops import fused_sweep_tokens
    from repro_torch.kernels.fused_sweep.ref import fused_sweep_ref
    T = state.n_t.shape[0]
    if T & (T - 1):
        raise ValueError("T must be a power of two for the F+tree sweep")
    if backend not in ("scan", "fused"):
        raise ValueError(f"unknown backend {backend!r}")
    sweep = fused_sweep_tokens if backend == "fused" else fused_sweep_ref
    dev = state.z.device
    beta_bar = beta * state.n_wt.shape[0]
    key, sweep_key = rng.split(state.key).unbind(-2)
    order = torch.as_tensor(np.asarray(order), device=dev).long()
    u = rng.uniform(sweep_key, (order.shape[0],))
    valid = torch.ones(order.shape[0], dtype=torch.int32, device=dev)
    bound = torch.as_tensor(np.asarray(boundary), device=dev).to(torch.int32)
    bound[0] = 1
    doc_ids = torch.as_tensor(np.asarray(doc_ids), device=dev)
    word_ids = torch.as_tensor(np.asarray(word_ids), device=dev)
    out = sweep(doc_ids[order], word_ids[order], valid, bound,
                state.z[order], u, state.n_td, state.n_wt, state.n_t,
                alpha=alpha, beta=beta, beta_bar=beta_bar, r_mode=r_mode,
                r_cap=r_cap)
    z = state.z.clone()
    z[order] = out[0].to(z.dtype)
    return LDAState(z=z, n_td=out[1], n_wt=out[2], n_t=out[3], key=key)


def _doc_draw(F: torch.Tensor, c: torch.Tensor, u01: torch.Tensor,
              beta: torch.Tensor) -> torch.Tensor:
    """The doc-by-doc draw from ``β·q + r``: ``F`` the q tree, ``c`` the
    blocked cumsum of ``r``, all f32; int64 topic.

    XLA CPU forms ``norm = β·F[1] + r_mass`` in two fusions, as it does
    the word-by-word sweep's: the r side (``u_scaled``, which ``in_r`` and
    the r pick read) contracts it, ``fma(β, F[1], r_mass)``; the q side
    rounds it as written and contracts ``u01·norm − r_mass`` into the
    numerator.  ``β·F[1]`` as the divisor is rounded first, and the
    clip's upper end is ``1 − 1e-7`` in f32.
    """
    r_mass = c[-1]
    bq = beta * F[1]
    u_scaled = u01 * fma(beta, F[1], r_mass)
    t_r = (c <= u_scaled).sum()
    x = fma(u01, bq + r_mass, -r_mass) / bq
    t_q = ftree.sample(F, x.clamp(0.0, U_MAX))
    return torch.where(u_scaled < r_mass, t_r, t_q)


def sweep_fplda_doc(state: LDAState, doc_ids, word_ids, order, boundary,
                    alpha: float, beta: float) -> LDAState:
    """Doc-by-doc F+LDA (decomposition (4)) over the tokens in ``order``
    (sorted by document; ``boundary[k]`` marks a document's first token):
    ``p_t = β·q_t + r_t``, ``q_t = (n_td + α)/(n_t + β̄)`` kept in the
    F+tree and rebuilt at each document, ``r_t = n_wt·q_t`` drawn from its
    cumsum.  Returns the next state; the given one is not changed.  The
    uniforms come from the chain key as the reference draws them, so
    from the same state both packages run the same chain bit for bit."""
    dev = state.z.device
    f32 = lambda x: torch.tensor(float(x), dtype=torch.float32, device=dev)
    a, b = f32(alpha), f32(beta)
    bb = f32(beta * state.n_wt.shape[0])
    key, sweep_key = rng.split(state.key).unbind(-2)
    order = np.asarray(order).reshape(-1)
    u = rng.uniform(sweep_key, (order.shape[0],))
    docs = np.asarray(doc_ids)[order].tolist()
    words = np.asarray(word_ids)[order].tolist()
    bound = np.asarray(boundary).reshape(-1).tolist()
    z, n_td, n_wt, n_t = (x.clone() for x in state[:4])
    q = lambda d, t: (n_td[d, t].to(torch.float32) + a) / (
        n_t[t].to(torch.float32) + bb)
    F = ftree.build(q(docs[0], slice(None)))
    for i, k in enumerate(order.tolist()):
        d, w = docs[i], words[i]
        if bound[i]:
            F = ftree.build(q(d, slice(None)))
        t_old = z[k].long()
        n_td[d, t_old] -= 1
        n_wt[w, t_old] -= 1
        n_t[t_old] -= 1
        F = ftree.set_leaf(F, t_old, q(d, t_old))
        c = blocked_cumsum(n_wt[w].to(torch.float32) * ftree.leaves(F))
        t_new = _doc_draw(F, c, u[i], b)
        n_td[d, t_new] += 1
        n_wt[w, t_new] += 1
        n_t[t_new] += 1
        F = ftree.set_leaf(F, t_new, q(d, t_new))
        z[k] = t_new.to(z.dtype)
    return LDAState(z=z, n_td=n_td, n_wt=n_wt, n_t=n_t, key=key)
