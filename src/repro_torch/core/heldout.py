"""Fold-in inference with φ frozen: the serving algorithm
(``repro/core/heldout.py``), as plain PyTorch.

An incoming document's θ is a Gibbs fold-in against a published φ
snapshot.  Two implementations share one chain:

* :func:`fold_in` — the serial reference: a flat ``(word_ids, doc_ids)``
  token list, swept one token at a time.
* :func:`fold_in_batch` — the padded ``(D, L)`` batch the serving engine
  packs requests into, every row swept in lock step.

RNG contract (what makes them bit-equal per document, and bit-equal to
the reference): document ``d``'s stream is ``doc_fold_key(key, d)``;
position ``p``'s initial topic is ``randint(fold_in(fold_in(dk, 0), p),
T)`` and its sweep-``k`` uniform is ``uniform(fold_in(fold_in(fold_in(dk,
1), k), p))``.  A row's chain depends only on its own key and tokens, so
padding and batch neighbours cannot move it.

Float ops follow the reference's rounding: ``(n_td + α)·φ[w]`` is rounded
before the cumsum, which is taken in XLA CPU's blocked-16 order
(:func:`repro_torch.numerics.blocked_cumsum`).  ``document_completion_
perplexity`` waits for the port of ``data/corpus.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.samplers import lsearch_guarded
from repro_torch.numerics import blocked_cumsum

__all__ = ["fold_in", "fold_in_batch", "doc_fold_key", "theta_from_counts"]

# Role indices of the two per-document RNG sub-streams.
_ROLE_INIT = 0    # initial z assignments
_ROLE_SWEEP = 1   # per-sweep LSearch uniforms


def _phi_hat(n_wt: torch.Tensor, n_t: torch.Tensor,
             beta: float) -> torch.Tensor:
    """φ̂ = (n_wt + β) / (n_t + Jβ) in f32.  ``J * beta`` is a Python
    double rounded once to f32, as the reference's weak-typed scalar."""
    J = n_wt.shape[0]
    return (n_wt.to(torch.float32) + beta) / (
        n_t.to(torch.float32)[None, :] + J * beta)


def doc_fold_key(key: torch.Tensor, d) -> torch.Tensor:
    """Document ``d``'s fold-in stream under ``key`` (``d`` may be a
    tensor of document indices, giving a batch of keys)."""
    return rng.fold_in(key, d)


def theta_from_counts(n_td: torch.Tensor, alpha) -> torch.Tensor:
    """Posterior-mean θ rows, (n + α) / (Σn + Tα), in f32.

    ``T·α`` is an f32 product, as in the reference engine, where ``α``
    enters ``jit`` as an f32 value.  All-zero rows come out uniform 1/T.
    """
    T = n_td.shape[-1]
    a = torch.tensor(alpha, dtype=torch.float32, device=n_td.device)
    n_d = n_td.sum(-1, keepdim=True)
    return (n_td.to(torch.float32) + a) / (n_d.to(torch.float32) + T * a)


def _positions_in_doc(doc_ids: np.ndarray) -> np.ndarray:
    """Occurrence rank of each token within its document (host-side):
    token i's position is the number of earlier tokens with its doc id."""
    n = doc_ids.shape[0]
    order = np.argsort(doc_ids, kind="stable")
    sorted_ids = doc_ids[order]
    idx = np.arange(n, dtype=np.int32)
    is_start = np.ones(n, bool)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    start = np.maximum.accumulate(np.where(is_start, idx, 0))
    pos = np.empty(n, np.int32)
    pos[order] = idx - start
    return pos


def _validate_fold_in(word_ids, doc_ids, num_docs, num_words):
    """Explicit ValueErrors: fold-in inputs arrive from serving requests
    and held-out splits, not just code."""
    d, w = np.asarray(doc_ids), np.asarray(word_ids)
    if d.ndim != 1 or d.shape != w.shape:
        raise ValueError(
            f"word_ids/doc_ids must be 1-D parallel arrays; got shapes "
            f"{w.shape} and {d.shape}")
    if num_docs < 1:
        raise ValueError(
            f"fold_in needs num_docs >= 1, got {num_docs} (an empty "
            f"fold-in corpus has no θ to estimate)")
    if d.size == 0:
        raise ValueError(
            "fold_in got an empty token list; a document with no tokens "
            "is served by fold_in_batch as an all-False mask row (its θ "
            "is the uniform α prior), not by the serial path")
    if int(d.min()) < 0 or int(d.max()) >= num_docs:
        raise ValueError(
            f"doc_ids out of range [0, {num_docs}): "
            f"[{d.min()}, {d.max()}]")
    if int(w.min()) < 0 or int(w.max()) >= num_words:
        raise ValueError(
            f"word_ids out of range [0, {num_words}) (φ has {num_words} "
            f"rows): [{w.min()}, {w.max()}]")


def _phi_rows(phi: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``phi[w]`` with jnp's gather semantics: a negative id wraps once,
    then the index is clamped into range."""
    J = phi.shape[0]
    w = w.to(torch.int64)
    return phi[torch.where(w < 0, w + J, w).clamp(0, J - 1)]


def _fold_step(z, n_td, p: int, words, v, u, alpha, phi) -> None:
    """One token step at position ``p`` for every row, in place.

    ``z``: (R, L) int64 topics; ``n_td``: (R, T) int32 counts;
    ``words``/``v``: (R, L) word ids and 0/1 int32 mask; ``u``: (R,) f32
    uniforms.  Decrement, ``(n_td+α)·φ[w]``, blocked cumsum, guarded
    LSearch on ``u·cdf[-1]``, masked reassign, increment.
    """
    rows = torch.arange(z.shape[0], device=z.device)
    t_old = z[:, p]
    vi = v[:, p]
    n_td.index_put_((rows, t_old), -vi, accumulate=True)
    prob = (n_td.to(torch.float32) + alpha) * _phi_rows(phi, words[:, p])
    cdf = blocked_cumsum(prob)
    t_new = lsearch_guarded(cdf, u * cdf[:, -1])
    t_new = torch.where(vi > 0, t_new, t_old)
    n_td.index_put_((rows, t_new), vi, accumulate=True)
    z[:, p] = t_new


def _fold_chain(words, v, z, n_td, sweep_uniforms, alpha, phi):
    """Sweep every row: for each ``(R, L)`` uniform block in
    ``sweep_uniforms``, one step per position in order.  Mutates ``z``
    and ``n_td``; returns ``n_td``."""
    for u in sweep_uniforms:
        for p in range(words.shape[1]):
            _fold_step(z, n_td, p, words, v, u[:, p], alpha, phi)
    return n_td


def fold_in(word_ids, doc_ids, num_docs, phi: torch.Tensor, alpha,
            key: torch.Tensor, sweeps: int = 20) -> torch.Tensor:
    """Serial Gibbs fold-in with φ frozen: ``(N,)`` flat token list (any
    interleaving; within-document order is the chain order) →
    ``(num_docs, T)`` int32 counts, on ``phi``'s device.

    Raises ``ValueError`` on an empty token list, ``num_docs < 1`` or
    out-of-range ids.
    """
    _validate_fold_in(word_ids, doc_ids, num_docs, phi.shape[0])
    dev = phi.device
    T = phi.shape[1]
    docs_np = np.asarray(doc_ids, np.int64)
    N = docs_np.shape[0]
    pos = torch.as_tensor(_positions_in_doc(docs_np), device=dev)
    docs = torch.as_tensor(docs_np, device=dev)
    words = torch.as_tensor(np.asarray(word_ids), device=dev).view(1, N)
    dk = rng.fold_in(key.to(dev), docs)
    z = rng.randint(rng.fold_in(rng.fold_in(dk, _ROLE_INIT), pos), T)
    z = z.to(torch.int64).view(1, N)
    n_td = torch.zeros((int(num_docs), T), dtype=torch.int32, device=dev)
    n_td.index_put_((docs, z[0]), torch.ones(N, dtype=torch.int32,
                                             device=dev), accumulate=True)
    sk = rng.fold_in(dk, _ROLE_SWEEP)
    ones = torch.ones((1, N), dtype=torch.int32, device=dev)
    for k in range(int(sweeps)):
        u = rng.uniform(rng.fold_in(rng.fold_in(sk, k), pos))
        for i in range(N):
            d = int(docs_np[i])
            _fold_step(z, n_td[d:d + 1], i, words, ones, u[i:i + 1], alpha,
                       phi)
    return n_td


def fold_in_batch(word_ids: torch.Tensor, valid: torch.Tensor,
                  phi: torch.Tensor, alpha, doc_keys: torch.Tensor,
                  sweeps: int = 20) -> torch.Tensor:
    """Padded-batch fold-in: ``(D, L)`` word ids and bool mask, ``(D, 2)``
    document keys (``doc_fold_key``) → ``(D, T)`` int32 counts.

    Row ``d`` is bit-equal to the serial path on that document alone
    keyed by ``doc_keys[d]``.  Padded positions draw from their own
    counter slots (discarded), add 0 to every count and keep their topic,
    so padding cannot perturb a row; an all-False row returns zeros.
    Validation is shape-only.
    """
    if word_ids.ndim != 2 or word_ids.shape != valid.shape:
        raise ValueError(
            f"word_ids/valid must be matching (D, L) arrays; got "
            f"{tuple(word_ids.shape)} and {tuple(valid.shape)}")
    if doc_keys.shape[0] != word_ids.shape[0]:
        raise ValueError(
            f"doc_keys carries {doc_keys.shape[0]} keys for "
            f"{word_ids.shape[0]} rows")
    dev = phi.device
    T = phi.shape[1]
    D, L = word_ids.shape
    pos = torch.arange(L, device=dev)
    dk = doc_keys.to(dev)
    ik = rng.fold_in(dk, _ROLE_INIT)
    z = rng.randint(rng.fold_in(ik[:, None], pos), T).to(torch.int64)
    v = valid.to(dev, torch.int32)
    n_td = torch.zeros((D, T), dtype=torch.int32, device=dev)
    n_td.scatter_add_(1, z, v)
    sk = rng.fold_in(dk, _ROLE_SWEEP)
    uniforms = (rng.uniform(rng.fold_in(rng.fold_in(sk, k)[:, None], pos))
                for k in range(int(sweeps)))
    return _fold_chain(word_ids.to(dev), v, z, n_td, uniforms, alpha, phi)
