"""Held-out evaluation and fold-in inference with φ frozen
(``repro/core/heldout.py``).

Document completion (:func:`document_completion_perplexity`) holds out a
set of documents, estimates each one's θ from the even positions of its
tokens by a Gibbs fold-in against the trained φ, and scores the odd ones:

    perplexity = exp( − Σ log p(w | θ̂, φ̂) / N_second_half )

with φ̂ = (n_wt + β)/(n_t + Jβ) and θ̂ = (n_td + α)/(n_d + Tα).  The same
fold-in serves an incoming document's θ against a published φ snapshot.
Two implementations share one chain:

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
(:func:`repro_torch.numerics.blocked_cumsum`).  The perplexity folds its
estimation halves in through the fold-in op (``kernels/fold_in``: the CUDA
kernel on the card, its plain version on the CPU), packed into padded
``(D, L)`` buckets keyed by ``doc_fold_key(key, d)``; by the RNG contract
its counts are the serial :func:`fold_in`'s.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import rng
from repro_torch._device import resolve
from repro_torch.core.samplers import lsearch_guarded
from repro_torch.numerics import blocked_cumsum

__all__ = ["document_completion_perplexity", "fold_in", "fold_in_batch",
           "doc_fold_key", "theta_from_counts"]

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


#: Tokens scored a chunk in :func:`document_completion_perplexity`.
_SCORE_CHUNK = 1 << 16


def _fold_in_halves(words: np.ndarray, docs: np.ndarray, num_docs: int,
                    phi: torch.Tensor, alpha, key: torch.Tensor,
                    sweeps: int) -> torch.Tensor:
    """``fold_in`` of a doc-sorted token list through the fold-in op:
    each document's tokens, in order, are one row of a padded ``(D, L)``
    batch keyed by ``doc_fold_key(key, d)``, the rows bucketed by the
    power of two above their length → ``(num_docs, T)`` int32 counts,
    equal to the serial path's by the RNG contract."""
    from repro_torch.kernels.fold_in.ops import fold_in_fused
    dev = phi.device
    n_td = torch.zeros((num_docs, phi.shape[1]), dtype=torch.int32,
                       device=dev)
    ids, starts, lens = np.unique(docs, return_index=True,
                                  return_counts=True)
    bucket = 1 << np.ceil(np.log2(lens)).astype(np.int64)
    for L in np.unique(bucket).tolist():
        sel = np.nonzero(bucket == L)[0]
        pos = np.arange(L)
        valid = pos[None, :] < lens[sel, None]
        src = np.where(valid, starts[sel, None] + pos[None, :], 0)
        rows = torch.as_tensor(ids[sel], device=dev)
        n_td[rows] = fold_in_fused(
            torch.as_tensor(words[src], device=dev),
            torch.as_tensor(valid, device=dev), phi, alpha,
            doc_fold_key(key, rows), sweeps)
    return n_td


def document_completion_perplexity(heldout, n_wt, n_t, *, alpha: float,
                                   beta: float, key=None,
                                   fold_sweeps: int = 20,
                                   device=None) -> float:
    """Split each held-out document's tokens in half (even positions
    estimate, odd ones are scored), fold in on the first half, score the
    second.  ``heldout`` is a :class:`~repro_torch.data.corpus.Corpus`;
    ``device=None`` means CUDA.

    The fold-in counts equal the reference's bit for bit.  θ̂ forms
    ``T·α`` as a Python double rounded once to f32, as the reference
    does outside ``jit`` (the engine's f32 product,
    :func:`theta_from_counts`, rounds differently).  The per-token
    probabilities are summed in f32 and their logs in f64, so the score
    agrees with the reference's to within the rounding of its f32 sums.

    A corpus of single-token documents puts every token in the
    estimation half: nothing is scored and the perplexity is exactly
    1.0.  A corpus with no tokens at all raises, as :func:`fold_in`
    does."""
    dev = resolve(device)
    key = rng.key(0, dev) if key is None else key.to(dev)
    phi = _phi_hat(torch.as_tensor(np.asarray(n_wt), device=dev),
                   torch.as_tensor(np.asarray(n_t), device=dev), beta)
    order = heldout.doc_order()
    first = _positions_in_doc(heldout.doc_ids[order]) % 2 == 0
    est, score = order[first], order[~first]
    words, docs = heldout.word_ids[est], heldout.doc_ids[est]
    _validate_fold_in(words, docs, heldout.num_docs, phi.shape[0])
    n_td = _fold_in_halves(words, docs, heldout.num_docs, phi, alpha, key,
                           int(fold_sweeps))
    T = n_td.shape[1]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    theta = (n_td.to(torch.float32) + f32(alpha)) / (
        n_td.sum(1, keepdim=True).to(torch.float32) + f32(T * alpha))
    ll = 0.0
    for lo in range(0, score.shape[0], _SCORE_CHUNK):
        part = score[lo:lo + _SCORE_CHUNK]
        d = torch.as_tensor(heldout.doc_ids[part], device=dev).long()
        w = torch.as_tensor(heldout.word_ids[part], device=dev).long()
        p_tok = (theta[d] * phi[w]).sum(-1)
        ll += float(torch.log(torch.clamp(p_tok, min=1e-30)).double().sum())
    return math.exp(-ll / max(score.shape[0], 1))
