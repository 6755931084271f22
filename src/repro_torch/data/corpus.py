"""Bag-of-words corpus representation (numpy only), the port's own copy of
``repro/data/corpus.py``.

The corpus is the hyper-edge list of the paper's access graph (Fig. 2): one
entry per word *occurrence*, i.e. flat parallel arrays

    doc_ids  (N,) int32   document index i of each occurrence
    word_ids (N,) int32   vocabulary index j of each occurrence

plus derived orderings.  The LDA state (topic assignment ``z`` and the three
count tables) lives next to it in :mod:`repro_torch.core.cgs`.

Orders:
    ``doc_order``  — occurrences sorted by (doc, position): doc-by-doc sweeps.
    ``word_order`` — occurrences sorted by (word, doc): word-by-word sweeps
                     (Alg. 3); ``word_boundary`` flags the first occurrence of
                     each vocabulary item in this order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Corpus"]


@dataclass(frozen=True)
class Corpus:
    doc_ids: np.ndarray          # (N,) int32
    word_ids: np.ndarray         # (N,) int32
    num_docs: int                # I
    num_words: int               # J (vocabulary size)

    def __post_init__(self):
        # Explicit ValueErrors, not asserts: validation must survive
        # ``python -O``, and these arrays now also arrive from on-disk
        # corpus-store shards, not just code.
        d, w = self.doc_ids, self.word_ids
        if d.ndim != 1 or d.shape != w.shape:
            raise ValueError(
                f"doc_ids/word_ids must be 1-D parallel arrays; got shapes "
                f"{d.shape} and {w.shape}")
        if d.dtype != np.int32 or w.dtype != np.int32:
            raise ValueError(
                f"doc_ids/word_ids must be int32; got {d.dtype} and "
                f"{w.dtype}")
        if self.num_docs < 0 or self.num_words < 0:
            raise ValueError(
                f"num_docs/num_words must be >= 0; got {self.num_docs}, "
                f"{self.num_words}")
        if d.size:
            if int(d.min()) < 0 or int(d.max()) >= self.num_docs:
                raise ValueError(
                    f"doc_ids out of range [0, {self.num_docs}): "
                    f"[{d.min()}, {d.max()}]")
            if int(w.min()) < 0 or int(w.max()) >= self.num_words:
                raise ValueError(
                    f"word_ids out of range [0, {self.num_words}): "
                    f"[{w.min()}, {w.max()}]")

    @property
    def num_tokens(self) -> int:
        return int(self.doc_ids.shape[0])

    # ---- sweep orders -----------------------------------------------------
    def doc_order(self) -> np.ndarray:
        """Occurrence permutation for document-by-document sweeps."""
        return np.argsort(self.doc_ids, kind="stable").astype(np.int32)

    def word_order(self) -> np.ndarray:
        """Occurrence permutation for word-by-word sweeps (paper Alg. 3)."""
        return np.argsort(self.word_ids, kind="stable").astype(np.int32)

    def word_boundary(self, order: np.ndarray | None = None) -> np.ndarray:
        """Bool flags: token k (in word order) starts a new vocabulary item."""
        order = self.word_order() if order is None else order
        w = self.word_ids[order]
        return np.concatenate([[True], w[1:] != w[:-1]])

    # ---- stats ------------------------------------------------------------
    def doc_lengths(self) -> np.ndarray:
        return np.bincount(self.doc_ids, minlength=self.num_docs)

    def word_freqs(self) -> np.ndarray:
        return np.bincount(self.word_ids, minlength=self.num_words)

    @staticmethod
    def from_dense(counts: np.ndarray) -> "Corpus":
        """Build from a dense doc×word count matrix (tests / tiny corpora)."""
        I, J = counts.shape
        docs, words = np.nonzero(counts)
        reps = counts[docs, words]
        doc_ids = np.repeat(docs, reps).astype(np.int32)
        word_ids = np.repeat(words, reps).astype(np.int32)
        return Corpus(doc_ids=doc_ids, word_ids=word_ids,
                      num_docs=I, num_words=J)

    def subset(self, doc_mask: np.ndarray) -> "Corpus":
        """Restrict to documents where ``doc_mask`` is True (ids preserved)."""
        keep = doc_mask[self.doc_ids]
        return Corpus(doc_ids=self.doc_ids[keep], word_ids=self.word_ids[keep],
                      num_docs=self.num_docs, num_words=self.num_words)
