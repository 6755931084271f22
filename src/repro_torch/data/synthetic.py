"""Synthetic corpora drawn from the LDA generative process (paper §2), the
port's own copy of ``repro/data/synthetic.py`` (numpy only, the same
draws from the same seed).

Used for all experiments (no network access): topics φ_k ~ Dirichlet(β) over
a Zipf-weighted vocabulary, per-document θ_i ~ Dirichlet(α), document lengths
log-normal — mimicking the UCI bag-of-words statistics (Enron/NyTimes scale
is reachable by turning the knobs).
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.corpus import Corpus

__all__ = ["make_corpus", "SyntheticCorpusSpec"]


def make_corpus(
    *,
    num_docs: int,
    vocab_size: int,
    num_topics: int,
    mean_doc_len: float = 80.0,
    alpha: float = 0.1,
    beta: float = 0.01,
    zipf_a: float = 1.1,
    seed: int = 0,
) -> tuple[Corpus, np.ndarray, np.ndarray]:
    """Sample (corpus, true_theta, true_phi) from the LDA generative process.

    Vocabulary gets a Zipf tilt on top of Dirichlet(β) topics so word
    frequencies are realistically skewed (important: the nomad word-block
    load balancing is only interesting under skew).
    """
    rng = np.random.default_rng(seed)
    # Topic-word distributions with Zipf prior tilt.
    zipf = 1.0 / np.arange(1, vocab_size + 1) ** zipf_a
    rng.shuffle(zipf)
    phi = rng.dirichlet(np.full(vocab_size, beta) + beta * vocab_size *
                        zipf / zipf.sum(), size=num_topics)
    theta = rng.dirichlet(np.full(num_topics, alpha), size=num_docs)

    lengths = np.maximum(
        1, rng.lognormal(np.log(mean_doc_len), 0.6, size=num_docs).astype(int))
    N = int(lengths.sum())
    doc_ids = np.repeat(np.arange(num_docs, dtype=np.int32), lengths)
    # Topic per token, then word per token — vectorized inverse-CDF draws.
    z = _sample_rows(rng, theta, doc_ids)
    word_ids = _sample_rows(rng, phi, z).astype(np.int32)
    return (Corpus(doc_ids=doc_ids, word_ids=word_ids,
                   num_docs=num_docs, num_words=vocab_size),
            theta, phi)


def _sample_rows(rng: np.random.Generator, table: np.ndarray,
                 rows: np.ndarray) -> np.ndarray:
    """Draw one categorical sample from ``table[rows[k]]`` for each k."""
    cdf = np.cumsum(table, axis=1)
    cdf /= cdf[:, -1:]
    u = rng.random(rows.shape[0])
    # searchsorted per row via the "offset trick": each row's cdf is in [0,1];
    # add the row index so rows occupy disjoint unit intervals.
    flat = (cdf[rows] + np.arange(rows.shape[0])[:, None]).ravel()
    targets = u + np.arange(rows.shape[0])
    idx = np.searchsorted(flat, targets, side="right")
    # flat position = k * T + idx_within_row
    return (idx - np.arange(rows.shape[0]) * table.shape[1]).astype(np.int32)


class SyntheticCorpusSpec:
    """Named corpus presets scaled down from the paper's Table 3."""

    PRESETS = {
        # name: (num_docs, vocab, topics, mean_len)  — scaled-down analogues
        "enron-xs": (400, 512, 16, 60.0),
        "enron-sm": (2_000, 2_048, 64, 80.0),
        "nytimes-sm": (6_000, 4_096, 64, 120.0),
        "pubmed-sm": (20_000, 8_192, 128, 90.0),
    }

    @classmethod
    def make(cls, name: str, seed: int = 0):
        d, v, t, ml = cls.PRESETS[name]
        return make_corpus(num_docs=d, vocab_size=v, num_topics=t,
                           mean_doc_len=ml, seed=seed)
