"""Quickstart: serial F+LDA (paper Alg. 3) on a synthetic corpus, the twin
of ``examples/quickstart.py``.

Run:  python -m repro_torch.examples.quickstart [--device cpu]
Trains word-by-word F+LDA for 20 sweeps, prints the log-likelihood
trajectory and the top words of a few topics.  The sweep is
``cgs.sweep_fplda_word(backend="fused")``: the fused-sweep CUDA kernel on
the card, its plain version on the CPU, the reference's chain bit for
bit (the reference's ``scan`` backend is the same chain).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> dict:
    """Train and print → ``{"ll": [(sweep, ll/token), ...], "state":
    the final LDAState}``, the initial state as sweep 0 and then every
    fifth sweep."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=400)
    ap.add_argument("--sweeps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    from repro_torch import rng
    from repro_torch._device import resolve
    from repro_torch.core import cgs, likelihood
    from repro_torch.data import synthetic

    dev = resolve(args.device)
    T = 16
    alpha, beta = 50.0 / T, 0.01
    corpus, _, _ = synthetic.make_corpus(
        num_docs=args.docs, vocab_size=512, num_topics=T,
        mean_doc_len=60.0, seed=0)
    print(f"corpus: {corpus.num_docs} docs, {corpus.num_words} vocab, "
          f"{corpus.num_tokens} tokens, T={T}, on {dev}")
    order = corpus.word_order()
    boundary = corpus.word_boundary(order)

    state = cgs.init_state(corpus, T, rng.key(0, dev))
    lls = [(0, likelihood.per_token_ll(state, alpha, beta))]
    print(f"initial ll/token: {lls[0][1]:.4f}")
    for it in range(args.sweeps):
        state = cgs.sweep_fplda_word(state, corpus.doc_ids, corpus.word_ids,
                                     order, boundary, alpha, beta,
                                     backend="fused")
        if (it + 1) % 5 == 0:
            lls.append((it + 1, likelihood.per_token_ll(state, alpha, beta)))
            print(f"sweep {it + 1:3d}  ll/token {lls[-1][1]:.4f}")

    n_wt = state.n_wt.cpu().numpy()
    print("\ntop-6 words of first 4 topics:")
    for t in range(4):
        top = np.argsort(-n_wt[:, t])[:6]
        print(f"  topic {t}: {top.tolist()}  (counts {n_wt[top, t].tolist()})")
    return {"ll": lls, "state": state}


if __name__ == "__main__":
    main()
