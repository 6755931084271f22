"""End-to-end training driver: F+Nomad LDA on a 4-worker ring, the twin of
``examples/train_lda_e2e.py``.

Run:  python -m repro_torch.examples.train_lda_e2e [--sweeps 100]
          [--checkpoint-every 10] [--resume-from PATH] [--device cpu]

Sweeps of F+Nomad LDA (the workers in lock step on one device, fused
inner mode) on a PubMed-scaled-down synthetic corpus (T = 64), with a
resumable chain checkpoint every ``--checkpoint-every`` sweeps: kill the
run and pass ``--resume-from`` to continue bit for bit where it left off.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

W = 4


def main(argv=None) -> dict:
    """Train and print → the final sweep arrays."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweeps", type=int, default=100)
    ap.add_argument("--topics", type=int, default=64)
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_lda_ckpt.npz"))
    ap.add_argument("--checkpoint-every", type=int, default=10, metavar="N",
                    help="write a chain checkpoint every N sweeps (0 = off)")
    ap.add_argument("--resume-from", default=None, metavar="PATH",
                    help="resume bit-for-bit from a chain checkpoint")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    from repro_torch.core.nomad import NomadLDA
    from repro_torch.data import synthetic
    from repro_torch.data.sharding import build_layout

    T = args.topics
    alpha, beta = 50.0 / T, 0.01
    corpus, _, _ = synthetic.make_corpus(
        num_docs=args.docs, vocab_size=2048, num_topics=T,
        mean_doc_len=80.0, seed=0)
    layout = build_layout(corpus, n_workers=W, T=T)
    lda = NomadLDA(layout=layout, alpha=alpha, beta=beta,
                   sync_mode="stoken", inner_mode="fused",
                   checkpoint_every=args.checkpoint_every or None,
                   checkpoint_path=(args.ckpt if args.checkpoint_every
                                    else None),
                   resume_from=args.resume_from, device=args.device)

    print(f"{corpus.num_tokens:,} tokens on {W} workers ({lda.dev}); "
          f"T={T}; {args.sweeps} sweeps"
          + (f"; resuming from {args.resume_from}"
             if args.resume_from else ""))
    t_start = time.perf_counter()
    done = [0]

    def on_sweep(it, arrays):
        done[0] += 1
        if (it + 1) % 10 == 0:
            lda._sync()
            ll = lda.log_likelihood(arrays)
            rate = corpus.num_tokens * done[0] / (time.perf_counter()
                                                  - t_start)
            print(f"sweep {it + 1:4d}  ll {ll:,.0f}  ({rate:,.0f} tok/s)")

    arrays, _ = lda.run(args.sweeps, on_sweep=on_sweep)
    print(f"done in {time.perf_counter() - t_start:.1f}s"
          + (f"; chain checkpoint at {args.ckpt} "
             f"(resume with --resume-from)" if args.checkpoint_every
             else ""))
    return arrays


if __name__ == "__main__":
    main()
