"""F+Nomad LDA on an 8-worker ring, the twin of
``examples/nomad_distributed.py``.

Run:  python -m repro_torch.examples.nomad_distributed [n_blocks]
          [ring_mode] [layout] [doc_tile] [--sweeps N]
          [--checkpoint-every N [--checkpoint-path PATH]]
          [--resume-from PATH] [--device cpu]

Documents are sharded across 8 workers, which run in lock step on one
device; word-topic blocks travel the ring as nomadic tokens, by default 4
blocks a worker (B = 4W, pass ``n_blocks`` to override), and the s token
carries the global topic counts (paper Alg. 4).  ``ring_mode``
``pipelined`` (default) splits each round at the half queue, ``barrier``
does not: the same chain bit for bit.  ``layout`` ``ragged`` (default)
stores each worker's queue as a tile stream, ``dense`` as a cell grid.
``doc_tile`` (0 = off) pages ``(doc_tile, T)`` slabs of ``n_td`` through
the fused kernel's shared memory.  ``--checkpoint-every`` writes a chain
checkpoint every N sweeps; ``--resume-from`` continues a killed run bit
for bit.  The inner mode is ``fused`` (the CUDA kernel on the card, its
plain version on the CPU), the chain of the reference's default
``scan``.  Prints the log-likelihood a sweep and checks the counts.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

W = 8


def main(argv=None) -> dict:
    """Train, print and check → the final sweep arrays."""
    ap = argparse.ArgumentParser(
        description="F+Nomad LDA on an 8-worker ring on one device")
    ap.add_argument("n_blocks", nargs="?", type=int, default=0,
                    help="ring blocks B (default 4W)")
    ap.add_argument("ring_mode", nargs="?", default="pipelined",
                    choices=("pipelined", "barrier"))
    ap.add_argument("layout", nargs="?", default="ragged",
                    choices=("ragged", "dense"))
    ap.add_argument("doc_tile", nargs="?", type=int, default=0,
                    help="doc-topic slab height (0 = whole shard)")
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--docs", type=int, default=600)
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="write a chain checkpoint every N sweeps (0 = off)")
    ap.add_argument("--checkpoint-path", metavar="PATH",
                    default=os.path.join(tempfile.gettempdir(),
                                         "nomad_chain.npz"))
    ap.add_argument("--resume-from", default=None, metavar="PATH",
                    help="resume bit-for-bit from a chain checkpoint")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    from repro_torch.core.nomad import NomadLDA
    from repro_torch.data import synthetic
    from repro_torch.data.sharding import build_layout

    T = 32
    alpha, beta = 50.0 / T, 0.01
    corpus, _, _ = synthetic.make_corpus(
        num_docs=args.docs, vocab_size=1024, num_topics=T,
        mean_doc_len=50.0, seed=1)
    n_blocks = args.n_blocks or 4 * W
    doc_kw = {}
    if args.doc_tile:
        doc_kw = dict(doc_tile=args.doc_tile)
        if args.layout == "dense":
            doc_kw["doc_blk"] = 16      # toy-corpus grid step (cf. N_BLK)
    layout = build_layout(corpus, n_workers=W, T=T, n_blocks=n_blocks,
                          layout=args.layout, **doc_kw)
    lda = NomadLDA(layout=layout, alpha=alpha, beta=beta,
                   sync_mode="stoken", inner_mode="fused",
                   ring_mode=args.ring_mode,
                   doc_tile=args.doc_tile if args.doc_tile else None,
                   checkpoint_every=args.checkpoint_every or None,
                   checkpoint_path=(args.checkpoint_path
                                    if args.checkpoint_every else None),
                   resume_from=args.resume_from, device=args.device)
    print(f"workers: {W} on {lda.dev}; corpus: {corpus.num_tokens} tokens")
    print(f"layout: {layout.W}x{layout.B} cells ({layout.k} blocks/queue, "
          f"{layout.kind}), pad {layout.pad_fraction:.1%},"
          f" worst-round imbalance {layout.round_imbalance:.2f}x,"
          f" ring_mode {args.ring_mode}"
          + (f", doc_tile {args.doc_tile} "
             f"({layout.ntd_slab_bytes} B slab vs "
             f"{layout.ntd_whole_bytes} B whole-shard)"
             if args.doc_tile else ""))
    if args.resume_from:
        print(f"resuming chain from {args.resume_from}")
    else:
        print(f"initial ll: "
              f"{lda.log_likelihood(lda.init_arrays(seed=0)):.0f}")

    t0 = [time.perf_counter()]

    def on_sweep(it, arrays):
        lda._sync()
        ll = lda.log_likelihood(arrays)
        rate = corpus.num_tokens / (time.perf_counter() - t0[0])
        print(f"sweep {it + 1:2d}  ll {ll:.0f}  ({rate:,.0f} tok/s)")
        t0[0] = time.perf_counter()

    arrays, _ = lda.run(args.sweeps, on_sweep=on_sweep)
    if args.checkpoint_every:
        print(f"chain checkpoint at {args.checkpoint_path} "
              f"(resume with --resume-from)")

    # exactness: the count tables agree with each other across the ring
    n_td, n_wt, n_t = lda.global_counts(arrays)
    if int(n_t.sum()) != corpus.num_tokens \
            or not np.array_equal(n_td.sum(0), n_t) \
            or not np.array_equal(n_wt.sum(0), n_t):
        raise SystemExit("count tables disagree across the ring")
    print("count tables exact across the ring")
    return arrays


if __name__ == "__main__":
    main()
