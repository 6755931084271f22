"""Online topic inference: train, publish φ and serve θ queries live, the
twin of ``examples/serve_topics.py``.

Run:  python -m repro_torch.examples.serve_topics [--sweeps N]
          [--publish-every N] [--queries N] [--batch N] [--save PATH]
          [--device cpu]

A 4-worker F+Nomad ring (in lock step on one device, fused inner mode)
trains on a synthetic corpus in a thread and publishes a fresh φ snapshot
into a live :class:`LdaEngine` every ``--publish-every`` sweeps, while
this thread keeps sending batched θ queries to the engine: φ is double
buffered, so no query sees a torn table.  Each answer prints the
snapshot generation it folded against, its latency and the top topic of
each document.  ``--save`` round-trips the last snapshot through the
format-versioned ``save_phi``/``load_phi`` store.
"""
from __future__ import annotations

import argparse
import sys
import threading

import numpy as np


def main(argv=None) -> dict:
    """Train, serve and print → ``{"answers": [...], "generations":
    [...], "saved": digest or None}``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sweeps", type=int, default=9)
    p.add_argument("--publish-every", type=int, default=3)
    p.add_argument("--queries", type=int, default=12)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--save", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    from repro_torch import rng
    from repro_torch.core.nomad import NomadLDA
    from repro_torch.data import synthetic
    from repro_torch.data.sharding import build_layout
    from repro_torch.serve.lda_engine import (LdaEngine, PhiSnapshot,
                                              TopicQuery)

    T = 8
    corpus, _, _ = synthetic.make_corpus(
        num_docs=120, vocab_size=128, num_topics=T, mean_doc_len=30.0,
        seed=0)
    lay = build_layout(corpus, n_workers=4, T=T, n_blocks=8,
                       layout="ragged")
    lda = NomadLDA(layout=lay, alpha=50.0 / T, beta=0.01,
                   sync_mode="stoken", inner_mode="fused",
                   device=args.device)

    engine = LdaEngine(sweeps=5, tile=8, max_batch=64, device=lda.dev)
    engine.publish(lda.export_phi_snapshot(lda.init_arrays(seed=0),
                                           sweep=0))
    print(f"serving opened at generation {engine.generation} "
          f"(init counts) on {lda.dev}")

    latest = {}
    failed = []

    def on_publish(snap):
        gen = engine.publish(snap)
        latest["snap"], latest["gen"] = snap, gen
        print(f"  [ring] published sweep-{snap.meta['sweep']} snapshot "
              f"-> generation {gen} ({snap.digest[:12]}...)")

    def train():
        try:
            lda.run(args.sweeps, init_seed=0,
                    publish_every=args.publish_every, on_publish=on_publish)
        except BaseException as e:          # reported after the join
            failed.append(e)

    trainer = threading.Thread(target=train, daemon=True)
    trainer.start()

    r = np.random.default_rng(1)
    words = np.unique(np.asarray(corpus.word_ids))
    answers = []
    i = 0
    while i < args.queries or trainer.is_alive():
        docs = tuple(
            r.choice(words, size=int(n), replace=True).astype(np.int32)
            for n in r.integers(1, 25, size=args.batch))
        res = engine.query(TopicQuery(docs=docs, key=rng.key(i, lda.dev)))
        top = np.argmax(res.theta, axis=1)
        print(f"query {i:3d}: gen {res.generation}, "
              f"{res.latency_s * 1e3:6.1f} ms, "
              f"batch {res.batch_shape}, top topics {top.tolist()}")
        answers.append(res)
        i += 1
    trainer.join()
    if failed:
        raise failed[0]

    saved = None
    if args.save and latest:
        latest["snap"].save(args.save)
        back = PhiSnapshot.load(args.save)
        if back.digest != latest["snap"].digest or not np.array_equal(
                back.phi, latest["snap"].phi):
            raise SystemExit("the reloaded snapshot differs from the saved")
        saved = back.digest
        print(f"snapshot saved to {args.save} and reloaded "
              f"(digest {back.digest[:12]}..., generation {latest['gen']})")
    return {"answers": answers, "generations": engine.generation,
            "saved": saved}


if __name__ == "__main__":
    main()
