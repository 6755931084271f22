"""Publish-while-serving torn-read and parity check
(``repro/launch/serve_check.py``).

A background :class:`~repro_torch.core.nomad.NomadLDA` trains and, every
``--publish-every`` sweeps, publishes a φ snapshot into a live
:class:`~repro_torch.serve.lda_engine.LdaEngine` while the main thread
fires at least ``--queries`` batched θ queries at it.  After the trainer
joins, every answer is audited:

* **torn reads**: each answer's ``(generation, digest)`` must match
  exactly one published snapshot (a reader pins the buffer with a single
  reference read, so this count must be zero however publishes
  interleave);
* **fold-in parity**: each answer's per-document counts are recomputed by
  the serial ``core/heldout.py:fold_in`` against the φ of the generation
  the answer claims, under the same base key, and must be equal;
* **fused × scan**: every distinct ``(composition, key, generation)``
  answered is replayed through a second engine on the other
  ``inner_mode``; the fold-in kernel and the plain path must agree.

Queries rotate through a fixed document pool (an empty, a single-token
and a long outlier document among them) and a small key cycle, so the
serial references are cached by ``(composition, key, generation)``.

    python -m repro_torch.launch.serve_check --device cpu --queries 20

Prints a JSON report as the last stdout line; exits non-zero unless every
check passes.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading

import numpy as np


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--sweeps", type=int, default=9,
                   help="total trainer sweeps")
    p.add_argument("--publish-every", type=int, default=3)
    p.add_argument("--queries", type=int, default=100,
                   help="minimum reader queries (keeps going while the "
                        "trainer is still publishing)")
    p.add_argument("--batch", type=int, default=8,
                   help="documents per query")
    p.add_argument("--fold-sweeps", type=int, default=3)
    p.add_argument("--key-cycle", type=int, default=5)
    p.add_argument("--pool", type=int, default=12,
                   help="fixed document-pool size")
    p.add_argument("--inner-mode", choices=("scan", "fused"),
                   default="fused",
                   help="fold-in path of the live engine; the audit "
                        "replays answers through the other mode")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA)")
    return p.parse_args(argv)


def _build_trainer(args):
    from repro_torch.core.nomad import NomadLDA
    from repro_torch.data import synthetic
    from repro_torch.data.sharding import build_layout

    T = 8
    corpus, _, _ = synthetic.make_corpus(
        num_docs=80, vocab_size=128, num_topics=T, mean_doc_len=25.0,
        seed=3)
    lay = build_layout(corpus, n_workers=args.workers, T=T,
                       n_blocks=args.workers)
    lda = NomadLDA(layout=lay, alpha=50.0 / T, beta=0.01,
                   sync_mode="stoken", inner_mode="fused",
                   device=args.device)
    return lda, corpus


def _doc_pool(corpus, n_pool: int):
    """Fixed query documents over the trained vocabulary; slots 0 and 1
    are the degenerate cases (empty, single-token) and slot 2 is a long
    outlier that lands in its own length bucket."""
    r = np.random.default_rng(7)
    words = np.unique(np.asarray(corpus.word_ids))
    # 200 tokens → a pow-2 bucket > 4x any median the short docs give,
    # so the engine's outlier rule always splits it off
    lens = [0, 1, 200] + [int(r.integers(2, 24)) for _ in range(n_pool - 3)]
    return [r.choice(words, size=n, replace=True).astype(np.int32)
            for n in lens]


def run_check(args) -> dict:
    import torch

    from repro_torch import rng
    from repro_torch.core.heldout import fold_in
    from repro_torch.serve.lda_engine import LdaEngine, TopicQuery

    lda, corpus = _build_trainer(args)
    dev = lda.dev
    engine = LdaEngine(sweeps=args.fold_sweeps, tile=4,
                       max_batch=max(args.batch, 8),
                       inner_mode=args.inner_mode, device=dev)

    published = {}            # generation -> its snapshot and fields
    pub_lock = threading.Lock()

    def record_publish(snap):
        gen = engine.publish(snap)
        with pub_lock:
            published[gen] = {"digest": snap.digest, "phi": snap.phi,
                              "alpha": snap.alpha, "snap": snap}
        return gen

    # generation 1: the initial counts, published before serving opens
    record_publish(lda.export_phi_snapshot(lda.init_arrays(seed=0),
                                           sweep=0))

    trainer_exc = []

    def trainer():
        try:
            lda.run(args.sweeps, init_seed=0,
                    publish_every=args.publish_every,
                    on_publish=record_publish)
        except Exception as e:               # surfaced in the report
            trainer_exc.append(repr(e))

    pool = _doc_pool(corpus, args.pool)
    P, b = len(pool), args.batch
    key = lambda kidx: rng.key(1000 + kidx, dev)
    answers = []
    th = threading.Thread(target=trainer, daemon=True)
    th.start()
    i = 0
    while i < args.queries or th.is_alive():
        comp, kidx = i % P, i % args.key_cycle
        docs = tuple(pool[(comp + j) % P] for j in range(b))
        res = engine.query(TopicQuery(docs=docs, key=key(kidx)))
        answers.append({"comp": comp, "kidx": kidx,
                        "generation": res.generation, "digest": res.digest,
                        "n_td": res.n_td, "theta": res.theta})
        i += 1
    th.join()

    # ---- audit ----------------------------------------------------------
    gens_seen = sorted({a["generation"] for a in answers})
    torn = sum(1 for a in answers
               if published.get(a["generation"], {}).get("digest")
               != a["digest"])

    ref_cache = {}

    def serial_ref(comp, kidx, gen):
        ck = (comp, kidx, gen)
        if ck not in ref_cache:
            docs = [pool[(comp + j) % P] for j in range(b)]
            w = np.concatenate(docs).astype(np.int32)
            d = np.concatenate([np.full(x.size, j, np.int32)
                                for j, x in enumerate(docs)])
            pub = published[gen]
            ref_cache[ck] = fold_in(
                w, d, b, torch.as_tensor(pub["phi"], device=dev),
                pub["alpha"], key(kidx), args.fold_sweeps).cpu().numpy()
        return ref_cache[ck]

    mismatch = theta_bad = 0
    for a in answers:
        if a["generation"] not in published:
            mismatch += 1
            continue
        if not np.array_equal(serial_ref(a["comp"], a["kidx"],
                                         a["generation"]), a["n_td"]):
            mismatch += 1
        if not np.allclose(a["theta"].sum(1), 1.0, atol=1e-5):
            theta_bad += 1

    # ---- fused × scan ----------------------------------------------------
    other = "fused" if args.inner_mode == "scan" else "scan"
    cross_eng = LdaEngine(sweeps=args.fold_sweeps, tile=4,
                          max_batch=max(args.batch, 8), inner_mode=other,
                          device=dev)
    by_triple = {(a["comp"], a["kidx"], a["generation"]): a
                 for a in answers if a["generation"] in published}
    cross_mismatch = 0
    for gen in sorted(published):
        triples = sorted(t for t in by_triple if t[2] == gen)
        if not triples:
            continue
        cross_eng.publish(published[gen]["snap"])
        for comp, kidx, _ in triples:
            docs = tuple(pool[(comp + j) % P] for j in range(b))
            res = cross_eng.query(TopicQuery(docs=docs, key=key(kidx)))
            if not np.array_equal(res.n_td,
                                  by_triple[comp, kidx, gen]["n_td"]):
                cross_mismatch += 1

    ok = (torn == 0 and mismatch == 0 and theta_bad == 0
          and cross_mismatch == 0
          and not trainer_exc and len(published) >= 3
          and len(answers) >= args.queries
          and len(gens_seen) >= 2)          # actually interleaved
    return {"publishes": len(published), "queries": len(answers),
            "generations_seen": gens_seen, "torn_reads": torn,
            "fold_in_mismatch": mismatch, "theta_rows_bad": theta_bad,
            "serial_refs_computed": len(ref_cache),
            "inner_mode": args.inner_mode,
            "cross_mode_replays": len(by_triple),
            "cross_mode_mismatch": cross_mismatch,
            "trainer_error": trainer_exc[0] if trainer_exc else None,
            "device": str(dev), "all_ok": ok}


def main(argv=None) -> None:
    report = run_check(_parse(sys.argv[1:] if argv is None else argv))
    print(json.dumps(report))
    if not report["all_ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
