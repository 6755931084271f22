"""Bit-exact checkpoint/resume check for the port's Nomad LDA chain
(``repro/launch/resume_check.py``).

Three process phases tell the preemption story end to end::

    --phase straight   run ``--sweeps`` uninterrupted, print chain digest
    --phase train      run to ``--checkpoint-at``, write ``--ckpt``, then
                       die (``--kill`` exits abruptly, mid-process, the
                       way a preempted job does)
    --phase resume     resume from ``--ckpt``, run to ``--sweeps``, print
                       chain digest

The straight and train→kill→resume digests must be identical: the chain
is bit for bit independent of the interruption.  ``--phase matrix`` runs
the whole comparison in process across {dense, ragged} × {barrier,
pipelined} × {dense, sparse} r-mode.  :func:`chain_digest` hashes the
bytes the reference's does in the same order, so both packages give one
digest for one chain.

    python -m repro_torch.launch.resume_check --device cpu --phase matrix

Prints a JSON report as the last stdout line; exits non-zero unless the
matrix is exact.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phase", default="matrix",
                   choices=["straight", "train", "resume", "matrix"])
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--sync-mode", default="stoken")
    p.add_argument("--inner-mode", default="fused",
                   choices=["scan", "fused", "vectorized"])
    p.add_argument("--n-blocks", type=int, default=0, help="0 → workers")
    p.add_argument("--ring-mode", default="barrier")
    p.add_argument("--layout", default="dense", choices=["dense", "ragged"])
    p.add_argument("--doc-tile", type=int, default=0)
    p.add_argument("--r-mode", default="dense", choices=["dense", "sparse"])
    p.add_argument("--sweeps", type=int, default=6)
    p.add_argument("--checkpoint-at", type=int, default=3)
    p.add_argument("--ckpt", default="")
    p.add_argument("--kill", action="store_true",
                   help="train phase: die abruptly after the checkpoint "
                        "write instead of exiting cleanly")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA)")
    return p.parse_args(argv)


def _build(args, *, layout_kind, ring_mode, r_mode, ckpt_every=None,
           ckpt_path=None, resume_from=None):
    from repro_torch.core.nomad import NomadLDA
    from repro_torch.data import synthetic
    from repro_torch.data.sharding import build_layout

    T = 8
    corpus, _, _ = synthetic.make_corpus(
        num_docs=80, vocab_size=128, num_topics=T, mean_doc_len=25.0, seed=3)
    W = args.workers
    doc_kw = {}
    if args.doc_tile > 0:
        doc_kw = dict(doc_tile=args.doc_tile)
        if layout_kind == "dense":
            doc_kw["doc_blk"] = 16
    lay = build_layout(corpus, n_workers=W, T=T, n_blocks=args.n_blocks or W,
                       layout=layout_kind, **doc_kw)
    return NomadLDA(layout=lay, alpha=50.0 / T, beta=0.01,
                    sync_mode=args.sync_mode, inner_mode=args.inner_mode,
                    ring_mode=ring_mode, doc_tile=args.doc_tile or None,
                    r_mode=r_mode,
                    r_cap=lay.r_cap if r_mode == "sparse" else 0,
                    checkpoint_every=ckpt_every, checkpoint_path=ckpt_path,
                    resume_from=resume_from, device=args.device)


def chain_digest(lda, arrays) -> str:
    """sha256 over every chain-carrying field, in canonical order: ``z``
    (int32), the global counts (int64) and the side tables (int32)."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(lda.layout.extract_canonical(
        arrays["z"].cpu().numpy())).tobytes())
    for part in lda.global_counts(arrays):
        h.update(np.ascontiguousarray(part).tobytes())
    if lda.r_mode == "sparse":
        for k in ("rb_topics", "rb_counts"):
            h.update(np.ascontiguousarray(arrays[k].cpu().numpy()).tobytes())
    return h.hexdigest()


def _run_matrix(args) -> dict:
    combos, exact = [], True
    for layout_kind in ("dense", "ragged"):
        for ring_mode in ("barrier", "pipelined"):
            for r_mode in ("dense", "sparse"):
                lda = _build(args, layout_kind=layout_kind,
                             ring_mode=ring_mode, r_mode=r_mode)
                arrays = lda.init_arrays(seed=0)
                for s in range(args.sweeps):
                    arrays = lda.sweep(arrays, seed=s)
                ref = chain_digest(lda, arrays)

                arrays2 = lda.init_arrays(seed=0)
                for s in range(args.checkpoint_at):
                    arrays2 = lda.sweep(arrays2, seed=s)
                state, meta = lda.export_chain_state(
                    arrays2, next_seed=args.checkpoint_at)
                # round-trip through bytes, as a real resume would
                state = {k: np.asarray(v).copy() for k, v in state.items()}
                meta = json.loads(json.dumps(meta))
                arrays3, start = lda.restore_chain_state(state, meta)
                for s in range(start, args.sweeps):
                    arrays3 = lda.sweep(arrays3, seed=s)
                ok = chain_digest(lda, arrays3) == ref
                exact &= ok
                combos.append({"layout": layout_kind, "ring_mode": ring_mode,
                               "r_mode": r_mode, "exact": ok})
    return {"phase": "matrix", "combos": combos, "all_exact": exact,
            "all_ok": exact}


def main(argv=None) -> None:
    args = _parse(sys.argv[1:] if argv is None else argv)
    if args.phase == "matrix":
        report = _run_matrix(args)
        print(json.dumps(report))
        if not report["all_ok"]:
            raise SystemExit(1)
        return

    if args.phase in ("train", "resume") and not args.ckpt:
        raise SystemExit("--ckpt is required for train/resume phases")
    kw = dict(layout_kind=args.layout, ring_mode=args.ring_mode,
              r_mode=args.r_mode)
    if args.phase == "straight":
        lda = _build(args, **kw)
        arrays, done = lda.run(args.sweeps, init_seed=0)
        print(json.dumps({"phase": "straight", "sweeps": done,
                          "digest": chain_digest(lda, arrays)}))
    elif args.phase == "train":
        lda = _build(args, ckpt_every=args.checkpoint_at,
                     ckpt_path=args.ckpt, **kw)
        lda.run(args.checkpoint_at, init_seed=0)
        print(json.dumps({"phase": "train", "sweeps": args.checkpoint_at,
                          "ckpt": args.ckpt}))
        if args.kill:                      # preemption: no clean teardown
            sys.stdout.flush()
            os._exit(137)
    else:                                  # resume
        lda = _build(args, resume_from=args.ckpt, **kw)
        arrays, done = lda.run(args.sweeps)
        print(json.dumps({"phase": "resume", "sweeps": done,
                          "digest": chain_digest(lda, arrays)}))


if __name__ == "__main__":
    main()
