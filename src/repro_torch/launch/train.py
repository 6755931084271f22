"""Training launcher (``repro/launch/train.py``), its LDA half:

    python -m repro_torch.launch.train lda --workers 8 --sweeps 40 \\
        --topics 64 --docs 1000 --ckpt /path/to/lda.npz [--device cpu]

Builds a synthetic corpus and its nomad layout, trains ``NomadLDA`` with
``--workers`` lock-step workers on one device (CUDA unless ``--device``
says otherwise), prints the log-likelihood and tokens a second every ten
sweeps, and saves ``z``, ``n_td``, ``n_wt`` and ``n_t`` with
:func:`repro_torch.train.checkpoint.save` (the reference's file format).
``--multi-pod`` is refused: one device has no pod axis.
"""
import argparse
import os
import sys
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["lda"])
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--sweeps", type=int, default=40)
    ap.add_argument("--topics", type=int, default=64)
    ap.add_argument("--docs", type=int, default=1000)
    ap.add_argument("--sync", default="stoken",
                    choices=["stoken", "stale", "allreduce"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt.npz"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.multi_pod:
        raise SystemExit("--multi-pod needs a pod axis across devices; the "
                         "port runs its ring on one device")
    _run_lda(args)


def _run_lda(args):
    from repro_torch.core.nomad import NomadLDA
    from repro_torch.data import synthetic
    from repro_torch.data.sharding import build_layout
    from repro_torch.train import checkpoint

    T = args.topics
    corpus, _, _ = synthetic.make_corpus(
        num_docs=args.docs, vocab_size=4096, num_topics=T,
        mean_doc_len=80.0, seed=0)
    layout = build_layout(corpus, n_workers=args.workers, T=T)
    lda = NomadLDA(layout=layout, alpha=50.0 / T, beta=0.01,
                   sync_mode=args.sync, inner_mode="fused",
                   device=args.device)
    arrays = lda.init_arrays(seed=0)
    print(f"[lda] {corpus.num_tokens:,} tokens, {args.workers} workers on "
          f"{lda.dev}, sync={args.sync}")
    t0 = time.perf_counter()
    for it in range(args.sweeps):
        arrays = lda.sweep(arrays, seed=it)
        if (it + 1) % 10 == 0 or it == args.sweeps - 1:
            ll = lda.log_likelihood(arrays)
            rate = corpus.num_tokens * (it + 1) / (time.perf_counter() - t0)
            print(f"[lda] sweep {it + 1:4d} ll {ll:,.0f} ({rate:,.0f} "
                  f"tok/s on {lda.dev})")
    checkpoint.save(args.ckpt, {k: arrays[k]
                                for k in ("z", "n_td", "n_wt", "n_t")})
    print(f"[lda] checkpoint: {args.ckpt}")


if __name__ == "__main__":
    main()
