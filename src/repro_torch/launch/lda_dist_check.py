"""Nomad LDA correctness check of the port (``repro/launch/lda_dist_check.py``).

Usage:  python -m repro_torch.launch.lda_dist_check \\
            [--n-devices N] [--sync-mode M] [--pods P] [--inner-mode M] \\
            [--n-blocks B] [--ring-mode M] [--layout L] [--doc-tile D] \\
            [--r-mode M] [--resume-from CKPT] [--checkpoint-path CKPT] \\
            [--device DEV]

``--n-devices`` is the ring's W: the W workers run in lock step on one
device (CUDA unless ``--device`` says otherwise).  Runs 7 sweeps of Nomad
F+LDA on the reference's synthetic corpus and prints its JSON report:
count-table invariants (must be exact) and the log-likelihood trajectory
(must rise).  ``--layout`` picks the token geometry (``dense`` |
``ragged``); ``--doc-tile`` (0 = off) builds a doc-grouped layout and, in
fused mode, pages ``(doc_tile, T)`` slabs of ``n_td`` through the
kernel's shared memory; ``--r-mode sparse`` walks the per-document side
tables at the layout's ``r_cap``.

``--pods P`` is the reference's ``(pod, worker)`` mesh, whose flat ring is
the same W-ring: ``P`` must divide ``W``, and the chain is the one-pod
chain (the report carries ``pods``).  ``--checkpoint-path`` writes a chain
checkpoint after the last sweep and ``--resume-from`` starts from one, in
the reference's file format, so a checkpoint written by either package's
check resumes in the other.  The reference's positional form is not
ported.

``ref_sweep_sec`` is the median time of a fixed workload (16 products of
a 256 × 256 f32 matrix with itself) on the same device, timed between the
sweeps, so ``tokens_per_sec · ref_sweep_sec`` cancels the host's speed.
Exits non-zero unless every mismatch is 0 and the log-likelihood rose.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

__all__ = ["parse_args", "run_check", "passed", "main"]

N_SWEEPS = 7                     # the first, then 6 timed

_ARGS = [("n_devices", int, 8), ("sync_mode", str, "stoken"),
         ("pods", int, 1), ("inner_mode", str, "scan"),
         ("n_blocks", int, 0), ("ring_mode", str, "barrier"),
         ("layout", str, "dense"), ("doc_tile", int, 0),
         ("r_mode", str, "dense")]


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for name, typ, default in _ARGS:
        p.add_argument("--" + name.replace("_", "-"), type=typ,
                       default=default)
    p.add_argument("--resume-from", default="",
                   help="chain checkpoint to start from (fresh init if "
                        "unset)")
    p.add_argument("--checkpoint-path", default="",
                   help="write a chain checkpoint here after the last "
                        "sweep (consumable by --resume-from)")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA)")
    args = p.parse_args(argv)
    if args.pods < 1 or args.n_devices % args.pods:
        p.error(f"--pods {args.pods} must divide --n-devices "
                f"{args.n_devices}")
    args.n_blocks = args.n_blocks or args.n_devices
    return args


def _ref_step(x):
    """The fixed reference workload: 16 products of ``x`` with itself."""
    for _ in range(16):
        x = x @ x / 257.0
    return x


def run_check(args) -> dict:
    """Build, sweep and check → the report."""
    import torch

    from repro_torch._device import resolve
    from repro_torch.core.nomad import NomadLDA
    from repro_torch.data import synthetic
    from repro_torch.data.sharding import build_layout, counts_from_layout

    dev = resolve(args.device)
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    T = 16
    alpha, beta = 50.0 / T, 0.01
    corpus, _, _ = synthetic.make_corpus(
        num_docs=120, vocab_size=256, num_topics=T, mean_doc_len=30.0,
        seed=3)
    doc_kw = {}
    if args.doc_tile > 0:
        doc_kw = dict(doc_tile=args.doc_tile)
        if args.layout == "dense":
            doc_kw["doc_blk"] = 16      # toy-corpus grid step (cf. N_BLK)
    layout = build_layout(corpus, n_workers=args.n_devices, T=T,
                          n_blocks=args.n_blocks, layout=args.layout,
                          **doc_kw)
    r_cap = layout.r_cap if args.r_mode == "sparse" else 0
    lda = NomadLDA(layout=layout, alpha=alpha, beta=beta,
                   sync_mode=args.sync_mode, inner_mode=args.inner_mode,
                   ring_mode=args.ring_mode,
                   doc_tile=args.doc_tile if args.doc_tile > 0 else None,
                   r_mode=args.r_mode, r_cap=r_cap, device=dev)
    if args.resume_from:
        arrays, seed0 = lda.load_checkpoint(args.resume_from)
    else:
        arrays, seed0 = lda.init_arrays(seed=0), 0

    ref_x = torch.full((256, 256), 1.001, dtype=torch.float32, device=dev)
    _ref_step(ref_x)
    sync()
    lls = [lda.log_likelihood(arrays)]
    arrays = lda.sweep(arrays, seed=seed0)
    lls.append(lda.log_likelihood(arrays))
    sweep_times, ref_times = [], []
    for it in range(1, N_SWEEPS):
        t0 = time.perf_counter()
        _ref_step(ref_x)
        sync()
        ref_times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        arrays = lda.sweep(arrays, seed=seed0 + it)
        sync()
        sweep_times.append(time.perf_counter() - t0)
        lls.append(lda.log_likelihood(arrays))
    tokens_per_sec = corpus.num_tokens / max(float(np.median(sweep_times)),
                                             1e-9)
    if args.checkpoint_path:
        lda.save_checkpoint(args.checkpoint_path, arrays,
                            next_seed=seed0 + N_SWEEPS)

    n_td, n_wt, n_t = lda.global_counts(arrays)
    z = arrays["z"].cpu().numpy()
    n_td_ref, n_wt_ref, n_t_ref = counts_from_layout(layout, z, T)
    zz = layout.extract_canonical(z)
    return {
        "n_devices": args.n_devices,
        "sync_mode": args.sync_mode,
        "inner_mode": args.inner_mode,
        "ring_mode": args.ring_mode,
        "layout": layout.kind,
        "pods": args.pods,
        "n_blocks": layout.B,
        "blocks_per_worker": layout.k,
        "tokens_per_sec": tokens_per_sec,
        "ref_sweep_sec": float(np.median(ref_times)),
        "n_tokens": int(corpus.num_tokens),
        "ll": lls,
        "ll_improved": bool(lls[-1] > lls[0]),
        "n_td_mismatch": int(np.abs(n_td - n_td_ref).sum()),
        "n_wt_mismatch": int(np.abs(n_wt - n_wt_ref).sum()),
        "n_t_mismatch": int(np.abs(n_t - n_t_ref).sum()),
        "word_map_mismatch": layout.word_map_mismatches(),
        "z_in_range": bool(((zz >= 0) & (zz < T)).all()),
        "tokens_preserved": int(n_t.sum()) == int(corpus.num_tokens),
        "round_imbalance": layout.round_imbalance,
        "pad_fraction": layout.pad_fraction,
        "total_tiles": layout.total_tiles,
        "ragged_tile": layout.tile,
        "doc_tile": layout.doc_tile,
        "r_mode": args.r_mode,
        "r_cap": r_cap,
        "resumed_from": args.resume_from,
        "next_seed": seed0 + N_SWEEPS,
        "ntd_row_bytes": layout.ntd_row_bytes,
        "ntd_slab_bytes": layout.ntd_slab_bytes,
        "ntd_whole_bytes": layout.ntd_whole_bytes,
    }


def passed(report: dict) -> bool:
    """Every ``*_mismatch`` 0, the invariants true, the LL risen."""
    return (all(v == 0 for k, v in report.items()
                if k.endswith("_mismatch"))
            and report["ll_improved"] and report["z_in_range"]
            and report["tokens_preserved"])


def main(argv=None) -> int:
    report = run_check(parse_args(sys.argv[1:] if argv is None else argv))
    print(json.dumps(report))
    return 0 if passed(report) else 1


if __name__ == "__main__":
    sys.exit(main())
