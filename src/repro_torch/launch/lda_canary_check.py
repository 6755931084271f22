"""Padding-blowup canary of the port (``repro/launch/lda_canary_check.py``).

Usage:  python -m repro_torch.launch.lda_canary_check [n_workers] [reps] \\
            [--device DEV]

Times the ragged Nomad fused sweep at B = W and B = 4W **interleaved in
one process** (sweep A, sweep B, sweep A, ...) and reports the tokens a
second of each from the median sweep time, and their ratio.  The W
workers run in lock step on one device (CUDA unless ``--device`` says
otherwise), so the canary needs no collective.

Alternating single sweeps puts both configurations through the same
spells of host contention, so their ratio is stable even when the
absolute numbers are not.  Both runs use ``ring_mode="barrier"`` so the
comparison isolates the layout's cost.  The corpus, T and seeds are the
reference's: 120 documents, vocabulary 256, T = 16, corpus seed 3, the
arrays from seed 0 and sweep ``it`` from seed ``it``.

Prints one JSON report with the reference's keys:
``{"n_devices", "reps", "n_tokens", "tokens_per_sec_w",
"tokens_per_sec_4w", "ratio_4w_over_w"}``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

__all__ = ["parse_args", "run", "main"]


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_workers", nargs="?", type=int, default=4)
    p.add_argument("reps", nargs="?", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA)")
    return p.parse_args(argv)


def run(n_workers: int = 4, reps: int = 8, device=None) -> dict:
    """Build both layouts, run one sweep of each, then ``reps`` sweeps of
    each in turn, timed → the report."""
    import torch

    from repro_torch._device import resolve
    from repro_torch.core.nomad import NomadLDA
    from repro_torch.data import synthetic
    from repro_torch.data.sharding import build_layout

    dev = resolve(device)
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    T = 16
    alpha, beta = 50.0 / T, 0.01
    corpus, _, _ = synthetic.make_corpus(
        num_docs=120, vocab_size=256, num_topics=T, mean_doc_len=30.0,
        seed=3)
    runs = {}
    for B in (n_workers, 4 * n_workers):
        layout = build_layout(corpus, n_workers=n_workers, T=T, n_blocks=B,
                              layout="ragged")
        lda = NomadLDA(layout=layout, alpha=alpha, beta=beta,
                       sync_mode="stoken", inner_mode="fused",
                       ring_mode="barrier", device=dev)
        arrays = lda.sweep(lda.init_arrays(seed=0), seed=0)   # warm-up
        sync()
        runs[B] = (lda, arrays, [])
    for it in range(1, reps + 1):
        for B, (lda, arrays, times) in runs.items():
            t0 = time.perf_counter()
            arrays = lda.sweep(arrays, seed=it)
            sync()
            times.append(time.perf_counter() - t0)
            runs[B] = (lda, arrays, times)
    tps = {B: corpus.num_tokens / max(float(np.median(times)), 1e-9)
           for B, (_, _, times) in runs.items()}
    return {
        "n_devices": n_workers,
        "reps": reps,
        "n_tokens": int(corpus.num_tokens),
        "tokens_per_sec_w": tps[n_workers],
        "tokens_per_sec_4w": tps[4 * n_workers],
        "ratio_4w_over_w": tps[4 * n_workers] / tps[n_workers],
    }


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    print(json.dumps(run(args.n_workers, args.reps, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
