#!/usr/bin/env python3
"""Where a θ query's time goes in the PyTorch port on one NVIDIA GPU.

    python3 tools/profile_torch_serving.py

Serves ``LdaEngine`` queries of 1, 8 and 64 documents (the fused mode,
at ``chip_smoke.py``'s width and document lengths, against a φ snapshot
frozen from seeded Poisson(0.4) counts) and, per batch size,
prints one JSON line: the host-clock latency of the queries without the
profiler, then under ``torch.profiler`` the device time of the fold-in
kernel, the device time and launch count of every other kernel, and the
share of the wall time the device was busy.  Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from repro_torch.serve.lda_engine import (LdaEngine,  # noqa: E402
                                          TopicQuery, snapshot_from_counts)

QUERIES = 3      # per batch size, each timed bare and under the profiler


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_serving.py needs a CUDA device",
              file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(gpu)
    r = np.random.default_rng(cs.SEED)
    n_wt = r.poisson(0.4, (cs.J, cs.T)).astype(np.int32)
    snapshot = snapshot_from_counts(n_wt, n_wt.sum(0), alpha=cs.ALPHA,
                                    beta=cs.BETA)
    cdf = cs._zipf_cdf()
    pool = cs._docs(r, 200, cdf)
    engine = LdaEngine(snapshot)
    for n in (1, 8, 64):
        qs = [TopicQuery(docs=tuple(pool[(i * n + j) % len(pool)]
                                    for j in range(n)))
              for i in range(QUERIES)]
        for q in qs:                                  # warm every shape
            engine.query(q)
        t0 = time.perf_counter()
        for q in qs:
            engine.query(q)
        bare_ms = (time.perf_counter() - t0) * 1e3 / QUERIES
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for q in qs:
                engine.query(q)
            wall_ms = (time.perf_counter() - t0) * 1e3 / QUERIES
        kernels = [a for a in prof.key_averages()
                   if a.self_device_time_total > 0]
        fold = [a for a in kernels if "fold_in_kernel" in a.key]
        other = [a for a in kernels if "fold_in_kernel" not in a.key]
        fold_ms = sum(a.self_device_time_total for a in fold) / 1e3
        other_ms = sum(a.self_device_time_total for a in other) / 1e3
        top = sorted(other, key=lambda a: -a.self_device_time_total)[:3]
        print(json.dumps({
            "batch_docs": n, "queries": QUERIES,
            "latency_ms": bare_ms, "profiled_latency_ms": wall_ms,
            "fold_in_kernel_ms": fold_ms / QUERIES,
            "other_kernels_ms": other_ms / QUERIES,
            "other_launches": sum(a.count for a in other) // QUERIES,
            "device_busy_share": (fold_ms + other_ms) / QUERIES / wall_ms,
            "top_other": [[a.key[:60], a.self_device_time_total / 1e3
                           / QUERIES] for a in top],
            "gpu": gpu}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
