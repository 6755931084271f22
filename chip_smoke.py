#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout's sources, then:

1. holds the CUDA fold-in kernel against its plain PyTorch version on the
   card, bit for bit, at the paper's NYTimes width (J=102,660 words,
   T=1024 topics) on a full 64 x 512 batch swept 20 times, including a
   document whose tokens all hit all-zero φ rows and a fully masked one,
   and times both;
2. serves θ queries of 1, 8 and 64 documents through ``LdaEngine`` (the
   fused mode, i.e. the kernel) against a φ snapshot frozen from seeded
   counts, with NYTimes-like document lengths, an empty document and an
   outlier long enough to split the length buckets; checks θ and the
   counts against the plain ``fold_in_batch`` and the serial ``fold_in``
   on the card, and that the queries launched the kernel;
3. prints the latency per batch size, one JSON line describing each
   kernel, and last ``{"ok": true, "device": {...}}``.

Exits non-zero without a CUDA device, and when any check fails.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch import rng  # noqa: E402
from repro_torch.core.heldout import doc_fold_key, fold_in  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fold_in import fold_in as fold_in_mod  # noqa: E402
from repro_torch.kernels.fold_in import (fold_in_draws,  # noqa: E402
                                         fold_in_kernel_ref)
from repro_torch.serve.lda_engine import (LdaEngine,  # noqa: E402
                                          TopicQuery, snapshot_from_counts)

SEED = 0
J, T = 102_660, 1024             # UCI NYTimes vocabulary, the paper's T
ALPHA, BETA = 50.0 / T, 0.01
D, L, SWEEPS = 64, 512, 20       # the kernel phase's batch
MEAN_LEN, MAX_LEN = 332, 2048    # NYTimes: ~100M tokens over ~300k docs
OUTLIER_LEN = 4000
H100_HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12       # f32 outside the tensor cores
REPS = {1: 40, 8: 20, 64: 8}     # timed queries per batch size
DEV = "cuda"


def workload(r: np.random.Generator):
    """The φ snapshot frozen from seeded Poisson counts at the NYTimes
    width, and the cdf of a Zipf law over the vocabulary (word frequency
    ∝ 1/rank) that the documents draw their word ids from."""
    n_wt = r.poisson(0.4, (J, T)).astype(np.int32)
    snapshot = snapshot_from_counts(n_wt, n_wt.sum(0), alpha=ALPHA,
                                    beta=BETA)
    zipf = 1.0 / np.arange(1, J + 1)
    cdf = np.cumsum(zipf / zipf.sum())
    cdf[-1] = 1.0
    return snapshot, cdf


def _docs(r: np.random.Generator, n: int, cdf: np.ndarray) -> list:
    """``n`` documents with geometric lengths of mean 332, clipped to
    [1, 2048], over Zipf-distributed word ids."""
    lens = np.clip(r.geometric(1.0 / MEAN_LEN, n), 1, MAX_LEN)
    return [np.searchsorted(cdf, r.random(k)).astype(np.int32)
            for k in lens]


def _event_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_phase(phi: torch.Tensor, cdf: np.ndarray,
                  r: np.random.Generator) -> dict:
    """The kernel against its plain version at the main path's width."""
    dev = phi.device
    phi_k = phi.clone()
    zero_words = torch.arange(7, device=dev)           # all-zero φ rows
    phi_k[zero_words] = 0.0
    lens = np.clip(r.geometric(1.0 / MEAN_LEN, D), 1, L)
    lens[0], lens[1], lens[2] = L, 0, L                # full, masked, full
    words = np.zeros((D, L), np.int32)
    for i, n in enumerate(lens):
        words[i, :n] = np.searchsorted(cdf, r.random(n))
    words[2] = np.arange(L) % 7                        # zero-φ document
    valid = np.arange(L)[None, :] < lens[:, None]
    w = torch.as_tensor(words, device=dev)
    v = torch.as_tensor(valid.astype(np.int32), device=dev)
    keys = doc_fold_key(rng.key(SEED, dev), torch.arange(D, device=dev))
    z0, u = fold_in_draws(keys, L, T, SWEEPS)
    u_flat = u.reshape(D, SWEEPS * L)

    def kernel():
        return fold_in_mod.fold_in_cuda(w, v, z0, u_flat, ALPHA, phi_k)

    got = kernel()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    plain = fold_in_kernel_ref(w, v, z0, u, ALPHA, phi_k)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    err = int((got - plain).abs().max())
    if not torch.equal(got, plain):
        rows = torch.nonzero((got != plain).any(1)).flatten().tolist()
        raise SystemExit(f"fold_in kernel disagrees with its plain version "
                         f"in rows {rows[:10]} (max abs err {err})")
    sums = got.sum(1).cpu().numpy()
    if not np.array_equal(sums, lens) or got[1].any():
        raise SystemExit("fold_in kernel counts do not sum to the lengths")
    ms = _event_ms(kernel, 5)
    valid_steps = int(lens.sum()) * SWEEPS
    rows_needed = np.unique(words[valid]).size
    bytes_moved = (3 * D * L * 4 + D * SWEEPS * L * 4 + rows_needed * T * 4
                   + D * T * 4)
    ops = valid_steps * 5 * T      # add α, multiply, scan add, 2 compares
    t_bytes = bytes_moved / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    print(f"fold_in kernel: D={D} L={L} T={T} J={J} sweeps={SWEEPS} "
          f"valid steps={valid_steps} phi rows={rows_needed} "
          f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, equal counts")
    return {"name": "fold_in", "route": "cuda",
            "source": "src/repro_torch/kernels/fold_in/csrc/fold_in.cu",
            "replaces": "src/repro/kernels/fold_in/fold_in.py:83",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def _check_answer(res, docs) -> None:
    if not np.isfinite(res.theta).all():
        raise SystemExit("non-finite θ")
    if not np.allclose(res.theta.sum(1), 1.0, rtol=0, atol=1e-5):
        raise SystemExit(f"θ rows do not sum to 1: {res.theta.sum(1)}")
    if not np.array_equal(res.n_td.sum(1), [d.size for d in docs]):
        raise SystemExit("fold-in counts do not sum to the lengths")


def _serving_phase(snapshot, phi: torch.Tensor, cdf: np.ndarray,
                   r: np.random.Generator, gpu: str) -> int:
    """LdaEngine queries of 1, 8 and 64 docs; returns kernel launches."""
    pool = _docs(r, 200, cdf)
    pool[3] = np.zeros(0, np.int32)                    # an empty document
    outlier = np.searchsorted(cdf, r.random(OUTLIER_LEN)).astype(np.int32)
    t0 = time.perf_counter()
    engine = LdaEngine(snapshot, device=DEV)           # fused: the kernel
    print(f"publish: {time.perf_counter() - t0:.3f} s")
    queries = {n: [] for n in REPS}
    for n, reps in REPS.items():
        for i in range(reps):
            docs = [pool[(i * n + j) % len(pool)] for j in range(n)]
            if n == 64 and i == 0:
                docs[-1] = outlier
            queries[n].append(docs)
    engine.query(TopicQuery(docs=tuple(queries[8][0])))   # warm up

    fold_in_mod.launches = 0
    answers = {}
    for n, qs in queries.items():
        lat = []
        wall = time.perf_counter()
        for docs in qs:
            res = engine.query(TopicQuery(docs=tuple(docs)))
            lat.append(res.latency_s)
            answers.setdefault(n, res)
            _check_answer(res, docs)
        wall = time.perf_counter() - wall
        print(json.dumps({
            "batch_docs": n, "queries": len(qs),
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "docs_per_s": n * len(qs) / wall, "gpu": gpu}))
    launches = fold_in_mod.launches
    if launches == 0:
        raise SystemExit("the queries never launched the fold-in kernel")
    shapes = answers[64].batch_shape
    if not (isinstance(shapes[0], tuple)
            and max(s[1] for s in shapes) >= OUTLIER_LEN):
        raise SystemExit(f"the outlier did not split the length buckets: "
                         f"{shapes}")

    # The 8-document answer against the plain fold_in_batch on the card.
    docs8 = queries[8][0]
    scan = LdaEngine(snapshot, inner_mode="scan", device=DEV).query(
        TopicQuery(docs=tuple(docs8)))
    if not (np.array_equal(scan.n_td, answers[8].n_td)
            and np.array_equal(scan.theta, answers[8].theta)):
        raise SystemExit("fused and plain fold_in_batch answers differ")
    # Two of its documents through the serial fold_in: rows keep their
    # query index, which names their RNG stream.
    pick = sorted((i for i, d in enumerate(docs8) if d.size),
                  key=lambda i: docs8[i].size)[:2]
    serial = fold_in(np.concatenate([docs8[i] for i in pick]),
                     np.repeat(pick, [docs8[i].size for i in pick]),
                     max(pick) + 1, phi, snapshot.alpha, rng.key(0, DEV),
                     engine.sweeps).cpu().numpy()
    if not np.array_equal(serial[pick], answers[8].n_td[pick]):
        raise SystemExit("batched and serial fold-in differ")
    print(f"checks: 8-doc fused == plain fold_in_batch, docs {pick} "
          f"batched == serial fold_in, kernel launches={launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(gpu)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")

    r = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    snapshot, cdf = workload(r)
    print(f"snapshot {snapshot.phi.shape} in "
          f"{time.perf_counter() - t0:.1f} s")

    phi = torch.tensor(snapshot.phi, device=DEV)
    kernel = _kernel_phase(phi, cdf, r)
    kernel["launches"] = _serving_phase(snapshot, phi, cdf, r, gpu)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
