#!/usr/bin/env python3
"""Drive the PyTorch port's trainer and serving paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout's sources, then, at the
width of the paper's NYTimes runs (J=102,660 words, T=1024 topics):

1. holds the fused-sweep kernel against its plain PyTorch version on the
   card, bit for bit, in both r-modes: its single-stream form on a few
   thousand tokens, and its nomad-round form on the first round's W
   worker streams (cut to a few tiles), and times both;
2. trains: 30,000 NYTimes-shaped documents (Zipf word ids, geometric
   lengths of mean 332 clipped to [1, 2048]) go through
   ``build_layout(layout="ragged")`` with W=132 workers and B=264 blocks,
   then ``NomadLDA(inner_mode="fused", ring_mode="pipelined",
   sync_mode="stoken")`` runs 3 sweeps in dense r-mode and 1 in sparse;
   checks 2·W kernel launches per sweep, a rising log-likelihood and
   counts equal to those rebuilt from ``z``, and profiles one more dense
   sweep (kernel time, other kernels, busy share); then one serial
   ``cgs.sweep_fplda_word(backend="fused")`` sweep over 1,000 documents;
3. cross-checks a small run at T=1024, W=4: ``inner_mode="fused"`` equals
   ``"scan"`` bit for bit;
4. serves from the trained model: the φ snapshot of ``export_phi_snapshot``
   goes through the fold-in kernel against its plain version (a 64 × 512
   batch swept 20 times, with a document on all-zero φ rows and a masked
   one), then through ``LdaEngine`` queries of 1, 8 and 64 documents
   checked against the plain ``fold_in_batch`` and the serial ``fold_in``;
5. prints the card, the latencies, one JSON line describing each kernel,
   and last ``{"ok": true, "device": {...}}``.

Exits non-zero without a CUDA device, and when any check fails.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch import rng  # noqa: E402
from repro_torch.core import cgs  # noqa: E402
from repro_torch.core.heldout import doc_fold_key, fold_in  # noqa: E402
from repro_torch.core.nomad import NomadLDA  # noqa: E402
from repro_torch.data.corpus import Corpus  # noqa: E402
from repro_torch.data.sharding import (build_layout,  # noqa: E402
                                       counts_from_layout)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fold_in import fold_in as fold_in_mod  # noqa: E402
from repro_torch.kernels.fold_in import (fold_in_draws,  # noqa: E402
                                         fold_in_kernel_ref)
from repro_torch.kernels.fused_sweep import fused_sweep as fs_mod  # noqa
from repro_torch.kernels.fused_sweep import ops as fs_ops  # noqa: E402
from repro_torch.kernels.fused_sweep import rbucket  # noqa: E402
from repro_torch.kernels.fused_sweep.ref import (  # noqa: E402
    fused_sweep_ref, sweep_streams_ref)
from repro_torch.serve.lda_engine import LdaEngine, TopicQuery  # noqa

SEED = 0
J, T = 102_660, 1024             # UCI NYTimes vocabulary, the paper's T
ALPHA, BETA = 50.0 / T, 0.01
DOCS, W, B = 30_000, 132, 264    # a tenth of NYTimes; one worker per SM
DENSE_SWEEPS = 3
SERIAL_DOCS = 1_000
D, L, SWEEPS = 64, 512, 20       # the fold-in kernel phase's batch
MEAN_LEN, MAX_LEN = 332, 2048    # NYTimes: ~100M tokens over ~300k docs
OUTLIER_LEN = 4000
STREAM_TOKENS = 3_000            # the single-stream kernel check
ROUND_TILES = 8                  # the nomad-round kernel check, per stream
H100_HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12       # f32 outside the tensor cores
REPS = {1: 40, 8: 20, 64: 8}     # timed queries per batch size
DEV = "cuda"


def _zipf_cdf() -> np.ndarray:
    """The cdf of a Zipf law over the vocabulary (frequency ∝ 1/rank)."""
    zipf = 1.0 / np.arange(1, J + 1)
    cdf = np.cumsum(zipf / zipf.sum())
    cdf[-1] = 1.0
    return cdf


def _lengths(r: np.random.Generator, n: int) -> np.ndarray:
    return np.clip(r.geometric(1.0 / MEAN_LEN, n), 1, MAX_LEN)


def _docs(r: np.random.Generator, n: int, cdf: np.ndarray) -> list:
    """``n`` NYTimes-shaped documents of Zipf word ids."""
    return [np.searchsorted(cdf, r.random(k)).astype(np.int32)
            for k in _lengths(r, n)]


def nytimes_corpus(r: np.random.Generator, cdf: np.ndarray) -> Corpus:
    """``DOCS`` documents, built directly (the reference's
    ``make_corpus`` gathers an ``(N, vocab)`` cdf and cannot reach this
    width)."""
    lens = _lengths(r, DOCS)
    doc_ids = np.repeat(np.arange(DOCS, dtype=np.int32), lens)
    word_ids = np.searchsorted(cdf, r.random(doc_ids.size)).astype(np.int32)
    return Corpus(doc_ids=doc_ids, word_ids=word_ids, num_docs=DOCS,
                  num_words=J)


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _event_ms(fn, reps: int) -> float:
    start, end = _events()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed(fn):
    """``fn()``'s result and its device time in ms (one run)."""
    start, end = _events()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _same(name: str, got, want) -> int:
    """Fail unless every tensor pair is equal; returns the max abs error."""
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        err = max(err, float((g.double() - w.double()).abs().max())
                  if g.numel() else 0.0)
        if not torch.equal(g, w):
            raise SystemExit(f"{name}: output {i} differs from the plain "
                             f"version (max abs err {err})")
    return err


def _sweep_bound(valid: int, bounds: int, slots: int, docs: int,
                 words: int, cap: int, sparse: bool):
    """The least time for a sweep's work on this card, from this run's
    data: the token stream read once and ``z`` written (24 + 4 B a slot),
    each touched ``n_td`` and ``n_wt`` row read and written once (and the
    side-table rows in sparse mode); per valid token the compaction
    (T compares, or 4·cap table ops), products, scan and pick (3·cap) and
    2·(log2 T + 1) path adds, per boundary 3·T for the rebuild."""
    row = 4 * T
    nbytes = (28 * slots + 2 * row * (docs + words)
              + (2 * 8 * cap * docs if sparse else 0))
    per_token = (4 * cap if sparse else T) + 3 * cap + 2 * (
        int(math.log2(T)) + 1)
    ops = valid * per_token + bounds * 3 * T
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _stream_phase(arrays, lay, r: np.random.Generator) -> dict:
    """The single-stream form (#2) against its plain version: a few
    thousand word-sorted tokens of worker 0's documents against block 0
    of the trainer's initial ``n_wt``, both r-modes."""
    I = lay.I_max
    docs = np.sort(r.integers(0, I, STREAM_TOKENS)).astype(np.int32)
    wrd = np.sort(r.integers(0, lay.J_max, STREAM_TOKENS)).astype(np.int32)
    z = r.integers(0, T, STREAM_TOKENS).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=DEV)
    n_td = arrays["n_td"][0].clone()
    n_wt = arrays["n_wt"][0].clone()
    n_td.index_put_((t(docs).long(), t(z).long()),
                    torch.ones(STREAM_TOKENS, dtype=torch.int32,
                               device=DEV), accumulate=True)
    n_wt.index_put_((t(wrd).long(), t(z).long()),
                    torch.ones(STREAM_TOKENS, dtype=torch.int32,
                               device=DEV), accumulate=True)
    n_t = n_wt.sum(0, dtype=torch.int32) + arrays["n_t"]
    starts = np.concatenate([[1], wrd[1:] != wrd[:-1]]).astype(np.int32)
    args = (t(docs), t(wrd), t(np.ones(STREAM_TOKENS, np.int32)), t(starts),
            t(z), t(r.random(STREAM_TOKENS).astype(np.float32)), n_td,
            n_wt, n_t)
    out = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0}
    for r_mode in ("dense", "sparse"):
        kw = dict(alpha=ALPHA, beta=BETA, beta_bar=BETA * J, r_mode=r_mode)
        got, ms = _timed(lambda: fs_ops.fused_sweep_tokens(*args, **kw))
        plain, plain_ms = _timed(lambda: fused_sweep_ref(*args, **kw))
        out["err"] = max(out["err"], _same(f"fused_sweep {r_mode}", got,
                                           plain))
        bound, by = _sweep_bound(STREAM_TOKENS, int(starts.sum()),
                                 STREAM_TOKENS, np.unique(docs).size,
                                 np.unique(wrd).size, T,
                                 r_mode == "sparse")
        print(f"fused_sweep ({r_mode}): {STREAM_TOKENS} tokens, kernel "
              f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound:.5f} ms "
              f"({by}), equal")
        if r_mode == "dense":
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, by=by)
    return out


def _round_phase(model: NomadLDA, arrays) -> dict:
    """The nomad-round form (#4) against its plain version: round 0's W
    worker streams, tiles [0, ROUND_TILES), both r-modes."""
    lay = model.layout
    workers = torch.arange(W, device=DEV)
    keys = rng.fold_in(rng.key(SEED, DEV), workers)
    cot, slot = arrays["cell_of_tile"], arrays["tok_slot"]
    cell_tok = cot[workers, workers].long().repeat_interleave(lay.tile, 1)
    uid = (workers[:, None] * lay.k + cell_tok) * lay.L + slot[workers,
                                                               workers]
    u = rng.token_uniforms(rng.fold_in(keys, 0), uid)
    span = slice(0, ROUND_TILES * lay.tile)
    diag = lambda a: a[workers, workers][:, span]
    valid = diag(arrays["tok_valid"]) != 0
    starts = diag(arrays["tok_bound"])
    n_valid = int(valid.sum())
    doc_rows = diag(arrays["tok_doc"]) + workers[:, None] * lay.I_max
    word_rows = ((cell_tok[:, span] + workers[:, None] * lay.k) * lay.J_max
                 + diag(arrays["tok_wrd"]))
    rows_d = int(torch.unique(doc_rows[valid]).numel())
    rows_w = int(torch.unique(word_rows[valid]).numel())
    out = {"err": 0}
    for r_mode in ("dense", "sparse"):
        runs = {}
        for name, sweep in (("kernel", fs_mod.sweep_streams_cuda),
                            ("plain", sweep_streams_ref)):
            a = {k: arrays[k].clone() for k in ("z", "n_td", "n_wt")}
            n_t = arrays["n_t"].expand(W, T).contiguous()
            tables = {}
            if r_mode == "sparse":
                tpc, cnt = rbucket.build_side_table(
                    a["n_td"].view(-1, T), T)
                tables = dict(topics=tpc, counts=cnt)
            F, ms = _timed(lambda: sweep(
                arrays["tok_doc"], arrays["tok_wrd"], arrays["tok_valid"],
                arrays["tok_bound"], a["z"], u, cot, a["n_td"].view(-1, T),
                a["n_wt"].view(-1, T), n_t, r=0, k=lay.k, tile=lay.tile,
                tile_start=0, num_tiles=ROUND_TILES, I_max=lay.I_max,
                J_max=lay.J_max, alpha=ALPHA, beta=BETA,
                beta_bar=model.beta_bar, cap=T, **tables))
            runs[name] = ([a["z"], a["n_td"], a["n_wt"], n_t, F]
                          + list(tables.values()), ms)
        out["err"] = max(out["err"], _same(f"fused_sweep_ragged {r_mode}",
                                           runs["kernel"][0],
                                           runs["plain"][0]))
        bound, by = _sweep_bound(n_valid, int(starts.sum()),
                                 W * ROUND_TILES * lay.tile, rows_d, rows_w,
                                 T, r_mode == "sparse")
        print(f"fused_sweep_ragged ({r_mode}): {W} streams x "
              f"{ROUND_TILES} tiles of {lay.tile}, {n_valid} valid tokens, "
              f"kernel {runs['kernel'][1]:.3f} ms, plain "
              f"{runs['plain'][1]:.1f} ms, bound {bound:.5f} ms ({by}), "
              f"equal")
        if r_mode == "dense":
            out.update(ms=runs["kernel"][1], plain_ms=runs["plain"][1],
                       bound_ms=bound, by=by)
    return out


def _mismatches(model: NomadLDA, arrays) -> int:
    lay = model.layout
    got = model.global_counts(arrays)
    want = counts_from_layout(lay, arrays["z"].cpu().numpy(), T)
    return int(sum(np.abs(g - w).sum() for g, w in zip(got, want)))


def _train_phase(corpus: Corpus, model: NomadLDA, arrays, gpu: str):
    """3 dense sweeps and 1 sparse through the kernel, with the checks."""
    lay = model.layout
    n_tok = corpus.num_tokens
    ll0 = model.log_likelihood(arrays)
    sparse = NomadLDA(layout=lay, alpha=ALPHA, beta=BETA, sync_mode="stoken",
                      inner_mode="fused", ring_mode="pipelined",
                      r_mode="sparse", device=DEV)
    fs_mod.launches["fused_sweep_ragged"] = 0
    times = []
    for s in range(DENSE_SWEEPS + 1):
        trainer = model if s < DENSE_SWEEPS else sparse
        if s == DENSE_SWEEPS:
            tpc, cnt = rbucket.build_side_table(arrays["n_td"].view(-1, T),
                                                T)
            shape = (lay.W, lay.I_max, T)
            arrays = dict(arrays, rb_topics=tpc.view(shape),
                          rb_counts=cnt.view(shape))
        torch.cuda.synchronize()
        host = time.perf_counter()
        arrays, ms = _timed(lambda: trainer.sweep(arrays, s))
        host = time.perf_counter() - host
        times.append((trainer.r_mode, ms, host))
        print(json.dumps({"sweep": s, "r_mode": trainer.r_mode,
                          "device_ms": ms, "host_s": host,
                          "tokens_per_s": n_tok / host, "gpu": gpu}))
    launches = fs_mod.launches["fused_sweep_ragged"]
    if launches != 2 * W * (DENSE_SWEEPS + 1):
        raise SystemExit(f"{launches} kernel launches for "
                         f"{DENSE_SWEEPS + 1} sweeps; want 2·W each")
    _profile_sweep(model, arrays, gpu)
    ll1 = model.log_likelihood(arrays)
    bad = _mismatches(model, arrays)
    print(f"log-likelihood {ll0:.6e} -> {ll1:.6e}, count mismatches {bad}, "
          f"kernel launches {launches}")
    if not ll1 > ll0:
        raise SystemExit("the log-likelihood did not rise")
    if bad:
        raise SystemExit(f"{bad} count mismatches against z")
    return arrays, launches


def _profile_sweep(model: NomadLDA, arrays, gpu: str) -> None:
    """One more dense sweep under ``torch.profiler``, its result dropped:
    the kernel's device time, every other kernel's, and the share of the
    wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = time.perf_counter()
        model.sweep(arrays, DENSE_SWEEPS + 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - wall) * 1e3
    kernels = [a for a in prof.key_averages()
               if a.self_device_time_total > 0]
    mine = [a for a in kernels if "fused_sweep_kernel" in a.key]
    other = [a for a in kernels if "fused_sweep_kernel" not in a.key]
    kernel_ms = sum(a.self_device_time_total for a in mine) / 1e3
    other_ms = sum(a.self_device_time_total for a in other) / 1e3
    print(json.dumps({
        "profiled_sweep_ms": wall, "fused_sweep_kernel_ms": kernel_ms,
        "kernel_launches": sum(a.count for a in mine),
        "other_kernels_ms": other_ms,
        "other_launches": sum(a.count for a in other),
        "device_busy_share": (kernel_ms + other_ms) / wall, "gpu": gpu}))


def _serial_phase(corpus: Corpus) -> int:
    """One serial sweep (the single-stream form) over the first
    SERIAL_DOCS documents; returns its launches."""
    keep = corpus.doc_ids < SERIAL_DOCS
    sub = Corpus(doc_ids=corpus.doc_ids[keep], word_ids=corpus.word_ids[keep],
                 num_docs=SERIAL_DOCS, num_words=J)
    state = cgs.init_state(sub, T, rng.key(SEED, DEV))
    order = sub.word_order()
    bound = sub.word_boundary(order)
    fs_mod.launches["fused_sweep"] = 0
    torch.cuda.synchronize()
    host = time.perf_counter()
    after = cgs.sweep_fplda_word(state, sub.doc_ids, sub.word_ids, order,
                                 bound, ALPHA, BETA, backend="fused")
    torch.cuda.synchronize()
    host = time.perf_counter() - host
    launches = fs_mod.launches["fused_sweep"]
    bad = cgs.check_invariants(after, sub)
    print(f"serial sweep: {sub.num_tokens} tokens in {host:.3f} s, "
          f"launches {launches}, invariants {bad}")
    if launches != 1 or any(bad.values()):
        raise SystemExit("the serial fused sweep failed its checks")
    return launches


def _cross_check_phase(r: np.random.Generator, cdf: np.ndarray) -> None:
    """A small run at T=1024, W=4: fused equals scan, bit for bit."""
    docs = [d[:40] for d in _docs(r, 48, cdf)]
    corpus = Corpus(
        doc_ids=np.repeat(np.arange(48, dtype=np.int32),
                          [d.size for d in docs]),
        word_ids=np.concatenate(docs), num_docs=48, num_words=J)
    lay = build_layout(corpus, n_workers=4, T=T, n_blocks=8,
                       layout="ragged")
    out = {}
    for r_mode in ("dense", "sparse"):
        for mode in ("fused", "scan"):
            m = NomadLDA(layout=lay, alpha=ALPHA, beta=BETA,
                         inner_mode=mode, ring_mode="pipelined",
                         r_mode=r_mode, device=DEV)
            a = m.init_arrays(SEED)
            for s in range(2):
                a = m.sweep(a, s)
            out[mode] = a
        keys = sorted(out["fused"])
        _same(f"small run {r_mode}: fused vs scan",
              [out["fused"][k] for k in keys],
              [out["scan"][k] for k in keys])
    print(f"small run: {corpus.num_tokens} tokens, W=4, B=8, T={T}: fused "
          f"== scan after 2 sweeps, both r-modes")


def _fold_in_phase(phi: torch.Tensor, cdf: np.ndarray,
                   r: np.random.Generator) -> dict:
    """The fold-in kernel against its plain version at the main path's
    width."""
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
    plain, plain_ms = _timed(
        lambda: fold_in_kernel_ref(w, v, z0, u, ALPHA, phi_k))
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


def _sweep_entry(name: str, replaces: str, res: dict, launches: int):
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/fused_sweep/csrc/"
                      "fused_sweep.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": res["err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["by"], "library_ms": None}


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
    cdf = _zipf_cdf()
    t0 = time.perf_counter()
    corpus = nytimes_corpus(r, cdf)
    print(f"corpus: {DOCS} docs, {corpus.num_tokens} tokens in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lay = build_layout(corpus, n_workers=W, T=T, n_blocks=B,
                       layout="ragged")
    print(f"layout: {time.perf_counter() - t0:.1f} s on the host; tile "
          f"{lay.tile}, {lay.n_tiles} tiles a stream (split at "
          f"{lay.tile_split}), I_max {lay.I_max}, J_max {lay.J_max}, pad "
          f"fraction {lay.pad_fraction:.3f}, round imbalance "
          f"{lay.round_imbalance:.3f}")
    model = NomadLDA(layout=lay, alpha=ALPHA, beta=BETA, sync_mode="stoken",
                     inner_mode="fused", ring_mode="pipelined", device=DEV)
    t0 = time.perf_counter()
    arrays = model.init_arrays(SEED)
    torch.cuda.synchronize()
    print(f"init arrays: {time.perf_counter() - t0:.1f} s")

    stream = _stream_phase(arrays, lay, r)
    ragged = _round_phase(model, arrays)
    arrays, ragged_launches = _train_phase(corpus, model, arrays, gpu)
    serial_launches = _serial_phase(corpus)
    _cross_check_phase(r, cdf)

    snapshot = model.export_phi_snapshot(arrays, sweep=DENSE_SWEEPS + 1)
    phi = torch.tensor(snapshot.phi, device=DEV)
    fold = _fold_in_phase(phi, cdf, r)
    fold["launches"] = _serving_phase(snapshot, phi, cdf, r, gpu)
    kernels = [
        fold,
        _sweep_entry("fused_sweep",
                     "src/repro/kernels/fused_sweep/fused_sweep.py:267",
                     stream, serial_launches),
        _sweep_entry("fused_sweep_ragged",
                     "src/repro/kernels/fused_sweep/fused_sweep.py:491",
                     ragged, ragged_launches)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
