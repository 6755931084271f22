#!/usr/bin/env python3
"""Drive the PyTorch port's trainer and serving paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout's sources, then, at the
width of the paper's NYTimes runs (J=102,660 words, T=1024 topics, 30,000
NYTimes-shaped documents: Zipf word ids, geometric lengths of mean 332
clipped to [1, 2048]; W=132 workers, B=264 blocks):

1. holds the fused-sweep kernel's single-stream and ragged-round forms
   against their plain PyTorch versions on the card, bit for bit, in both
   r-modes, and times them;
2. trains on ``build_layout(layout="ragged")``: ``NomadLDA(inner_mode=
   "fused", ring_mode="pipelined", sync_mode="stoken")`` runs 3 sweeps in
   dense r-mode and 1 in sparse; checks 2·W launches a sweep, a rising
   log-likelihood and counts equal to those rebuilt from ``z``, profiles
   one more dense sweep; on the trained run, holds the ``lda_scores``
   rows form (65,536 tokens) against its plain version, drives the
   batched F+tree ops' own path (2**20 draws from the top word's tree,
   one update by those draws, 2**20 draws again) and holds its results
   and both kernels at its shapes against the plain versions, then at
   T = 16,384 and with 65,536 integer and real updates; then trains
   ``NomadLDA(inner_mode="vectorized")`` 3 sweeps from fresh arrays (264
   ``lda_scores`` pass launches a sweep, a rising log-likelihood, counts
   equal to ``z``), one more profiled, and holds the pass form against
   its plain version on its first launch's tokens (round 0, cell 0);
   then one serial ``cgs.sweep_fplda_word(backend="fused")`` sweep over
   1,000 documents;
3. (a) the dense cell grid: the cell form against its plain version on
   round 0's queues, then ``build_layout(layout="dense")`` through the
   same schedule, its canonical ``z``, global counts and ``n_t`` equal to
   the ragged run's after every sweep, and its φ snapshot too; then the
   vectorized mode on the grid, its chain equal to the ragged vectorized
   run's after every sweep;
4. (b) ``build_layout(layout="ragged", doc_tile=32)``: the paged ragged
   and paged single-stream forms against their plain versions on cut
   streams that reach the last, partial slab; 1 dense and 1 sparse sweep
   paged (``NomadLDA(doc_tile=32)``) and unpaged, equal; the single-stream
   form over worker 0's streams, paged equal to unpaged; (c)
   ``build_layout(layout="dense", doc_tile=32)``: the paged cell form
   against its plain version, then 1 dense and 1 sparse sweep paged, equal
   to (b);
5. cross-checks small runs at T=1024, W=4 in both r-modes: dense equals
   ragged equals scan, and on a grouped layout paged equals unpaged
   equals scan, dense equals ragged, in both ring modes;
6. serves from the ragged run's φ snapshot: the fold-in kernel against
   its plain version (a 64 × 512 batch swept 20 times, with a document on
   all-zero φ rows and a masked one), then ``LdaEngine`` queries of 1, 8
   and 64 documents checked against the plain ``fold_in_batch`` and the
   serial ``fold_in``;
7. prints the card, the latencies, one JSON line describing each kernel
   (its launches read from the run of its path, every count set to 0
   just before), and last ``{"ok": true, "device": {...}}``.

Exits non-zero without a CUDA device, and when any check fails.
"""
from __future__ import annotations

import importlib
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
from repro_torch.core import ftree  # noqa: E402
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
from repro_torch.kernels.ftree_sample import (ftree_sample,  # noqa: E402
                                              ftree_sample_ref)
from repro_torch.kernels.ftree_update import (  # noqa: E402
    ftree_update_batch, ftree_update_ref)
from repro_torch.kernels.lda_scores import lda_scores as ls_mod  # noqa
from repro_torch.kernels.lda_scores import (lda_scores_draw,  # noqa: E402
                                            lda_scores_draw_ref)
from repro_torch.kernels.lda_scores.ops import apply_deltas  # noqa
from repro_torch.kernels.lda_scores.ref import (  # noqa: E402
    lda_scores_pass_ref)
from repro_torch.serve.lda_engine import LdaEngine, TopicQuery  # noqa

# The packages export the ops under their wrapper modules' names.
fs_sample = importlib.import_module(
    "repro_torch.kernels.ftree_sample.ftree_sample")
fs_update = importlib.import_module(
    "repro_torch.kernels.ftree_update.ftree_update")

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
DOC_TILE = 32                    # doc rows a slab in the grouped runs
CELL_SLOTS = 160                 # the cell form's check: slots a cell
DOCS_TILES = 8                   # the paged ragged check: tiles a stream
DOCS_BLKS = 2                    # the paged cell check: doc_blk steps a cell
STREAM_TILES = 24                # the paged single-stream check: tiles
AB_ROUNDS = 4                    # rounds timed paged and unpaged in turns
PALLAS = "src/repro/kernels/fused_sweep/fused_sweep.py"
#: Each fused-sweep form and the line of the TPU kernel it replaces.
REPLACES = {"fused_sweep": 267, "fused_sweep_cells": 376,
            "fused_sweep_ragged": 491, "fused_sweep_docs": 660,
            "fused_sweep_cells_docs": 800, "fused_sweep_ragged_docs": 928}
VEC_SWEEPS = 3                   # vectorized sweeps a layout
ROWS_TOKENS = 65_536             # the rows form's check
DRAWS = 1_048_576                # draws on the batched F+tree path
UPDATES = 65_536                 # updates a case of the F+tree update check
BIG_T = 16_384                   # the largest tree one CTA holds
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
    """``fn``'s mean device time over ``reps`` runs, after one untimed."""
    fn()
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


def _bytes_ops_bound(nbytes: float, ops: float):
    """The larger of the bytes over the memory rate and the f32 operations
    over the f32 rate, in ms, and which one it is."""
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _sweep_bound(valid: int, bounds: int, slots: int, docs: int,
                 words: int, cap: int, sparse: bool):
    """The least time for a sweep's work on this card, from this run's
    data: the token stream read once and ``z`` written (24 + 4 B a slot),
    each touched ``n_td`` and ``n_wt`` row read and written once (and the
    side-table rows in sparse mode); per valid token the compaction (T
    compares, or 4·cap table ops), products, scan and pick (3·cap) and
    2·(log2 T + 1) path adds, per boundary 3·T for the rebuild.  A paged
    sweep needs the same: its slab copies are the kernel's way of moving
    the touched rows, and the rows around them that no token touches are
    not part of the work."""
    row = 4 * T
    nbytes = (28 * slots + 2 * row * (docs + words)
              + (2 * 8 * cap * docs if sparse else 0))
    per_token = (4 * cap if sparse else T) + 3 * cap + 2 * (
        int(math.log2(T)) + 1)
    return _bytes_ops_bound(nbytes, valid * per_token + bounds * 3 * T)


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


def _mismatches(model: NomadLDA, arrays) -> int:
    lay = model.layout
    got = model.global_counts(arrays)
    want = counts_from_layout(lay, arrays["z"].cpu().numpy(), T)
    return int(sum(np.abs(g - w).sum() for g, w in zip(got, want)))


def _zero_counts() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    for name in fs_mod.launches:
        fs_mod.launches[name] = 0
    for name in ls_mod.launches:
        ls_mod.launches[name] = 0
    fold_in_mod.launches = fs_sample.launches = fs_update.launches = 0


def _all_launches() -> dict:
    return {**fs_mod.launches, **ls_mod.launches,
            "fold_in": fold_in_mod.launches,
            "ftree_sample": fs_sample.launches,
            "ftree_update": fs_update.launches}


def _with_tables(arrays, lay):
    """The arrays plus sparse r-mode side tables built from ``n_td``."""
    tpc, cnt = rbucket.build_side_table(arrays["n_td"].view(-1, T), T)
    shape = (lay.W, lay.I_max, T)
    return dict(arrays, rb_topics=tpc.view(shape), rb_counts=cnt.view(shape))


def _chain_state(lay, arrays, canon: torch.Tensor) -> dict:
    """The chain in layout-free terms, on the card: ``z`` in canonical
    token order and the counts as ``NomadLDA.global_counts`` maps them
    (global doc and word rows)."""
    dev = arrays["n_t"].device
    out = {"z": arrays["z"].view(-1)[canon], "n_t": arrays["n_t"].clone()}
    for key, ids, rows in (("n_td", lay.doc_of_worker, lay.doc_assign.size),
                           ("n_wt", lay.word_of_block, lay.num_words)):
        ids = torch.as_tensor(ids.reshape(-1), device=dev).long()
        m = ids >= 0
        table = torch.zeros((rows, T), dtype=torch.int32, device=dev)
        table[ids[m]] = arrays[key].view(-1, T)[m]
        out[key] = table
    return out


def _same_chain(name: str, got: list, want: list) -> None:
    """Fail unless two runs' chain states are equal after every sweep."""
    for s, (g, w) in enumerate(zip(got, want, strict=True)):
        for key in w:
            if not torch.equal(g[key], w[key]):
                raise SystemExit(f"{name}: {key} differs after sweep {s}")


def _train(label: str, lay, arrays, n_dense: int, gpu: str, kernel: str,
           doc_tile=None):
    """``n_dense`` dense r-mode sweeps and one sparse (``r_cap = T``) of
    ``NomadLDA(inner_mode="fused", ring_mode="pipelined",
    sync_mode="stoken")`` on ``lay`` from ``arrays`` (left unchanged),
    with every launch count set to 0 before and read after: ``kernel``
    must launch 2·W times a sweep and no other kernel at all.  Returns
    the final arrays, the launches, the chain state after each sweep and
    the dense r-mode model."""
    models = {m: NomadLDA(layout=lay, alpha=ALPHA, beta=BETA,
                          sync_mode="stoken", inner_mode="fused",
                          ring_mode="pipelined", r_mode=m,
                          doc_tile=doc_tile, device=DEV)
              for m in ("dense", "sparse")}
    canon = torch.as_tensor(lay.canon_idx, device=DEV)
    n_tok = int(lay.cell_sizes.sum())
    states = []
    _zero_counts()
    for s in range(n_dense + 1):
        trainer = models["dense" if s < n_dense else "sparse"]
        if s == n_dense:
            arrays = _with_tables(arrays, lay)
        torch.cuda.synchronize()
        host = time.perf_counter()
        arrays, ms = _timed(lambda: trainer.sweep(arrays, s))
        host = time.perf_counter() - host
        print(json.dumps({"run": label, "sweep": s,
                          "r_mode": trainer.r_mode, "device_ms": ms,
                          "host_s": host, "tokens_per_s": n_tok / host,
                          "gpu": gpu}))
        states.append(_chain_state(lay, arrays, canon))
    launches = dict(fs_mod.launches)
    if launches.pop(kernel) != 2 * W * (n_dense + 1) or any(
            launches.values()):
        raise SystemExit(f"{label}: launches {fs_mod.launches}; want "
                         f"2·W {kernel} a sweep and nothing else")
    return arrays, fs_mod.launches[kernel], states, models["dense"]


def _train_phase(corpus: Corpus, model: NomadLDA, arrays, gpu: str):
    """The ragged run: 3 dense sweeps and 1 sparse through the kernel,
    with the checks; returns the final arrays, the launches and the chain
    state after each sweep."""
    ll0 = model.log_likelihood(arrays)
    arrays, launches, states, _ = _train(
        "ragged", model.layout, arrays, DENSE_SWEEPS, gpu,
        "fused_sweep_ragged")
    _profile_sweep(model, arrays, gpu)
    ll1 = model.log_likelihood(arrays)
    bad = _mismatches(model, arrays)
    print(f"log-likelihood {ll0:.6e} -> {ll1:.6e}, count mismatches {bad}, "
          f"kernel launches {launches}")
    if not ll1 > ll0:
        raise SystemExit("the log-likelihood did not rise")
    if bad:
        raise SystemExit(f"{bad} count mismatches against z")
    return arrays, launches, states


def _profile_sweep(model: NomadLDA, arrays, gpu: str,
                   kernel: str = "fused_sweep_kernel") -> None:
    """One more sweep under ``torch.profiler``, its result dropped: the
    device time of ``kernel``, every other kernel's, and the share of the
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
    mine = [a for a in kernels if kernel in a.key]
    other = [a for a in kernels if kernel not in a.key]
    kernel_ms = sum(a.self_device_time_total for a in mine) / 1e3
    other_ms = sum(a.self_device_time_total for a in other) / 1e3
    print(json.dumps({
        "profiled_sweep_ms": wall, "inner_mode": model.inner_mode,
        f"{kernel}_ms": kernel_ms,
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
    _zero_counts()
    torch.cuda.synchronize()
    host = time.perf_counter()
    after = cgs.sweep_fplda_word(state, sub.doc_ids, sub.word_ids, order,
                                 bound, ALPHA, BETA, backend="fused")
    torch.cuda.synchronize()
    host = time.perf_counter() - host
    others = dict(fs_mod.launches)
    launches = others.pop("fused_sweep")
    bad = cgs.check_invariants(after, sub)
    print(f"serial sweep: {sub.num_tokens} tokens in {host:.3f} s, "
          f"launches {launches}, invariants {bad}")
    if launches != 1 or any(others.values()) or any(bad.values()):
        raise SystemExit("the serial fused sweep failed its checks")
    return 1


def _vec_train(label: str, lay, gpu: str, profile: bool = False):
    """VEC_SWEEPS sweeps of ``NomadLDA(inner_mode="vectorized",
    ring_mode="pipelined", sync_mode="stoken")`` on ``lay`` from its
    initial arrays, every launch count set to 0 before and read after:
    the pass form must launch W·k times a sweep and no other kernel at
    all, the log-likelihood must rise and the counts must equal those
    rebuilt from ``z``.  Returns the launches, the chain state after each
    sweep, the model and its initial arrays."""
    model = NomadLDA(layout=lay, alpha=ALPHA, beta=BETA, sync_mode="stoken",
                     inner_mode="vectorized", ring_mode="pipelined",
                     device=DEV)
    a0 = model.init_arrays(SEED)
    canon = torch.as_tensor(lay.canon_idx, device=DEV)
    n_tok = int(lay.cell_sizes.sum())
    arrays, states = a0, []
    _zero_counts()
    for s in range(VEC_SWEEPS):
        torch.cuda.synchronize()
        host = time.perf_counter()
        arrays, ms = _timed(lambda: model.sweep(arrays, s))
        host = time.perf_counter() - host
        print(json.dumps({"run": label, "sweep": s,
                          "inner_mode": "vectorized", "device_ms": ms,
                          "host_s": host, "tokens_per_s": n_tok / host,
                          "gpu": gpu}))
        states.append(_chain_state(lay, arrays, canon))
    others = _all_launches()
    launches = others.pop("lda_scores_pass")
    if launches != lay.W * lay.k * VEC_SWEEPS or any(others.values()):
        raise SystemExit(f"{label}: launches {_all_launches()}; want W·k = "
                         f"{lay.W * lay.k} lda_scores_pass a sweep and "
                         f"nothing else")
    if profile:
        _profile_sweep(model, arrays, gpu, "lda_scores_kernel")
    ll0, ll1 = model.log_likelihood(a0), model.log_likelihood(arrays)
    bad = _mismatches(model, arrays)
    print(f"{label}: log-likelihood {ll0:.6e} -> {ll1:.6e}, count "
          f"mismatches {bad}, lda_scores_pass launches {launches}")
    if not ll1 > ll0:
        raise SystemExit(f"{label}: the log-likelihood did not rise")
    if bad:
        raise SystemExit(f"{label}: {bad} count mismatches against z")
    return launches, states, model, a0


#: f32 operations of the conditional, scan and count per topic and token:
#: three adds, a multiply, a divide, the scan's add, the compare.
_SCORE_OPS = 7


def _rows_check(lay, arrays, beta_bar: float, gen) -> dict:
    """The rows form (``lda_scores_draw``) against its plain version on the
    card: ROWS_TOKENS valid tokens of the trained ragged run picked at
    random, their ``n_td`` and ``n_wt`` rows gathered from its tables, its
    ``n_t``."""
    S, k = lay.stream_len, lay.k
    valid = torch.nonzero(arrays["tok_valid"].reshape(-1)).flatten()
    pick = valid[torch.randint(valid.numel(), (ROWS_TOKENS,), generator=gen,
                               device=DEV)]
    w, c, pos = pick // (W * S), (pick // S) % W, pick % S
    cell = arrays["cell_of_tile"][w, c, pos // lay.tile].long()
    doc = arrays["tok_doc"].reshape(-1)[pick].long()
    wrd = arrays["tok_wrd"].reshape(-1)[pick].long()
    ntd = arrays["n_td"].view(-1, T)[w * lay.I_max + doc].contiguous()
    nwt = arrays["n_wt"].view(-1, T)[(c * k + cell) * lay.J_max
                                     + wrd].contiguous()
    n_t = arrays["n_t"]
    u = torch.rand(ROWS_TOKENS, generator=gen, device=DEV)
    kw = dict(alpha=ALPHA, beta=BETA, beta_bar=beta_bar)
    got = lda_scores_draw(ntd, nwt, n_t, u, **kw)
    plain, plain_ms = _timed(lambda: lda_scores_draw_ref(ntd, nwt, n_t, u,
                                                         **kw))
    err = _same("lda_scores rows form", got, plain)
    ms = _event_ms(lambda: ls_mod.lda_scores_cuda(ntd, nwt, n_t, u, **kw),
                   10)
    bound, by = _bytes_ops_bound(ROWS_TOKENS * (8 * T + 12) + 4 * T,
                                 ROWS_TOKENS * _SCORE_OPS * T)
    print(f"lda_scores rows form: {ROWS_TOKENS} tokens, T={T}, kernel "
          f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound:.5f} ms "
          f"({by}), z and norm equal")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, by=by)


def _pass_check(model: NomadLDA, arrays, gen) -> dict:
    """The pass form, deltas applied, against its plain version on the
    card, on what the main path gives its first launch: round 0 of the
    first sweep, the slice of cell 0 of the round's valid tokens (their
    rows, topics and uniforms as ``NomadLDA`` gathers them), the initial
    tables; ``z`` and the three tables bit for bit."""
    g = model._geometry(arrays, 0)
    toks = [g["view"](arrays[key]) for key in ("tok_doc", "tok_wrd",
                                                "tok_valid")]
    pos, cells = model._round_tokens(toks[2], g["cot"], g["tile"])[0]
    keys = rng.fold_in(rng.key(SEED, DEV), torch.arange(W, device=DEV))
    b = model._round_batch(pos, toks[:2], g["view"](arrays["z"]), g["cot"],
                           g["slot"], rng.fold_in(keys, 0), tile=g["tile"])
    n = cells[0]
    rows = [row[:n] for row in b["rows"]]
    z, u = b["z"][:n], b["u"][:n]
    kw = dict(alpha=ALPHA, beta=BETA, beta_bar=model.beta_bar)

    def tables():
        return [arrays["n_td"].view(-1, T).clone(),
                arrays["n_wt"].view(-1, T).clone(),
                arrays["n_t"].expand(W, T).contiguous()]

    runs = {}
    for label, draw in (("warm-up", ls_mod.lda_scores_pass_cuda),
                        ("kernel", ls_mod.lda_scores_pass_cuda),
                        ("plain", lda_scores_pass_ref)):
        tabs = tables()
        z_new, ms = _timed(lambda: draw(*rows, z, u, *tabs, **kw))
        apply_deltas(z, z_new, rows, tabs)
        runs[label] = ([z_new, *tabs], ms)
    err = _same("lda_scores pass form", runs["kernel"][0], runs["plain"][0])
    tabs = tables()
    ms = _event_ms(lambda: ls_mod.lda_scores_pass_cuda(*rows, z, u, *tabs,
                                                       **kw), 10)
    uniq = [int(torch.unique(row).numel()) for row in rows]
    bound, by = _bytes_ops_bound(4 * T * sum(uniq) + 4 * 6 * n,
                                 n * _SCORE_OPS * T)
    print(f"lda_scores pass form: round 0, cell 0: {n} of the round's "
          f"{pos.numel()} valid tokens of {W} streams, rows {uniq}, kernel "
          f"{ms:.4f} ms, plain {runs['plain'][1]:.2f} ms, bound "
          f"{bound:.5f} ms ({by}), z and tables equal")
    return dict(err=err, ms=ms, plain_ms=runs["plain"][1], bound_ms=bound,
                by=by)


def _pair_tree(p: torch.Tensor) -> torch.Tensor:
    """An F+tree over ``p`` of any power-of-two length, each node the sum
    of its children (``ftree.build`` pins the root's rounding to the
    reference's and stops at T = 1024; the checks need only one tree both
    versions read)."""
    levels = [p]
    while levels[-1].numel() > 1:
        x = levels[-1]
        levels.append(x[0::2] + x[1::2])
    return torch.cat([torch.zeros(1, device=p.device)] + levels[::-1])


def _top_word_tree(lay, arrays) -> torch.Tensor:
    """The q tree of the trained run's most frequent word (word 0):
    ``q_t = (n_wt + β) / (n_t + β̄)``, built as the trainer builds it."""
    b, j = (int(x[0]) for x in np.nonzero(lay.word_of_block == 0))
    q = ((arrays["n_wt"][b, j].float() + BETA)
         / (arrays["n_t"].float() + BETA * J))
    return ftree.build(q)


def _sample_check(cases: dict) -> dict:
    """``ftree_sample`` against its plain version on the card, for each
    case ``name: (F, u)``; returns the first case's numbers."""
    out = {"err": 0}
    for name, (F, u) in cases.items():
        Tn, N = F.numel() // 2, u.numel()
        got = fs_sample.ftree_sample_cuda(F, u)
        plain, plain_ms = _timed(lambda: ftree_sample_ref(F, u))
        out["err"] = max(out["err"], _same(f"ftree_sample {name}", [got],
                                           [plain]))
        if (ftree.leaves(F)[got.long()] <= 0).any():
            raise SystemExit(f"ftree_sample {name}: a zero-mass leaf drawn")
        ms = _event_ms(lambda: fs_sample.ftree_sample_cuda(F, u), 10)
        cdf = torch.cumsum(ftree.leaves(F), 0)
        lib_ms = _event_ms(lambda: torch.searchsorted(cdf, u * cdf[-1],
                                                      right=True), 10)
        depth = ftree.depth(Tn)
        bound, by = _bytes_ops_bound(8 * N + 8 * Tn, N * (1 + 4 * depth))
        print(f"ftree_sample ({name}): {N} draws, T={Tn}, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.2f} ms, searchsorted "
              f"{lib_ms:.4f} ms, bound {bound:.5f} ms ({by}), equal")
        if "ms" not in out:
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, by=by,
                       library_ms=lib_ms)
    return out


def _update_tolerance(F, ts, d) -> torch.Tensor:
    """Per node, how far two orders of its f32 adds may differ: n adds of
    terms summing to at most Σ|term| err by at most (n-1)·2**-24 of it
    each, so two orders differ by at most n·2**-23·(|F| + Σ|δ|)."""
    idx = ftree._path(F.numel() // 2, ts).reshape(-1)
    mass = F.double().abs().index_add(
        0, idx, d.double().abs().repeat_interleave(idx.numel() // d.numel()))
    adds = torch.zeros_like(mass).index_add(0, idx, torch.ones_like(
        idx, dtype=torch.float64))
    return adds * 2.0**-23 * mass


def _update_cases(trees: dict, gen) -> dict:
    """UPDATES updates with duplicates (an eighth of them on one leaf) for
    each tree: integer-valued deltas where the name says ``integer``,
    else real ones."""
    cases = {}
    for name, F in trees.items():
        Tn = F.numel() // 2
        ts = torch.randint(Tn, (UPDATES,), generator=gen, device=DEV,
                           dtype=torch.int32)
        ts[:UPDATES // 8] = Tn // 3                       # one hot leaf
        d = (torch.randint(-3, 4, (UPDATES,), generator=gen, device=DEV)
             .float() if name.startswith("integer") else
             torch.randn(UPDATES, generator=gen, device=DEV) * 1e-2)
        cases[name] = (F, ts, d)
    return cases


def _update_check(cases: dict) -> dict:
    """``ftree_update_batch`` against its plain version on the card, for
    each case ``name: (F, ts, deltas)``: integer-valued trees and deltas
    (names starting ``integer``) with max abs error 0, the others within
    :func:`_update_tolerance` (the plain version's ``index_add_`` adds in
    an order that changes from run to run); every case against the plain
    version on the CPU (which adds in k order, as the kernel does) bit
    for bit.  Returns the first case's numbers."""
    out = {"err": 0.0}
    for name, (F, ts, d) in cases.items():
        Tn, K = F.numel() // 2, ts.numel()
        F_in = F.clone()
        got = fs_update.ftree_update_cuda(F, ts, d)
        if not torch.equal(F, F_in):
            raise SystemExit(f"ftree_update {name}: the input tree changed")
        plain, plain_ms = _timed(lambda: ftree_update_ref(F, ts, d))
        diff = (got.double() - plain.double()).abs()
        out["err"] = max(out["err"], float(diff.max()))
        if name.startswith("integer"):
            _same(f"ftree_update {name}", [got], [plain])
        elif (diff > _update_tolerance(F, ts, d)).any():
            raise SystemExit(f"ftree_update {name}: outside the tolerance "
                             f"(max abs err {float(diff.max())})")
        _same(f"ftree_update {name} vs the CPU", [got.cpu()],
              [ftree_update_ref(F.cpu(), ts.cpu(), d.cpu())])
        ms = _event_ms(lambda: fs_update.ftree_update_cuda(F, ts, d), 10)
        idx = ftree._path(Tn, ts).reshape(-1)
        vals = d.repeat_interleave(idx.numel() // K)
        scratch = F.clone()
        lib_ms = _event_ms(lambda: scratch.index_add_(0, idx, vals), 10)
        bound, by = _bytes_ops_bound(8 * K + 16 * Tn, idx.numel())
        print(f"ftree_update ({name}): {K} updates, T={Tn}, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.2f} ms, index_add_ "
              f"{lib_ms:.4f} ms, bound {bound:.5f} ms ({by}), max abs err "
              f"{float(diff.max())} on the card, equal to the CPU")
        if "ms" not in out:
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, by=by,
                       library_ms=lib_ms)
    return out


def _batched_phase(lay, arrays, beta_bar: float, gen) -> dict:
    """The rows form against its plain version; then the path a user of
    the batched F+tree ops drives, every count 0 before: draw DRAWS
    topics for the top word from its q tree, add their mass to the tree
    in one batched update, and draw again from the new tree.  The path's
    own results are held against the plain versions, and each F+tree
    kernel is checked and timed at the path's shapes first (the numbers
    of the kernels line), then at T = 16,384 and with UPDATES updates of
    integer and real deltas."""
    res = {"lda_scores": _rows_check(lay, arrays, beta_bar, gen)}
    q_tree = _top_word_tree(lay, arrays)
    u = torch.rand(DRAWS, generator=gen, device=DEV)
    u[:2] = torch.tensor([1.0 - 2**-24, 0.0], device=DEV)
    ones = torch.ones(DRAWS, device=DEV)
    _zero_counts()
    z = ftree_sample(q_tree, u)
    grown = ftree_update_batch(q_tree, z, ones)
    z2 = ftree_sample(grown, u)
    launches = _all_launches()
    print(f"batched path: {DRAWS} draws, root {float(q_tree[1]):.6g} -> "
          f"{float(grown[1]):.6g}, redrawn topics changed "
          f"{int((z2 != z).sum())}, launches {launches}")
    if launches.pop("ftree_sample") != 2 or launches.pop(
            "ftree_update") != 1 or any(launches.values()):
        raise SystemExit(f"batched path launches {_all_launches()}")
    if not 0 <= int(z.min()) <= int(z.max()) < T:
        raise SystemExit("batched path: a draw outside [0, T)")
    _same("batched path draws", [z, z2], [ftree_sample_ref(q_tree, u),
                                          ftree_sample_ref(grown, u)])
    _same("batched path tree vs the CPU", [grown.cpu()],
          [ftree_update_ref(q_tree.cpu(), z.cpu(), ones.cpu())])
    big = torch.rand(BIG_T, generator=gen, device=DEV)
    big[torch.rand(BIG_T, generator=gen, device=DEV) < 0.3] = 0.0
    res["ftree_sample"] = _sample_check(
        {"path, top word q": (q_tree, u), "path, grown": (grown, u),
         f"T={BIG_T}, zero leaves": (_pair_tree(big), u)})
    counts = lambda n: torch.randint(0, 50, (n,), generator=gen,
                                     device=DEV).float()
    res["ftree_update"] = _update_check(
        {"path, top word q, its draws": (q_tree, z, ones),
         **_update_cases({"real, top word q": q_tree,
                          f"real, T={BIG_T}": _pair_tree(big),
                          f"integer, T={T}": ftree.build(counts(T)),
                          f"integer, T={BIG_T}": _pair_tree(counts(BIG_T))},
                         gen)})
    res["ftree_sample"]["launches"], res["ftree_update"]["launches"] = 2, 1
    return res


def _batched_entry(name: str, source: str, replaces: str, res: dict):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": res["launches"],
            "max_abs_err": res["err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["by"], "library_ms": res.get("library_ms"),
            **res.get("extra", {})}


def _window(dto_row: np.ndarray, n: int, last: int) -> int:
    """The first of ``n`` map entries that hold the switch into slab
    ``last`` (the shard's last, partial one) and what follows it; 0 where
    the row never reaches that slab."""
    hit = np.nonzero(dto_row == last)[0]
    if hit.size == 0:
        return 0
    return int(np.clip(hit[0] - n // 2, 0, max(dto_row.size - n, 0)))


def _gather(row: torch.Tensor, starts: np.ndarray, n: int, step: int):
    """``n·step`` entries of each row of ``row`` from entry
    ``starts[i]·step`` on."""
    pos = (torch.as_tensor(starts, device=row.device)[:, None] * step
           + torch.arange(n * step, device=row.device))
    return torch.gather(row, 1, pos)


def _slab_pulls(dto: torch.Tensor, I_max: int) -> int:
    """Rows the slab copies pull (and write back) over cut streams with
    map ``dto`` ``(W, 1, n)``: one pull at the start, one per switch."""
    g = dto.view(dto.shape[0], -1).cpu().numpy()
    pulls = [g[:, 0]] + [g[:, 1:][g[:, 1:] != g[:, :-1]]]
    g = np.concatenate(pulls)
    return int(np.minimum(DOC_TILE, I_max - g * DOC_TILE).sum())


def _form_check(name: str, cut: dict, n_td, n_wt, n_t, *, tile: int,
                I_max: int, J_max: int, beta_bar: float,
                gen: torch.Generator) -> dict:
    """Kernel form ``name`` through its wrapper against its plain version
    on the card, on cut streams ``cut`` (``(W, 1, S)`` token arrays whose
    ``cot`` already names global blocks, and ``dto`` when paged), both
    r-modes, bit for bit; returns its time (after one untimed launch on
    copies), bound and error in dense r-mode."""
    Wc, _, S = cut["tok_doc"].shape
    u = torch.rand((Wc, S), generator=gen, device=DEV)
    paging = {}
    slab_rows = 0
    if "dto" in cut:
        paging = dict(dto=cut["dto"], dtile=S // cut["dto"].shape[-1],
                      doc_rows=DOC_TILE)
        slab_rows = _slab_pulls(cut["dto"], I_max)
    valid = cut["tok_valid"] != 0
    workers = torch.arange(Wc, device=DEV)[:, None, None]
    cell_tok = cut["cot"].long().repeat_interleave(tile, dim=2)
    rows_d = int(torch.unique((workers * I_max + cut["tok_doc"])[valid])
                 .numel())
    rows_w = int(torch.unique((cell_tok * J_max + cut["tok_wrd"])[valid])
                 .numel())
    n_valid, n_bound = int(valid.sum()), int((cut["tok_bound"] != 0).sum())
    base = name.removesuffix("_docs")          # the wrapper adds it
    out = {"err": 0}
    for r_mode in ("dense", "sparse"):
        runs = {}
        for label, sweep in (
                ("warm-up", lambda *a, **k: fs_mod.sweep_streams_cuda(
                    *a, kernel=base, **k)),
                ("kernel", lambda *a, **k: fs_mod.sweep_streams_cuda(
                    *a, kernel=base, **k)),
                ("plain", sweep_streams_ref)):
            z = cut["z"].clone()
            td, wt = n_td.clone(), n_wt.clone()
            nt = n_t.expand(Wc, T).contiguous()
            tables = {}
            if r_mode == "sparse":
                tpc, cnt = rbucket.build_side_table(td, T)
                tables = dict(topics=tpc, counts=cnt)
            F, ms = _timed(lambda: sweep(
                cut["tok_doc"], cut["tok_wrd"], cut["tok_valid"],
                cut["tok_bound"], z, u, cut["cot"], td, wt, nt, r=0, k=1,
                tile=tile, tile_start=0, num_tiles=cut["cot"].shape[-1],
                I_max=I_max, J_max=J_max, alpha=ALPHA, beta=BETA,
                beta_bar=beta_bar, cap=T, **tables, **paging))
            runs[label] = ([z, td, wt, nt, F] + list(tables.values()), ms)
        out["err"] = max(out["err"], _same(f"{name} {r_mode}",
                                           runs["kernel"][0],
                                           runs["plain"][0]))
        bound, by = _sweep_bound(n_valid, n_bound, Wc * S, rows_d, rows_w,
                                 T, r_mode == "sparse")
        print(f"{name} ({r_mode}): {Wc} streams x {S} slots, {n_valid} "
              f"valid tokens, slab rows copied {slab_rows}, kernel "
              f"{runs['kernel'][1]:.3f} ms, plain {runs['plain'][1]:.1f} "
              f"ms, bound {bound:.5f} ms ({by}), equal")
        if r_mode == "dense":
            out.update(ms=runs["kernel"][1], plain_ms=runs["plain"][1],
                       bound_ms=bound, by=by)
    return out


def _round0(arrays, lay, key: str) -> torch.Tensor:
    """Round 0's rows of a ragged array: worker w's stream of chunk w."""
    w = torch.arange(lay.W, device=DEV)
    return arrays[key][w, w]


def _ragged_check(name: str, lay, arrays, starts: np.ndarray, n: int,
                  beta_bar: float, gen) -> dict:
    """Form ``name`` on round 0's W ragged streams, each cut to ``n``
    tiles from tile ``starts[w]`` (with the map when ``name`` pages)."""
    cut = {key: _gather(_round0(arrays, lay, key), starts, n,
                        lay.tile).view(W, 1, -1).contiguous()
           for key in ("tok_doc", "tok_wrd", "tok_valid", "tok_bound", "z")}
    cot = _gather(_round0(arrays, lay, "cell_of_tile"), starts, n, 1)
    cut["cot"] = (cot + torch.arange(W, device=DEV)[:, None] * lay.k).to(
        torch.int32).view(W, 1, -1).contiguous()
    if name.endswith("_docs"):
        cut["dto"] = _gather(_round0(arrays, lay, "doc_tile_of"), starts, n,
                             1).view(W, 1, -1).contiguous()
    return _form_check(name, cut, arrays["n_td"].view(-1, T),
                       arrays["n_wt"].view(-1, T), arrays["n_t"],
                       tile=lay.tile, I_max=lay.I_max, J_max=lay.J_max,
                       beta_bar=beta_bar, gen=gen)


def _cells_check(lay, arrays, beta_bar: float, gen) -> dict:
    """The cell-grid form (#3): round 0's W dense queues, each cell cut to
    its first CELL_SLOTS slots."""
    k = lay.k
    w = torch.arange(W, device=DEV)
    blocks = w[:, None] * k + torch.arange(k, device=DEV)      # (W, k)
    cut = {key: arrays[key][w[:, None], blocks, :CELL_SLOTS].reshape(
        W, 1, k * CELL_SLOTS).contiguous()
        for key in ("tok_doc", "tok_wrd", "tok_valid", "tok_bound", "z")}
    cut["cot"] = blocks.to(torch.int32).view(W, 1, k).contiguous()
    return _form_check("fused_sweep_cells", cut, arrays["n_td"].view(-1, T),
                       arrays["n_wt"].view(-1, T), arrays["n_t"],
                       tile=CELL_SLOTS, I_max=lay.I_max, J_max=lay.J_max,
                       beta_bar=beta_bar, gen=gen)


def _ragged_docs_check(lay, arrays, beta_bar: float, gen) -> dict:
    """The paged ragged form (#7): round 0's W grouped streams, each cut
    to DOCS_TILES tiles around its switch into the last, partial slab."""
    last = lay.n_doc_tiles - 1
    dto = _round0(arrays, lay, "doc_tile_of").cpu().numpy()
    starts = np.array([_window(row, DOCS_TILES, last) for row in dto])
    reach = sum(int((row[a:a + DOCS_TILES] == last).any())
                for row, a in zip(dto, starts))
    print(f"fused_sweep_ragged_docs check: {reach} of {W} cut streams "
          f"reach the last slab ({lay.I_max - last * DOC_TILE} rows)")
    return _ragged_check("fused_sweep_ragged_docs", lay, arrays, starts,
                         DOCS_TILES, beta_bar, gen)


def _cells_docs_check(lay, arrays, beta_bar: float, gen) -> dict:
    """The paged cell-grid form (#6): round 0's W grouped dense queues,
    each cell cut to DOCS_BLKS grid steps of ``doc_blk`` around its switch
    into the last, partial slab."""
    k, blk, last = lay.k, lay.doc_blk, lay.n_doc_tiles - 1
    w = torch.arange(W, device=DEV)
    blocks = (w[:, None] * k + torch.arange(k, device=DEV)).flatten()
    rows = lambda key: arrays[key][w.repeat_interleave(k), blocks]
    dto = rows("doc_tile_of")                                  # (W·k, n)
    starts = np.array([_window(row, DOCS_BLKS, last)
                       for row in dto.cpu().numpy()])
    cut = {key: _gather(rows(key), starts, DOCS_BLKS, blk).view(
        W, 1, -1).contiguous()
        for key in ("tok_doc", "tok_wrd", "tok_valid", "tok_bound", "z")}
    cut["cot"] = blocks.to(torch.int32).view(W, 1, k).contiguous()
    cut["dto"] = _gather(dto, starts, DOCS_BLKS, 1).view(
        W, 1, -1).contiguous()
    return _form_check("fused_sweep_cells_docs", cut,
                       arrays["n_td"].view(-1, T),
                       arrays["n_wt"].view(-1, T), arrays["n_t"],
                       tile=DOCS_BLKS * blk, I_max=lay.I_max,
                       J_max=lay.J_max, beta_bar=beta_bar, gen=gen)


def _chunk_stream(lay, arrays, w: int, c: int):
    """Worker ``w``'s grouped stream of chunk ``c`` as one stream against
    the chunk's ``k`` blocks flattened: tok_* and ``z`` ``(S,)`` with word
    rows ``cell·J_max + word``, the map ``(n_tiles,)``, and the chunk's
    ``(k·J_max, T)`` table."""
    row = lambda key: arrays[key][w, c]
    cell = row("cell_of_tile").long().repeat_interleave(lay.tile)
    toks = [row("tok_doc"), (cell * lay.J_max + row("tok_wrd")).to(
        torch.int32), row("tok_valid"), row("tok_bound"), row("z")]
    n_wt = arrays["n_wt"][c * lay.k:(c + 1) * lay.k].reshape(-1, T)
    return toks, row("doc_tile_of"), n_wt


def _docs_check(lay, arrays, beta_bar: float, gen) -> dict:
    """The paged single-stream form (#5) through
    ``fused_sweep_tokens(doc_tile_of=…)``: STREAM_TILES tiles of worker
    0's grouped stream of its fullest chunk, around the switch into the
    last, partial slab, both r-modes."""
    c = int(arrays["tok_valid"][0].sum(1).argmax())
    toks, dto, n_wt = _chunk_stream(lay, arrays, 0, c)
    a = _window(dto.cpu().numpy(), STREAM_TILES, lay.n_doc_tiles - 1)
    span = slice(a * lay.tile, (a + STREAM_TILES) * lay.tile)
    toks = [x[span].contiguous() for x in toks]
    dto = dto[a:a + STREAM_TILES].contiguous()
    n = toks[0].numel()
    u = torch.rand(n, generator=gen, device=DEV)
    valid = toks[2] != 0
    n_valid, n_bound = int(valid.sum()), int((toks[3] != 0).sum())
    slab_rows = _slab_pulls(dto.view(1, 1, -1), lay.I_max)
    args = (*toks[:4], toks[4], u, arrays["n_td"][0], n_wt, arrays["n_t"])
    out = {"err": 0}
    for r_mode in ("dense", "sparse"):
        kw = dict(alpha=ALPHA, beta=BETA, beta_bar=beta_bar, r_mode=r_mode,
                  doc_tile_of=dto, doc_rows=DOC_TILE, n_blk=lay.tile)
        got, ms = _timed(lambda: fs_ops.fused_sweep_tokens(*args, **kw))
        plain, plain_ms = _timed(lambda: fused_sweep_ref(*args, **kw))
        out["err"] = max(out["err"], _same(f"fused_sweep_docs {r_mode}",
                                           got, plain))
        bound, by = _sweep_bound(
            n_valid, n_bound, n, int(torch.unique(toks[0][valid]).numel()),
            int(torch.unique(toks[1][valid]).numel()), T,
            r_mode == "sparse")
        print(f"fused_sweep_docs ({r_mode}): worker 0, chunk {c}, {n} "
              f"slots, {n_valid} valid tokens, slab rows copied "
              f"{slab_rows}, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound:.5f} ms ({by}), equal")
        if r_mode == "dense":
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, by=by)
    return out


def _docs_path(lay, arrays, beta_bar: float, gen) -> int:
    """The single-stream paged form's own path: worker 0's grouped
    streams of all W chunks, one ``fused_sweep_tokens(doc_tile_of=…)``
    call each, ``n_td``, ``n_t`` and the blocks carried, against the same
    calls unpaged (``fused_sweep``).  Returns the paged launches."""
    u = torch.rand((W, lay.stream_len), generator=gen, device=DEV)
    runs = {}
    for paged in (True, False):
        n_td, n_t = arrays["n_td"][0].clone(), arrays["n_t"].clone()
        n_wt = arrays["n_wt"].clone()
        zs = []
        if paged:
            _zero_counts()
        for c in range(W):
            toks, dto, _ = _chunk_stream(lay, arrays, 0, c)
            kw = (dict(doc_tile_of=dto, doc_rows=DOC_TILE, n_blk=lay.tile)
                  if paged else {})
            z, n_td, wt, n_t, _ = fs_ops.fused_sweep_tokens(
                *toks, u[c], n_td, n_wt[c * lay.k:(c + 1) * lay.k].reshape(
                    -1, T), n_t, alpha=ALPHA, beta=BETA, beta_bar=beta_bar,
                **kw)
            n_wt[c * lay.k:(c + 1) * lay.k] = wt.view(lay.k, -1, T)
            zs.append(z)
        if paged:
            launches = dict(fs_mod.launches)
        runs[paged] = [torch.stack(zs), n_td, n_wt, n_t]
    _same("fused_sweep_docs path: paged vs unpaged", runs[True],
          runs[False])
    if launches.pop("fused_sweep_docs") != W or any(launches.values()):
        raise SystemExit(f"fused_sweep_docs path launches {fs_mod.launches}")
    print(f"fused_sweep_docs path: worker 0's {W} grouped chunk streams, "
          f"paged == unpaged, launches {W}")
    return W


def _paging_ab(lay, arrays, beta_bar: float, gen, gpu: str) -> None:
    """Whole rounds of the grouped ragged layout through the paged and
    the unpaged kernel on the same inputs, in turns (paged, unpaged,
    unpaged, paged): what paging costs or saves, beside each round's
    heaviest stream, its valid tokens and its slab switches."""
    w = torch.arange(W, device=DEV)
    u = torch.rand((W, lay.stream_len), generator=gen, device=DEV)
    toks = [arrays[key] for key in ("tok_doc", "tok_wrd", "tok_valid",
                                    "tok_bound")]
    ms = {True: [], False: []}
    heavy = []
    for r in range(AB_ROUNDS):
        for paged in (True, False, False, True):
            z, n_td, n_wt = (arrays[k].clone() for k in ("z", "n_td",
                                                           "n_wt"))
            paging = (dict(dto=arrays["doc_tile_of"], dtile=lay.tile,
                           doc_rows=DOC_TILE) if paged else {})
            _, t = _timed(lambda: fs_mod.sweep_streams_cuda(
                *toks, z, u, arrays["cell_of_tile"], n_td.view(-1, T),
                n_wt.view(-1, T), arrays["n_t"].expand(W, T).contiguous(),
                r=r, k=lay.k, tile=lay.tile, tile_start=0,
                num_tiles=lay.n_tiles, I_max=lay.I_max, J_max=lay.J_max,
                alpha=ALPHA, beta=BETA, beta_bar=beta_bar, cap=T,
                kernel="fused_sweep_ragged",
                **paging))
            ms[paged].append(t)
        c = (w + r) % W
        h = int(arrays["tok_valid"][w, c].sum(1).argmax())
        dto = arrays["doc_tile_of"][h, int(c[h])]
        heavy.append((h, int(arrays["tok_valid"][h, int(c[h])].sum()),
                      int((dto[1:] != dto[:-1]).sum())))
    print(json.dumps({"paging_ab_rounds": AB_ROUNDS,
                      "paged_ms": ms[True], "unpaged_ms": ms[False],
                      "heaviest_stream_worker_tokens_switches": heavy,
                      "gpu": gpu}))


def _layout(corpus: Corpus, kind: str, doc_tile=None):
    t0 = time.perf_counter()
    lay = build_layout(corpus, n_workers=W, T=T, n_blocks=B, layout=kind,
                       doc_tile=doc_tile)
    last = lay.I_max - (lay.n_doc_tiles - 1) * lay.doc_tile
    extra = (f", doc_tile {lay.doc_tile}: {lay.n_doc_tiles} slabs a "
             f"worker, the last of {last} rows" if doc_tile else "")
    print(f"{kind} layout: {time.perf_counter() - t0:.1f} s on the host; "
          f"token arrays {tuple(lay.tok_doc.shape)}, pad fraction "
          f"{lay.pad_fraction:.3f}{extra}")
    return lay


def _init(lay, doc_tile=None):
    model = NomadLDA(layout=lay, alpha=ALPHA, beta=BETA, inner_mode="fused",
                     doc_tile=doc_tile, device=DEV)
    t0 = time.perf_counter()
    arrays = model.init_arrays(SEED)
    torch.cuda.synchronize()
    print(f"init arrays: {time.perf_counter() - t0:.1f} s")
    return model, arrays


def _dense_phase(corpus: Corpus, ragged_states: list, ragged_phi,
                 vec_states: list, gpu: str, gen) -> dict:
    """(a) The dense cell grid: the cell form against its plain version,
    then the ragged run's schedule, its chain equal to the ragged one
    after every sweep and its φ snapshot too; then the vectorized mode on
    the grid, its chain equal to the ragged vectorized run's."""
    lay = _layout(corpus, "dense")
    model, arrays = _init(lay)
    res = _cells_check(lay, arrays, model.beta_bar, gen)
    arrays, res["launches"], states, model = _train(
        "dense grid", lay, arrays, DENSE_SWEEPS, gpu, "fused_sweep_cells")
    _same_chain("dense grid vs ragged", states, ragged_states)
    if not np.array_equal(model.export_phi_snapshot(arrays).phi, ragged_phi):
        raise SystemExit("dense grid vs ragged: the φ snapshots differ")
    print(f"dense grid: z, global counts and n_t equal the ragged run's "
          f"after each of {DENSE_SWEEPS + 1} sweeps; φ snapshots equal")
    del arrays, states
    _, states, _, _ = _vec_train("dense grid, vectorized", lay, gpu)
    _same_chain("vectorized: dense grid vs ragged", states, vec_states)
    print(f"dense grid, vectorized: z, global counts and n_t equal the "
          f"ragged vectorized run's after each of {VEC_SWEEPS} sweeps")
    return res


def _grouped_phases(corpus: Corpus, gpu: str, gen):
    """(b) The grouped ragged layout paged and unpaged, and (c) the
    grouped dense grid paged, all one chain; with the three paged forms
    against their plain versions and the single-stream form's path."""
    lay = _layout(corpus, "ragged", DOC_TILE)
    model, a0 = _init(lay, DOC_TILE)
    res = {"fused_sweep_ragged_docs": _ragged_docs_check(
        lay, a0, model.beta_bar, gen)}
    res["fused_sweep_docs"] = _docs_check(lay, a0, model.beta_bar, gen)
    _paging_ab(lay, a0, model.beta_bar, gen, gpu)
    arrays, launches, paged, _ = _train(
        "grouped ragged, paged", lay, a0, 1, gpu,
        "fused_sweep_ragged_docs", DOC_TILE)
    res["fused_sweep_ragged_docs"]["launches"] = launches
    del arrays
    arrays, _, unpaged, _ = _train("grouped ragged, unpaged", lay, a0, 1,
                                   gpu, "fused_sweep_ragged")
    del arrays
    _same_chain("grouped ragged: paged vs unpaged", paged, unpaged)
    res["fused_sweep_docs"]["launches"] = _docs_path(lay, a0,
                                                     model.beta_bar, gen)
    del a0, unpaged, model, lay
    torch.cuda.empty_cache()
    lay = _layout(corpus, "dense", DOC_TILE)
    model, arrays = _init(lay, DOC_TILE)
    res["fused_sweep_cells_docs"] = _cells_docs_check(lay, arrays,
                                                      model.beta_bar, gen)
    arrays, launches, dense, _ = _train(
        "grouped dense, paged", lay, arrays, 1, gpu,
        "fused_sweep_cells_docs", DOC_TILE)
    res["fused_sweep_cells_docs"]["launches"] = launches
    _same_chain("grouped dense paged vs grouped ragged paged", dense, paged)
    print("grouped: ragged paged == ragged unpaged == dense paged after "
          "each of 2 sweeps")
    return res


def _cross_check_phase(r: np.random.Generator, cdf: np.ndarray) -> None:
    """A small run at T=1024, W=4, two sweeps, both r-modes: the dense
    grid equals the ragged stream (fused, both ring modes) and the plain
    scan; on the grouped order, paged equals unpaged equals scan, dense
    equals ragged, both ring modes."""
    docs = [d[:40] for d in _docs(r, 48, cdf)]
    corpus = Corpus(
        doc_ids=np.repeat(np.arange(48, dtype=np.int32),
                          [d.size for d in docs]),
        word_ids=np.concatenate(docs), num_docs=48, num_words=J)
    dt = 5
    lays = {(kind, g): build_layout(corpus, n_workers=4, T=T, n_blocks=8,
                                    layout=kind, doc_tile=g)
            for kind in ("ragged", "dense") for g in (None, dt)}
    groups = {
        "ungrouped": [("ragged", None, "fused", "pipelined"),
                      ("ragged", None, "fused", "barrier"),
                      ("dense", None, "fused", "pipelined"),
                      ("dense", None, "fused", "barrier"),
                      ("ragged", None, "scan", "pipelined")],
        "grouped": [("ragged", dt, "fused", "pipelined"),
                    ("ragged", dt, "fused", "barrier"),
                    ("ragged", None, "fused", "pipelined"),
                    ("dense", dt, "fused", "pipelined"),
                    ("dense", dt, "fused", "barrier"),
                    ("dense", None, "fused", "barrier"),
                    ("ragged", None, "scan", "pipelined")]}
    for r_mode in ("dense", "sparse"):
        for name, runs in groups.items():
            states = []
            for kind, page, mode, ring in runs:
                lay = lays[(kind, None if name == "ungrouped" else dt)]
                m = NomadLDA(layout=lay, alpha=ALPHA, beta=BETA,
                             inner_mode=mode, ring_mode=ring, r_mode=r_mode,
                             doc_tile=page, device=DEV)
                canon = torch.as_tensor(lay.canon_idx, device=DEV)
                a = m.init_arrays(SEED)
                states.append([])
                for s in range(2):
                    a = m.sweep(a, s)
                    states[-1].append(_chain_state(lay, a, canon))
            for run, got in zip(runs[1:], states[1:]):
                _same_chain(f"small run {r_mode} {name}: {run} vs "
                            f"{runs[0]}", got, states[0])
    print(f"small run: {corpus.num_tokens} tokens, W=4, B=8, T={T}, "
          f"doc_tile {dt}: dense == ragged == scan, paged == unpaged == "
          f"scan, both ring modes, after 2 sweeps, both r-modes")


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
    # add α, multiply, scan add, 2 compares
    bound, by = _bytes_ops_bound(bytes_moved, valid_steps * 5 * T)
    print(f"fold_in kernel: D={D} L={L} T={T} J={J} sweeps={SWEEPS} "
          f"valid steps={valid_steps} phi rows={rows_needed} "
          f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, equal counts")
    return {"name": "fold_in", "route": "cuda",
            "source": "src/repro_torch/kernels/fold_in/csrc/fold_in.cu",
            "replaces": "src/repro/kernels/fold_in/fold_in.py:83",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


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


def _sweep_entry(name: str, replaces: str, res: dict):
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/fused_sweep/csrc/"
                      "fused_sweep.cu",
            "replaces": replaces, "launches": res["launches"],
            "max_abs_err": res["err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["by"], "library_ms": None}


def _phase_done(name: str, t0: float) -> float:
    """Print how long the phase took on the host clock; the time now."""
    now = time.perf_counter()
    print(f"phase {name}: {now - t0:.1f} s")
    return now


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
    start = t0 = time.perf_counter()
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

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    t0 = _phase_done("set-up", start)
    stream = _stream_phase(arrays, lay, r)
    ragged = _ragged_check("fused_sweep_ragged", lay, arrays,
                           np.zeros(W, np.int64), ROUND_TILES,
                           model.beta_bar, gen)
    t0 = _phase_done("kernel checks", t0)
    arrays, ragged["launches"], ragged_states = _train_phase(
        corpus, model, arrays, gpu)
    snapshot = model.export_phi_snapshot(arrays, sweep=DENSE_SWEEPS + 1)
    batched = _batched_phase(lay, arrays, model.beta_bar, gen)
    t0 = _phase_done("ragged run and batched kernels", t0)
    del arrays
    torch.cuda.empty_cache()
    vec, vec_states, vec_model, a0 = _vec_train("ragged, vectorized", lay,
                                                gpu, profile=True)
    rows = batched["lda_scores"]
    pass_form = _pass_check(vec_model, a0, gen)
    # The path launches the pass form; the rows form's numbers ride along.
    batched["lda_scores"] = dict(
        pass_form, launches=vec, err=max(rows["err"], pass_form["err"]),
        extra={"rows_form_tokens": ROWS_TOKENS, "rows_form_ms": rows["ms"],
               "rows_form_plain_ms": rows["plain_ms"],
               "rows_form_bound_ms": rows["bound_ms"]})
    del a0, model, vec_model, lay
    torch.cuda.empty_cache()
    stream["launches"] = _serial_phase(corpus)
    t0 = _phase_done("ragged vectorized run and serial sweep", t0)

    forms = {"fused_sweep_cells": _dense_phase(corpus, ragged_states,
                                               snapshot.phi, vec_states,
                                               gpu, gen)}
    del ragged_states, vec_states
    torch.cuda.empty_cache()
    t0 = _phase_done("(a) dense grid", t0)
    forms.update(_grouped_phases(corpus, gpu, gen))
    torch.cuda.empty_cache()
    t0 = _phase_done("(b), (c) grouped", t0)
    _cross_check_phase(r, cdf)
    t0 = _phase_done("small cross-check", t0)

    phi = torch.tensor(snapshot.phi, device=DEV)
    fold = _fold_in_phase(phi, cdf, r)
    fold["launches"] = _serving_phase(snapshot, phi, cdf, r, gpu)
    _phase_done("serving", t0)
    print(f"whole script: {time.perf_counter() - start:.1f} s")
    forms.update(fused_sweep=stream, fused_sweep_ragged=ragged)
    kernels = [fold] + [_sweep_entry(name, f"{PALLAS}:{line}", forms[name])
                        for name, line in REPLACES.items()]
    kernels += [_batched_entry(
        name, f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
        f"src/repro/kernels/{name}/{name}.py:{line}", batched[name])
        for name, line in (("ftree_sample", 41), ("ftree_update", 35),
                           ("lda_scores", 43))]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
