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
   r-modes, and times them; times whole rounds of the ragged layout, the
   heaviest stream's µs a token step;
2. trains on ``build_layout(layout="ragged")``: ``NomadLDA(inner_mode=
   "fused", ring_mode="pipelined", sync_mode="stoken")`` runs 3 sweeps in
   dense r-mode through ``run`` (a checkpoint after each into a rotation
   directory keeping 2 slots, the slot of the last one corrupted by a
   fault plan; each write's bytes and ms printed) and 1 in sparse;
   checks 2·W launches a sweep, a rising log-likelihood and counts equal
   to those rebuilt from ``z``, profiles one more dense sweep, and holds
   the sparse state's ``export_chain_state`` → ``restore_chain_state``
   to the state itself; on the trained run, holds the ``lda_scores``
   rows form (65,536 tokens) against its plain version, drives the
   batched F+tree ops' own path (2**20 draws from the top word's tree,
   one update by those draws, 2**20 draws again) and holds its results
   and both kernels at its shapes against the plain versions, then at
   T = 16,384 and with 65,536 integer and real updates (``ftree_update``
   beside ``index_add_`` and its order floor, computed as the root's K
   dependent f32 adds at the card's highest clock); then trains
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
   to (b); (e) the out-of-core store at the same width: the corpus
   written into a ``CorpusStore`` in shards of 2**20 tokens,
   ``build_layout_from_store(layout="ragged", doc_tile=32)`` byte for byte
   equal to (b)'s ``build_layout``, one fused paged sweep (equal to (b)'s
   first), 1,000 documents retired and 1,000 new ones added (store and
   ``update_layout``), the chain carried across (``carry_assignments``)
   and restored into a fresh ``NomadLDA(doc_tile=32)``: survivors keep
   their topics and uids, and one paged and one unpaged sweep from the
   carried state are equal, launch 2·W times each and keep the counts
   equal to ``z``; the store write, streaming build, update, carry and
   restore timed;
5. (d) at T = 4096 (the reference's larger T): the six fused forms
   against their plain versions on cut streams of a T = 4096 ragged
   layout (the paged ones with a slab map of 4 rows), the step's latency
   on whole rounds, then 2 dense r-mode sweeps of ``NomadLDA(inner_mode=
   "fused")``: 2·W launches a sweep, a rising log-likelihood, counts
   equal to ``z``;
6. cross-checks small runs at T=1024, W=4 in both r-modes, one sweep:
   dense equals ragged, and on a grouped layout paged equals unpaged,
   dense equals ragged, in both ring modes (the plain scan's equality is
   left to
   ``tests/test_torch_gpu.py``);
7. serves from the ragged run's φ snapshot: the fold-in kernel against
   its plain version (a 64 × 512 batch swept 20 times, with a document on
   all-zero φ rows and a masked one), its µs a step beside the chain's
   floor (computed, not measured: the step's dependent f32 operations at
   the card's highest clock), then ``LdaEngine`` queries of 1, 8 and 64
   documents (their equality with the plain ``fold_in_batch`` and the
   serial ``fold_in`` is held by ``tests/test_torch_gpu.py``); the
   kernel's long placement (its per-token arrays in device memory, where
   beside the state they would pass shared memory): against its plain
   version on 3 rows of L = 16,384 over one sweep, then timed on one full
   row of L = 65,536 over 20 sweeps, and the engine at 20 sweeps on a
   query of 8 documents and one of 60,000 tokens, which takes its own
   bucket of L = 65,536 (answers checked, p50/p99 printed); (f) the
   document-completion perplexity of 1,000 held-out NYTimes-shaped
   documents (a seed of their own) against the trained and the initial
   counts, its fold-in through the kernel: the first 2 documents'
   counts equal to the plain version's, both scores finite, printed
   beside the Zipf law's own perplexity on the scored tokens (the words
   are drawn independently of each other, so no model beats that law
   and training does not lower the score), launches and ms printed;
8. the lifecycle: a fresh ``NomadLDA(resume_from=<rotation>,
   collect_lag=True)`` falls back past the corrupted slot, runs the lost
   sweep, and equals the straight run after it (canonical ``z``, global
   counts, ``n_t``); its ``(W, W, 2, T)`` lag trace passes
   ``stoken_lag_check``'s fold-schedule and staleness checks; then a
   thread resumes the chain again and runs 2 sweeps publishing each φ
   into an ``LdaEngine(inner_mode="fused")`` while this thread queries
   it with 1 and 8 documents: no torn read, the shortest answers of each
   generation equal to the serial ``fold_in``, p50/p99 beside the idle
   ones; (g) the twins at their own sizes: ``lda_matrix_check 4 1 smoke``
   all exact, ``lda_dist_check`` in four configurations (ragged fused
   pipelined, dense fused on 2 pods, vectorized, ragged paged sparse)
   each with every mismatch 0 and the log-likelihood rising, the padding
   canary (``lda_canary_check 4 8``: ragged fused sweeps at B = W and
   4W in turn, its tokens a second and their ratio), the quickstart
   twin's 20 fused serial sweeps with ll/token rising, and one
   ``cgs.sweep_fplda_doc`` sweep over the quickstart corpus's first 50
   documents equal to the same sweep on the CPU;
9. (h) the baseline samplers: paper Table 1's ops of LSearch, BSearch,
   Alias and F+tree at T = 1024 and 4096 (``init``, 4,096 draws in one
   batch, 4,096 updates in sequence or, for Alias, one rebuild), on the
   card and on the CPU, states and draws equal, the F+tree's draws
   through the ``ftree_sample`` kernel and equal to its plain version,
   µs an op printed; then paper Table 2's baselines at the NYTimes
   width: one ``sweep_sparse_lda`` (bucket shares) and one
   ``sweep_alias_lda`` (2 MH steps, every step ok) over the first 400
   tokens in document order of the trained ragged chain, the card's
   chain equal to the CPU's and to its counts, µs a token on each;
10. (i) the model zoo's serving path (``launch/zoo_serve_check.py``;
   no kernel of its own, it reaches no ``pallas_call``; TF32 off, f32
   weights drawn on the card from a seeded ``torch.Generator``): all ten
   archs at smoke size on the card against the CPU copy of their weights
   (logits, prefill plus decode against the forward, ``generate``'s
   tokens on both devices); ``qwen3-8b`` at full width and depth serving
   8 prompts of 1 to 990 tokens, 32 new tokens each, checked
   teacher-forced, then at depth 2 against the CPU; ``deepseek-moe-16b``
   at full width cut to 4 layers serving 64 prompts, the choices dropped
   by capacity counted in prefill and decode and one MoE layer's decode
   step held against the CPU; ``mamba2-1.3b`` at full width and depth, 8
   prompts of 1 to 224 tokens, checked teacher-forced; prefill ms,
   decode ms a step (p50, p99), tokens/s, weight bytes and peak memory
   printed, one ``{"zoo_...": ...}`` line a part;
11. (j) the model zoo's training path (``launch/zoo_train_check.py``;
   no kernel of its own; TF32 off, f32 params, grads and AdamW moments,
   after freeing what (i) left on the card): the ten archs at smoke size,
   loss, gradients and one step against the CPU, and ``ep_check`` in lock
   step (M = 4); ``granite-3-2b`` at full width and depth, 5 steps at
   B = 4, S = 1024 with per-layer remat and the chunked CE, the first
   step's loss equal to the forward's, the loss falling, the last step
   profiled, the two-chunk CE at its vocabulary, then at depth 2 against
   the CPU with and without remat; ``deepseek-moe-16b`` at full width cut
   to 4 layers, 3 steps through the MoE backward, the choices dropped
   counted, and ``moe_forward_ep`` in lock step (M = 4) against
   ``moe_forward`` on a layer, y and gradients; ``mamba2-1.3b`` at full
   width and depth, 3 steps at B = 4, S = 1024, then at depth 2 against
   the CPU; ms a step, tokens/s, model TFLOP/s (computed, 6·N·tokens over
   the step time) and peak memory printed, one ``{"zoo_train_...": ...}``
   line a part;
   (j)'s ``granite-3-2b`` part also runs one more step under
   ``roofline/hlo_cost.analyze_step`` and holds its flops equal to the
   dry-run's count of the same step on a one-device mesh;
12. (k) the multi-pod dry-run and roofline (``launch/dryrun.py``, no
   kernel of its own): the card's own rates (an f32 matmul with TF32
   off and a bf16 matmul of 8192², a 4 GB device-to-device copy) beside
   ``launch/mesh.HW``'s data-sheet figures; (j)'s counted ``granite``
   step's roofline terms at the measured rates beside its measured step
   time; the dry-run at full size of ``qwen3-8b`` ``train_4k`` and
   ``mamba2-1.3b`` ``decode_32k`` on the 16×16 mesh (fake process
   groups, meta tensors), and the LDA report at ``lda-256``: each
   report's terms, bottleneck and ``fits`` printed, one ``{"dryrun":
   ...}`` line each;
13. (l) large T (the fused sweep's spilled layout and the fold-in's deep
   one, state past a block's shared memory in device memory): the six
   fused forms against their plain versions on cut streams (a tile a
   stream, 16 slots a cell, a 64-token single stream) at T = 16,384,
   32,768 and 131,072 in both r-modes and 65,536 and 262,144 dense,
   ``r_cap = T``, each form's placement printed (above 16,384 on the
   first 100 documents, from 131,072 the first 30, their words numbered
   densely: n_wt of the full vocabulary would not fit the card three
   times over); ``NomadLDA(inner_mode="fused")`` at T = 262,144 on the
   first 30 documents' ragged layout (9,504 word rows: n_wt passes 2^31
   entries), one dense and one sparse sweep, each with 2·W launches, the
   log-likelihood rising and the counts equal to ``z``, its n_wt bytes
   and placement printed; ``NomadLDA(inner_mode="fused")`` at
   T = 16,384 on the ragged layout of the first 3,000 documents (cut
   from 30,000 so that the heaviest stream stays near 600 tokens a
   round; their words numbered densely, as the layout would pad n_wt
   to the block holding every word without tokens): 2 dense sweeps and 1 sparse (``r_cap = T``), each with 2·W
   launches and no other kernel, the log-likelihood rising and the
   counts equal to ``z``, then one dense sweep on the ``doc_tile=32``
   grouped layout paged and one unpaged, equal; ``LdaEngine(inner_mode=
   "fused")`` at T = 32,768 over a 102,660 × 32,768 φ drawn from the
   seed (13.5 GB), queries of 1, 8 and 64 documents checked, p50/p99
   printed; ``LdaEngine(inner_mode="fused", sweeps=2)`` at T = 1,048,574
   over a 2,056-word φ (8.6 GB), queries of 1 and 8 NYTimes-shaped
   documents (their words modulo 2,056) checked, p50/p99 printed; the
   fold-in kernel against its plain version on 2 short documents (and a
   masked one) at T = 32,768 and 65,536, and at 262,144 and 1,048,574
   over a cut φ past 2^31 entries (8,200 and 2,056 rows, tokens on the
   last rows); the
   ``lda_scores`` pass form (deltas applied, through the op
   ``vectorized_pass``, counted) and rows form against their plain
   versions on 4,096 cut tokens at T = 8,192, 16,384, 40,001 (a ragged
   last chunk) and 65,536, timed; ``NomadLDA(inner_mode="vectorized")``
   at T = 16,384 on the same 3,000 documents' ragged layout: 3 sweeps of
   W·k ``lda_scores_pass`` launches and no other kernel, one more
   profiled, the log-likelihood rising, the counts equal to ``z``, the
   pass form on its first launch's tokens, then one sweep on the dense
   grid equal to the ragged chain; the batched F+tree path at T = 65,536
   (2**20 draws, an update by them, 2**20 draws again) and
   ``ftree_update`` with 65,536 integer and real updates, against the
   plain versions.  The card's kernels take every T the reference's
   guards take: the fused sweep every power of two from 1 to 262,144,
   the fold-in every T up to 1,048,574 and every document length,
   ``lda_scores``
   every T up to 2**31 - 2,049 (the stored layout up to 7,168, the deep
   one above, its levels in shared memory up to 108,944, else in a
   device scratch), ``ftree_sample`` and ``ftree_update`` every power of
   two up to 2**30;
14. prints the card, the latencies, the heaviest CTA's µs a step at both
   T, one JSON line describing each kernel (its launches read from the
   run of its path, every count set to 0 just before; the fused forms'
   numbers at T = 4096 in ``t4096_*`` keys, at (l)'s T in ``t16384_*``,
   ``t32768_*``, ``t65536_*``, ``t131072_*`` and ``t262144_*``, the
   fold-in's in ``t32768_*``, ``t65536_*``, ``t262144_*`` and
   ``t1048574_*`` and its long placement's in ``long_*`` (the check at
   L = 16,384, the full row of 65,536, the engine's long query),
   ``lda_scores``' in ``t8192_*``, ``t16384_*`` (the
   vectorized trainer's) and ``t65536_*``, ``ftree_update``'s in
   ``t65536_*`` (the batched path's); the launches of phases (e)–(k) in
   ``new_path_launches``), and last ``{"ok": true, "device":
   {...}}``.  Each phase prints its time (``phase ...: N s``).

Exits non-zero without a CUDA device, and when any check fails.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch import rng  # noqa: E402
from repro_torch.core import cgs  # noqa: E402
from repro_torch.core import ftree  # noqa: E402
from repro_torch.core import samplers  # noqa: E402
from repro_torch.core import heldout  # noqa: E402
from repro_torch.core.heldout import doc_fold_key, fold_in  # noqa: E402
from repro_torch.core.alias_lda import sweep_alias_lda  # noqa: E402
from repro_torch.core.nomad import NomadLDA  # noqa: E402
from repro_torch.core.sparse_lda import sweep_sparse_lda  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.corpus import Corpus  # noqa: E402
from repro_torch.data.corpus_store import (  # noqa: E402
    CorpusStore, build_layout_from_store, carry_assignments, update_layout)
from repro_torch.data.sharding import (build_layout,  # noqa: E402
                                       counts_from_layout)
from repro_torch.fault import FaultPlan, FaultSpec  # noqa: E402
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
from repro_torch.kernels.lda_scores.ops import (  # noqa: E402
    apply_deltas, vectorized_pass)
from repro_torch.kernels.lda_scores.ref import (  # noqa: E402
    lda_scores_pass_ref)
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.launch import lda_dist_check, lda_matrix_check  # noqa
from repro_torch.launch import lda_canary_check  # noqa: E402
from repro_torch.launch import dryrun, zoo_serve_check  # noqa: E402
from repro_torch.launch.mesh import (HW, fake_world,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch import zoo_train_check  # noqa: E402
from repro_torch.launch.stoken_lag_check import lag_report  # noqa: E402
from repro_torch.roofline.analysis import (bytes_ops_bound,  # noqa: E402
                                           sweep_bound)
from repro_torch.numerics import SCAN_BLOCK  # noqa: E402
from repro_torch.serve.lda_engine import (LdaEngine, PhiSnapshot,  # noqa
                                         TopicQuery)
from repro_torch.train.checkpoint import PHI_FORMAT_VERSION  # noqa: E402
from repro_torch.train.checkpoint import CheckpointRotation  # noqa: E402

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
#: The fold-in's long placement: the kernel against its plain version on
#: LONG_D rows of LONG_L positions over LONG_SWEEPS (the plain loop takes
#: ~2 ms a position), then the engine's queries of 8 documents and one of
#: LONG_DOC tokens, in its own bucket of LONG_BUCKET, LONG_REPS times
LONG_L, LONG_D, LONG_SWEEPS = 16_384, 3, 1
LONG_DOC, LONG_BUCKET, LONG_REPS = 60_000, 65_536, 4
LONG_SEED = SEED + 2             # the long checks' documents
STREAM_TOKENS = 1_000            # the single-stream kernel check
ROUND_TILES = 3                  # the nomad-round kernel check, per stream
DOC_TILE = 32                    # doc rows a slab in the grouped runs
CELL_SLOTS = 64                  # the cell form's check: slots a cell
DOCS_TILES = 4                   # the paged ragged check: tiles a stream
DOCS_BLKS = 2                    # the paged cell check: doc_blk steps a cell
STREAM_TILES = 8                 # the paged single-stream check: tiles
T4 = 4096                        # the reference's larger T (sweep_bench.py)
T4_SWEEPS = 2                    # fused dense sweeps at T4
T4_STREAM_TOKENS = 400           # the single-stream check at T4
T4_TILES = 2                     # the round checks at T4: tiles a stream
T4_SLAB_ROWS = 4                 # the paged checks at T4: doc rows a slab
T4_DTILE = 32                    # ... and positions a slab-map entry
TL = 16_384                      # (l) the trainer's large T
TL_DOCS = 3_000                  # (l) its documents, the corpus's first,
                                 # over the words they use
TL_DENSE = 2                     # (l) dense sweeps, then one sparse
#: (l) the six forms' T and r-modes (r_cap = T), on cut streams of
#: TL_TILES tiles a stream, TL_CELL_SLOTS slots a cell and a single stream
#: of TL_STREAM_TOKENS; above TL on the layout of the first TL_FORM_DOCS
#: documents, their words numbered densely (n_wt of the full vocabulary,
#: 27 GB at 65,536 topics, and its three copies would not fit the card)
TL_FORMS = ((16_384, ("dense", "sparse")), (32_768, ("dense", "sparse")),
            (65_536, ("dense",)), (131_072, ("dense", "sparse")),
            (262_144, ("dense",)))
TL_TILES, TL_CELL_SLOTS, TL_STREAM_TOKENS = 1, 16, 64
TL_FORM_DOCS = 100
#: (l) from TH_FROM topics the forms and the trainer at TH take the first
#: TH_DOCS documents only (n_wt of the first TL_FORM_DOCS' words, 27 GB at
#: TH, and the checks' copies would not fit the card; TH_DOCS' 5,006 words
#: make 9,504 word rows, 2.5·10^9 entries at TH, past 2^31)
TH, TH_FROM, TH_DOCS = 262_144, 131_072, 30
TS = 32_768                      # (l) the serving T: φ of J × TS from SEED
TS_REPS = {1: 8, 8: 4, 64: 2}    # (l) timed queries per batch size
TE = 1_048_574                   # (l) the engine at the fold-in's largest T
TE_REPS = {1: 3, 8: 2}           # ... timed queries per batch size
TE_SWEEPS = 2                    # ... and its sweeps (the engine's 20
                                 # take 7.6 s a one-document query there)
#: (l) the fold-in kernel's checks; above TF_CUT over a cut vocabulary
#: (:func:`_cut_words`: J × T would not fit the card)
TF, TF_CUT = (32_768, 65_536, 262_144, 1_048_574), 65_536
#: (l) the lda_scores forms' T on cut inputs (40,001: a ragged last chunk),
#: and those whose numbers the kernels line carries (TL's from the
#: vectorized trainer's first launch)
TV_FORMS = (8_192, 16_384, 40_001, 65_536)
TV_KEYS = (8_192, TL, 65_536)
TV_TOKENS, TV_DOCS, TV_WORDS = 4_096, 128, 512   # ... the cut inputs
TF_D, TF_L, TF_SWEEPS = 3, 48, 4  # ... 2 short documents and a masked one
STEP_ROUNDS = 2                  # rounds timed for the step's latency
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
BIG_T = 16_384                   # the large tree of the F+tree checks
SAMPLE_MAX_T = 65_536            # ftree_sample's deepest tree: a level
                                 # past its shared memory
FADD_CYCLES = 4                  # a dependent f32 add's latency on sm_90
REPS = {1: 40, 8: 20, 64: 8}     # timed queries per batch size
PUBLISH_QUERIES = 40             # queries, at least, while publishing
STORE_SHARD = 1 << 20            # tokens a corpus-store shard (e)
STORE_CHURN = 1_000              # documents retired and added (e)
HELDOUT_DOCS = 1_000             # held-out documents (f)
HELDOUT_SEED = SEED + 1          # their own seed (f)
HELDOUT_CHECKED = 2              # held to the plain fold-in (f)
DOC_SWEEP_DOCS = 50              # the doc-by-doc sweep's documents (g)
CANARY_WORKERS, CANARY_REPS = 4, 8   # the padding canary's W and sweeps (g)
TABLE1_T = (1024, 4096)          # (h) Table 1: sampler_bench.py's T
TABLE1_OPS = 4_096               # ... draws in one batch, updates in turn
TABLE2_TOKENS = 400              # (h) Table 2: the sweeps' first tokens
TABLE2_MH = 2                    # ... AliasLDA's MH steps a token
RATE_N = 8192                    # (k) the rate matmuls' side
RATE_COPY_BYTES = 4 * 10 ** 9    # (k) the rate copy
#: (k) the full-size dry-runs: arch, shape, on the 2×16×16 mesh?  The
#: largest that fit ~40 s of the host; kimi-k2-1t-a32b train_4k on
#: 2×16×16 (~40 s alone) runs in the CLI's full matrix
DRYRUN_COMBOS = (("qwen3-8b", "train_4k", False),
                 ("mamba2-1.3b", "decode_32k", False))
#: (g) the distributed twin's configurations on the card.
DIST_CONFIGS = (
    ["--n-devices", "8", "--inner-mode", "fused", "--layout", "ragged",
     "--ring-mode", "pipelined"],
    ["--n-devices", "4", "--pods", "2", "--sync-mode", "stale",
     "--inner-mode", "fused", "--layout", "dense"],
    ["--n-devices", "8", "--inner-mode", "vectorized"],
    ["--inner-mode", "fused", "--layout", "ragged", "--doc-tile", "3",
     "--r-mode", "sparse"])
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


def _graph_ms(fn, reps: int) -> float:
    """One run of ``fn``'s kernel, from a CUDA graph of ``reps`` captured
    runs (no host work between them), after one untimed run."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                          # warm, off capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return _event_ms(graph.replay, 1) / reps


def _timed(fn):
    """``fn()``'s result and its device time in ms (one run)."""
    start, end = _events()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _same(name: str, got, want) -> int:
    """Fail unless every tensor pair is equal; returns the max abs error
    (0: the error is formed only for a pair that differs, so that no
    f64 copy of a large table is made)."""
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            err = float((g.double() - w.double()).abs().max())
            raise SystemExit(f"{name}: output {i} differs from the plain "
                             f"version (max abs err {err})")
    return 0


def _stream_args(arrays, lay, r: np.random.Generator, n: int) -> tuple:
    """The single stream's arguments of ``fused_sweep_tokens``: ``n``
    word-sorted tokens of worker 0's documents against block 0 of the
    trainer's initial ``n_wt`` (about one word switch a token), their
    topics added to copies of ``n_td``, ``n_wt`` and ``n_t``."""
    I, T = lay.I_max, lay.T
    docs = np.sort(r.integers(0, I, n)).astype(np.int32)
    wrd = np.sort(r.integers(0, lay.J_max, n)).astype(np.int32)
    z = r.integers(0, T, n).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=DEV)
    n_td = arrays["n_td"][0].clone()
    n_wt = arrays["n_wt"][0].clone()
    one = torch.ones(n, dtype=torch.int32, device=DEV)
    n_td.index_put_((t(docs).long(), t(z).long()), one, accumulate=True)
    n_wt.index_put_((t(wrd).long(), t(z).long()), one, accumulate=True)
    n_t = n_wt.sum(0, dtype=torch.int32) + arrays["n_t"]
    starts = np.concatenate([[1], wrd[1:] != wrd[:-1]]).astype(np.int32)
    return (t(docs), t(wrd), one, t(starts), t(z),
            t(r.random(n).astype(np.float32)), n_td, n_wt, n_t)


def _stream_phase(arrays, lay, r: np.random.Generator,
                  n: int = STREAM_TOKENS, alpha: float = ALPHA,
                  r_modes=("dense", "sparse")) -> dict:
    """The single-stream form (#2) against its plain version on
    :func:`_stream_args`' stream, in ``r_modes``."""
    T = lay.T
    args = _stream_args(arrays, lay, r, n)
    docs, wrd, starts = (x.cpu().numpy() for x in (args[0], args[1],
                                                   args[3]))
    out = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0}
    for r_mode in r_modes:
        kw = dict(alpha=alpha, beta=BETA, beta_bar=BETA * J, r_mode=r_mode)
        got, ms = _timed(lambda: fs_ops.fused_sweep_tokens(*args, **kw))
        plain, plain_ms = _timed(lambda: fused_sweep_ref(*args, **kw))
        out["err"] = max(out["err"], _same(f"fused_sweep {r_mode}", got,
                                           plain))
        bound, by = sweep_bound(n, int(starts.sum()), n,
                                 np.unique(docs).size, np.unique(wrd).size,
                                 T, r_mode == "sparse", T)
        where = fs_mod.check_fits(T, T, 0, r_mode == "sparse")
        print(f"fused_sweep ({r_mode}): {n} tokens, T={T}, kernel "
              f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound:.5f} ms "
              f"({by}), equal; placement {json.dumps(where)}")
        if r_mode == "dense":
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, by=by)
    return out


def _mismatches(model: NomadLDA, arrays) -> int:
    lay = model.layout
    got = model.global_counts(arrays)
    want = counts_from_layout(lay, arrays["z"].cpu().numpy(), lay.T)
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
    T = lay.T
    tpc, cnt = rbucket.build_side_table(arrays["n_td"].view(-1, T), T)
    shape = (lay.W, lay.I_max, T)
    return dict(arrays, rb_topics=tpc.view(shape), rb_counts=cnt.view(shape))


def _chain_state(lay, arrays, canon: torch.Tensor) -> dict:
    """The chain in layout-free terms, on the card: ``z`` in canonical
    token order and the counts as ``NomadLDA.global_counts`` maps them
    (global doc and word rows)."""
    dev, T = arrays["n_t"].device, lay.T
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


def _timed_sweeps(trainer: NomadLDA, label: str, gpu: str, states: list):
    """``trainer.sweep`` timed: each sweep's device time (CUDA events) and
    host time printed as a JSON line, its chain state appended to
    ``states``."""
    lay, sweep = trainer.layout, trainer.sweep
    canon = torch.as_tensor(lay.canon_idx, device=DEV)
    n_tok = int(lay.cell_sizes.sum())

    def timed(arrays, seed):
        torch.cuda.synchronize()
        host = time.perf_counter()
        out, ms = _timed(lambda: sweep(arrays, seed))
        host = time.perf_counter() - host
        print(json.dumps({"run": label, "sweep": seed,
                          "r_mode": trainer.r_mode, "device_ms": ms,
                          "host_s": host, "tokens_per_s": n_tok / host,
                          "gpu": gpu}))
        states.append(_chain_state(lay, out, canon))
        return out
    return timed


def _timed_writes(trainer: NomadLDA, gpu: str, writes: list):
    """``trainer.save_checkpoint`` timed on the host clock (the copy off
    the card, the digests, the write and its fsyncs); each write's slot,
    bytes and ms printed and appended to ``writes``."""
    save = trainer.save_checkpoint

    def timed(path, arrays, *, next_seed):
        t0 = time.perf_counter()
        out = save(path, arrays, next_seed=next_seed)
        w = {"checkpoint_slot": next_seed, "slot_bytes":
             os.path.getsize(out), "write_ms": (time.perf_counter() - t0)
             * 1e3, "gpu": gpu}
        print(json.dumps(w))
        writes.append(w)
        return out
    return timed


def _train(label: str, lay, arrays, n_dense: int, gpu: str, kernel: str,
           doc_tile=None, rotation: str | None = None):
    """``n_dense`` dense r-mode sweeps and one sparse (``r_cap = T``) of
    ``NomadLDA(inner_mode="fused", ring_mode="pipelined",
    sync_mode="stoken")`` on ``lay`` from ``arrays`` (left unchanged),
    with every launch count set to 0 before and read after: ``kernel``
    must launch 2·W times a sweep and no other kernel at all.  With a
    ``rotation`` directory the dense sweeps go through ``run`` from the
    seed's initial arrays (``arrays`` is not used), with a checkpoint
    every sweep (2 slots kept) and a fault plan that corrupts the slot
    written at the last one.  Returns the final arrays, the launches,
    the chain state after each sweep, the dense r-mode model and the
    checkpoint writes."""
    ckpt = (dict(checkpoint_every=1, checkpoint_path=rotation,
                 checkpoint_keep=2) if rotation else {})
    models = {m: NomadLDA(layout=lay, alpha=ALPHA, beta=BETA,
                          sync_mode="stoken", inner_mode="fused",
                          ring_mode="pipelined", r_mode=m,
                          doc_tile=doc_tile, device=DEV,
                          **(ckpt if m == "dense" else {}))
              for m in ("dense", "sparse")}
    states, writes = [], []
    sweeps = {m: _timed_sweeps(models[m], label, gpu, states)
              for m in models}
    _zero_counts()
    if rotation:
        dense = models["dense"]
        dense.sweep = sweeps["dense"]
        dense.save_checkpoint = _timed_writes(dense, gpu, writes)
        plan = FaultPlan([FaultSpec("corrupt", "chain.write",
                                    at=n_dense - 1, nbytes=4)], seed=SEED)
        arrays, _ = dense.run(n_dense, init_seed=SEED, fault_plan=plan)
        if plan.log != [("chain.write", n_dense - 1, "corrupt")]:
            raise SystemExit(f"{label}: the fault plan fired {plan.log}")
    else:
        for s in range(n_dense):
            arrays = sweeps["dense"](arrays, s)
    arrays = sweeps["sparse"](_with_tables(arrays, lay), n_dense)
    launches = dict(fs_mod.launches)
    if launches.pop(kernel) != 2 * W * (n_dense + 1) or any(
            launches.values()):
        raise SystemExit(f"{label}: launches {fs_mod.launches}; want "
                         f"2·W {kernel} a sweep and nothing else")
    return arrays, fs_mod.launches[kernel], states, models["dense"], writes


def _train_phase(corpus: Corpus, model: NomadLDA, arrays, gpu: str,
                 rotation: str):
    """The ragged run: 3 dense sweeps through ``run`` with a checkpoint
    each into ``rotation``, then 1 sparse, through the kernel, with the
    checks; then the sparse state's export and restore, equal.  Returns
    the final arrays, the launches, the chain state after each sweep and
    the checkpoint writes."""
    ll0 = model.log_likelihood(arrays)
    arrays, launches, states, _, writes = _train(
        "ragged", model.layout, None, DENSE_SWEEPS, gpu,
        "fused_sweep_ragged", rotation=rotation)
    _profile_sweep(model, arrays, gpu)
    ll1 = model.log_likelihood(arrays)
    bad = _mismatches(model, arrays)
    print(f"log-likelihood {ll0:.6e} -> {ll1:.6e}, count mismatches {bad}, "
          f"kernel launches {launches}")
    if not ll1 > ll0:
        raise SystemExit("the log-likelihood did not rise")
    if bad:
        raise SystemExit(f"{bad} count mismatches against z")
    _sparse_round_trip(model.layout, arrays, gpu)
    return arrays, launches, states, writes


def _sparse_round_trip(lay, arrays, gpu: str) -> None:
    """``export_chain_state`` then ``restore_chain_state`` of the sparse
    r-mode state: every array equal, side tables verbatim."""
    sparse = NomadLDA(layout=lay, alpha=ALPHA, beta=BETA, inner_mode="fused",
                      ring_mode="pipelined", r_mode="sparse", device=DEV)
    t0 = time.perf_counter()
    state, meta = sparse.export_chain_state(arrays,
                                            next_seed=DENSE_SWEEPS + 1)
    t1 = time.perf_counter()
    back, start = sparse.restore_chain_state(state, meta)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for key, want in arrays.items():
        if not torch.equal(back[key], want):
            raise SystemExit(f"sparse round trip: {key} differs")
    if sorted(back) != sorted(arrays) or start != DENSE_SWEEPS + 1:
        raise SystemExit(f"sparse round trip: keys {sorted(back)}, "
                         f"next seed {start}")
    print(json.dumps({"sparse_round_trip": "equal", "state_bytes": sum(
        v.nbytes for v in state.values()), "export_ms": (t1 - t0) * 1e3,
        "restore_ms": (t2 - t1) * 1e3, "gpu": gpu}))


def _profile_sweep(model: NomadLDA, arrays, gpu: str,
                   kernel: str = "fused_sweep_kernel") -> None:
    """One more sweep under ``torch.profiler``, its result dropped: the
    device time of ``kernel``, every other kernel's, and the share of the
    wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = time.perf_counter()
        model.sweep(arrays, DENSE_SWEEPS + 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - wall) * 1e3
    # the device's own events only: a CPU op's device time is its
    # kernels' time again
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mine = [e for e in events if kernel in e.name]
    other = [e for e in events if kernel not in e.name]
    kernel_ms = sum(e.time_range.elapsed_us() for e in mine) / 1e3
    other_ms = sum(e.time_range.elapsed_us() for e in other) / 1e3
    print(json.dumps({
        "profiled_sweep_ms": wall, "inner_mode": model.inner_mode,
        f"{kernel}_ms": kernel_ms, "kernel_launches": len(mine),
        "other_kernels_ms": other_ms, "other_launches": len(other),
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


def _vec_train(label: str, lay, gpu: str, profile: bool = False,
               sweeps: int = VEC_SWEEPS, on_card: bool = False):
    """``sweeps`` sweeps of ``NomadLDA(inner_mode="vectorized",
    ring_mode="pipelined", sync_mode="stoken")`` at ``lay.T`` (α = 50/T)
    on ``lay`` from its initial arrays, every launch count set to 0 before
    each sweep and read after: the pass form must launch W·k times a sweep
    and no other kernel at all, the log-likelihood must rise and the
    counts must equal those rebuilt from ``z`` (``on_card``: on the card,
    the large-T check, and the chain state kept as canonical ``z`` and
    ``n_t`` only).  Returns the launches, the chain state after each
    sweep, the model and its initial arrays."""
    model = NomadLDA(layout=lay, alpha=50.0 / lay.T, beta=BETA,
                     sync_mode="stoken", inner_mode="vectorized",
                     ring_mode="pipelined", device=DEV)
    a0 = model.init_arrays(SEED)
    canon = torch.as_tensor(lay.canon_idx, device=DEV)
    n_tok = int(lay.cell_sizes.sum())
    arrays, states, launches = a0, [], 0
    for s in range(sweeps):
        _zero_counts()
        torch.cuda.synchronize()
        host = time.perf_counter()
        arrays, ms = _timed(lambda: model.sweep(arrays, s))
        host = time.perf_counter() - host
        others = _all_launches()
        n = others.pop("lda_scores_pass")
        if n != lay.W * lay.k or any(others.values()):
            raise SystemExit(f"{label}: sweep {s} launched "
                             f"{_all_launches()}; want W·k = "
                             f"{lay.W * lay.k} lda_scores_pass and nothing "
                             f"else")
        launches += n
        print(json.dumps({"run": label, "sweep": s, "T": lay.T,
                          "inner_mode": "vectorized", "device_ms": ms,
                          "host_s": host, "tokens_per_s": n_tok / host,
                          "launches": n, "gpu": gpu}))
        states.append({"z": arrays["z"].view(-1)[canon],
                       "n_t": arrays["n_t"].clone()} if on_card
                      else _chain_state(lay, arrays, canon))
    if profile:
        deep = ls_mod.placement(lay.T) not in ("registers", "stored")
        _profile_sweep(model, arrays, gpu,
                       "lda_scores_deep_kernel" if deep else
                       "lda_scores_kernel")
    ll0, ll1 = model.log_likelihood(a0), model.log_likelihood(arrays)
    bad = (_card_mismatches if on_card else _mismatches)(model, arrays)
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


def _rows_inputs(lay, arrays, gen) -> tuple:
    """The rows form's inputs: ROWS_TOKENS valid tokens of ``arrays``
    picked at random, their ``n_td`` and ``n_wt`` rows gathered from its
    tables, its ``n_t``, a uniform each."""
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
    u = torch.rand(ROWS_TOKENS, generator=gen, device=DEV)
    return ntd, nwt, arrays["n_t"], u


def _rows_check(lay, arrays, beta_bar: float, gen) -> dict:
    """The rows form (``lda_scores_draw``) against its plain version on the
    card, on :func:`_rows_inputs` of the trained ragged run."""
    ntd, nwt, n_t, u = _rows_inputs(lay, arrays, gen)
    kw = dict(alpha=ALPHA, beta=BETA, beta_bar=beta_bar)
    got = lda_scores_draw(ntd, nwt, n_t, u, **kw)
    plain, plain_ms = _timed(lambda: lda_scores_draw_ref(ntd, nwt, n_t, u,
                                                         **kw))
    err = _same("lda_scores rows form", got, plain)
    ms = _event_ms(lambda: ls_mod.lda_scores_cuda(ntd, nwt, n_t, u, **kw),
                   10)
    bound, by = bytes_ops_bound(ROWS_TOKENS * (8 * T + 12) + 4 * T,
                                 ROWS_TOKENS * _SCORE_OPS * T)
    print(f"lda_scores rows form: {ROWS_TOKENS} tokens, T={T}, kernel "
          f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound:.5f} ms "
          f"({by}), z and norm equal")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, by=by)


def _pass_inputs(model: NomadLDA, arrays, cell: int = 0) -> tuple:
    """What the main path gives the pass form's launch for ``cell`` of
    round 0 of the first sweep: the slice of the round's valid tokens of
    that cell, their rows, topics and uniforms as ``NomadLDA`` gathers
    them, from ``arrays``."""
    g = model._geometry(arrays, 0)
    toks = [g["view"](arrays[key]) for key in ("tok_doc", "tok_wrd",
                                                "tok_valid")]
    pos, cells = model._round_tokens(toks[2], g["cot"], g["tile"])[0]
    keys = rng.fold_in(rng.key(SEED, DEV), torch.arange(W, device=DEV))
    b = model._round_batch(pos, toks[:2], g["view"](arrays["z"]), g["cot"],
                           g["slot"], rng.fold_in(keys, 0), tile=g["tile"])
    part = slice(sum(cells[:cell]), sum(cells[:cell + 1]))
    return [row[part] for row in b["rows"]], b["z"][part], b["u"][part]


def _pass_check(model: NomadLDA, arrays, gen) -> dict:
    """The pass form, deltas applied, against its plain version on the
    card, on what the main path gives its first launch (round 0, cell 0,
    :func:`_pass_inputs`), the initial tables; ``z`` and the three tables
    bit for bit."""
    rows, z, u = _pass_inputs(model, arrays)
    n, T = z.numel(), model.layout.T
    kw = dict(alpha=model.alpha, beta=BETA, beta_bar=model.beta_bar)

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
    bound, by = bytes_ops_bound(4 * T * sum(uniq) + 4 * 6 * n,
                                 n * _SCORE_OPS * T)
    print(f"lda_scores pass form: T={T}, round 0, cell 0: {n} valid "
          f"tokens of {W} streams, rows {uniq}, kernel "
          f"{ms:.4f} ms, plain {runs['plain'][1]:.2f} ms, bound "
          f"{bound:.5f} ms ({by}), z and tables equal")
    return dict(err=err, ms=ms, plain_ms=runs["plain"][1], bound_ms=bound,
                by=by)


def _top_word_tree(lay, arrays) -> torch.Tensor:
    """The q tree of the trained run's most frequent word (word 0):
    ``q_t = (n_wt + β) / (n_t + β̄)``, built as the trainer builds it."""
    b, j = (int(x[0]) for x in np.nonzero(lay.word_of_block == 0))
    q = ((arrays["n_wt"][b, j].float() + BETA)
         / (arrays["n_t"].float() + BETA * J))
    return ftree.build(q)


def _sample_check(cases: dict) -> dict:
    """``ftree_sample`` against its plain version on the card, for each
    case ``name: (F, u)``: the kernel's own time (a CUDA graph of 10
    launches) and the wrapper call's; returns the first case's numbers."""
    out = {"err": 0}
    for name, (F, u) in cases.items():
        Tn, N = F.numel() // 2, u.numel()
        got = fs_sample.ftree_sample_cuda(F, u)
        plain, plain_ms = _timed(lambda: ftree_sample_ref(F, u))
        out["err"] = max(out["err"], _same(f"ftree_sample {name}", [got],
                                           [plain]))
        if (ftree.leaves(F)[got.long()] <= 0).any():
            raise SystemExit(f"ftree_sample {name}: a zero-mass leaf drawn")
        call = lambda: fs_sample.ftree_sample_cuda(F, u)   # noqa: E731
        ms, wrapper_ms = _graph_ms(call, 10), _event_ms(call, 10)
        cdf = torch.cumsum(ftree.leaves(F), 0)
        lib_ms = _event_ms(lambda: torch.searchsorted(cdf, u * cdf[-1],
                                                      right=True), 10)
        depth = ftree.depth(Tn)
        bound, by = bytes_ops_bound(8 * N + 8 * Tn, N * (1 + 4 * depth))
        print(f"ftree_sample ({name}): {N} draws, T={Tn}, kernel "
              f"{ms:.5f} ms (wrapper call {wrapper_ms:.5f}), plain "
              f"{plain_ms:.2f} ms, searchsorted {lib_ms:.4f} ms, bound "
              f"{bound:.5f} ms ({by}), {bound / ms:.1%} of it, equal")
        if "ms" not in out:
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, by=by,
                       library_ms=lib_ms, extra={"wrapper_ms": wrapper_ms})
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


def _max_sm_mhz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def _order_floor_ms(K: int) -> float:
    """K dependent f32 adds of FADD_CYCLES each at the card's highest SM
    clock, computed, not measured: about the least time of any update that
    keeps the reference's order, in which the root adds all K deltas one
    after another."""
    return K * FADD_CYCLES / (_max_sm_mhz() * 1e3)


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
        bound, by = bytes_ops_bound(8 * K + 16 * Tn, idx.numel())
        floor = _order_floor_ms(K)
        print(f"ftree_update ({name}): {K} updates, T={Tn}, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.2f} ms, index_add_ "
              f"{lib_ms:.4f} ms, bound {bound:.5f} ms ({by}), order floor "
              f"{floor:.4f} ms (computed: {K} adds x {FADD_CYCLES} cycles "
              f"at the highest SM clock), max abs err {float(diff.max())} "
              f"on the card, equal to the CPU")
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
    of the kernels line), then at T = 16,384 (and the sample at 65,536)
    and with UPDATES updates of integer and real deltas."""
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
    def leaves(n):
        p = torch.rand(n, generator=gen, device=DEV)
        p[torch.rand(n, generator=gen, device=DEV) < 0.3] = 0.0
        return p

    big, deepest = leaves(BIG_T), leaves(SAMPLE_MAX_T)
    res["ftree_sample"] = _sample_check(
        {"path, top word q": (q_tree, u), "path, grown": (grown, u),
         f"T={BIG_T}, zero leaves": (ftree.build(big), u),
         f"T={SAMPLE_MAX_T}, zero leaves": (ftree.build(deepest), u)})
    counts = lambda n: torch.randint(0, 50, (n,), generator=gen,
                                     device=DEV).float()
    res["ftree_update"] = _update_check(
        {"path, top word q, its draws": (q_tree, z, ones),
         **_update_cases({"real, top word q": q_tree,
                          f"real, T={BIG_T}": ftree.build(big),
                          f"integer, T={T}": ftree.build(counts(T)),
                          f"integer, T={BIG_T}": ftree.build(counts(BIG_T))},
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


def _slab_pulls(dto: torch.Tensor, I_max: int, rows: int = DOC_TILE) -> int:
    """Rows the slab copies pull (and write back) over cut streams with
    map ``dto`` ``(W, 1, n)``: one pull at the start, one per switch."""
    g = dto.view(dto.shape[0], -1).cpu().numpy()
    pulls = [g[:, 0]] + [g[:, 1:][g[:, 1:] != g[:, :-1]]]
    g = np.concatenate(pulls)
    return int(np.minimum(rows, I_max - g * rows).sum())


def _form_check(name: str, cut: dict, n_td, n_wt, n_t, *, tile: int,
                I_max: int, J_max: int, beta_bar: float,
                gen: torch.Generator, alpha: float = ALPHA,
                doc_rows: int = DOC_TILE,
                r_modes=("dense", "sparse")) -> dict:
    """Kernel form ``name`` through its wrapper against its plain version
    on the card, on cut streams ``cut`` (``(W, 1, S)`` token arrays whose
    ``cot`` already names global blocks, and ``dto`` when paged, in slabs
    of ``doc_rows``), in ``r_modes`` (``r_cap = T``), bit for bit;
    returns its time (after one untimed launch on copies), bound and
    error in dense r-mode, and its placement in each r-mode."""
    Wc, _, S = cut["tok_doc"].shape
    T = n_t.shape[-1]
    u = torch.rand((Wc, S), generator=gen, device=DEV)
    paging = {}
    slab_rows = 0
    if "dto" in cut:
        paging = dict(dto=cut["dto"], dtile=S // cut["dto"].shape[-1],
                      doc_rows=doc_rows)
        slab_rows = _slab_pulls(cut["dto"], I_max, doc_rows)
    valid = cut["tok_valid"] != 0
    workers = torch.arange(Wc, device=DEV)[:, None, None]
    cell_tok = cut["cot"].long().repeat_interleave(tile, dim=2)
    rows_d = int(torch.unique((workers * I_max + cut["tok_doc"])[valid])
                 .numel())
    rows_w = int(torch.unique((cell_tok * J_max + cut["tok_wrd"])[valid])
                 .numel())
    n_valid, n_bound = int(valid.sum()), int((cut["tok_bound"] != 0).sum())
    base = name.removesuffix("_docs")          # the wrapper adds it
    out = {"err": 0, "placement": {}}
    for r_mode in r_modes:
        runs = {}
        for label, sweep in (
                ("warm-up", lambda *a, **k: fs_mod.sweep_streams_cuda(
                    *a, kernel=base, **k)),
                ("kernel", lambda *a, **k: fs_mod.sweep_streams_cuda(
                    *a, kernel=base, **k)),
                ("plain", sweep_streams_ref)):
            z = cut["z"].clone()
            td, wt = n_td.clone(), n_wt.clone()
            nt = n_t.repeat(Wc, 1)                     # a copy, also for Wc = 1
            tables = {}
            if r_mode == "sparse":
                tpc, cnt = rbucket.build_side_table(td, T)
                tables = dict(topics=tpc, counts=cnt)
            F, ms = _timed(lambda: sweep(
                cut["tok_doc"], cut["tok_wrd"], cut["tok_valid"],
                cut["tok_bound"], z, u, cut["cot"], td, wt, nt, r=0, k=1,
                tile=tile, tile_start=0, num_tiles=cut["cot"].shape[-1],
                I_max=I_max, J_max=J_max, alpha=alpha, beta=BETA,
                beta_bar=beta_bar, cap=T, **tables, **paging))
            if label != "warm-up":              # its tables freed now
                runs[label] = ([z, td, wt, nt, F] + list(tables.values()),
                               ms)
        out["err"] = max(out["err"], _same(f"{name} {r_mode}",
                                           runs["kernel"][0],
                                           runs["plain"][0]))
        bound, by = sweep_bound(n_valid, n_bound, Wc * S, rows_d, rows_w,
                                 T, r_mode == "sparse", T)
        where = fs_mod.check_fits(T, T, paging.get("doc_rows", 0),
                                  r_mode == "sparse")
        out["placement"][r_mode] = where
        print(f"{name} ({r_mode}): T={T}, {Wc} streams x {S} slots, "
              f"{n_valid} "
              f"valid tokens, slab rows copied "
              f"{0 if where['spill'] else slab_rows}, kernel "
              f"{runs['kernel'][1]:.3f} ms, plain {runs['plain'][1]:.1f} "
              f"ms, bound {bound:.5f} ms ({by}), equal; placement "
              f"{json.dumps(where)}")
        if r_mode == "dense":
            out.update(ms=runs["kernel"][1], plain_ms=runs["plain"][1],
                       bound_ms=bound, by=by)
    return out


def _round0(arrays, lay, key: str) -> torch.Tensor:
    """Round 0's rows of a ragged array: worker w's stream of chunk w."""
    w = torch.arange(lay.W, device=DEV)
    return arrays[key][w, w]


def _ragged_cut(lay, arrays, starts: np.ndarray, n: int,
                paged: bool = False) -> dict:
    """Round 0's W ragged streams, each cut to ``n`` tiles from tile
    ``starts[w]``, ``cot`` naming global blocks (with the map when
    ``paged``)."""
    cut = {key: _gather(_round0(arrays, lay, key), starts, n,
                        lay.tile).view(W, 1, -1).contiguous()
           for key in ("tok_doc", "tok_wrd", "tok_valid", "tok_bound", "z")}
    cot = _gather(_round0(arrays, lay, "cell_of_tile"), starts, n, 1)
    cut["cot"] = (cot + torch.arange(W, device=DEV)[:, None] * lay.k).to(
        torch.int32).view(W, 1, -1).contiguous()
    if paged:
        cut["dto"] = _gather(_round0(arrays, lay, "doc_tile_of"), starts, n,
                             1).view(W, 1, -1).contiguous()
    return cut


def _ragged_check(name: str, lay, arrays, starts: np.ndarray, n: int,
                  beta_bar: float, gen) -> dict:
    """Form ``name`` on round 0's W ragged streams, each cut to ``n``
    tiles from tile ``starts[w]`` (with the map when ``name`` pages)."""
    cut = _ragged_cut(lay, arrays, starts, n, name.endswith("_docs"))
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
        bound, by = sweep_bound(
            n_valid, n_bound, n, int(torch.unique(toks[0][valid]).numel()),
            int(torch.unique(toks[1][valid]).numel()), T,
            r_mode == "sparse", T)
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


def _step_us(label: str, lay, arrays, beta_bar: float, gen,
             gpu: str) -> list:
    """Whole rounds of the ragged layout through the unpaged kernel on the
    same inputs, dense r-mode: each launch's device time over the valid
    tokens of its heaviest stream, the µs a token step of the CTA that
    sets the launch (rebuilds included)."""
    T = lay.T
    w = torch.arange(W, device=DEV)
    u = torch.rand((W, lay.stream_len), generator=gen, device=DEV)
    toks = [arrays[key] for key in ("tok_doc", "tok_wrd", "tok_valid",
                                    "tok_bound")]
    steps = []
    for r in range(STEP_ROUNDS):
        z, n_td, n_wt = (arrays[k].clone() for k in ("z", "n_td", "n_wt"))
        _, ms = _timed(lambda: fs_mod.sweep_streams_cuda(
            *toks, z, u, arrays["cell_of_tile"], n_td.view(-1, T),
            n_wt.view(-1, T), arrays["n_t"].expand(W, T).contiguous(), r=r,
            k=lay.k, tile=lay.tile, tile_start=0, num_tiles=lay.n_tiles,
            I_max=lay.I_max, J_max=lay.J_max, alpha=50.0 / T, beta=BETA,
            beta_bar=beta_bar, cap=T, kernel="fused_sweep_ragged"))
        heavy = int(arrays["tok_valid"][w, (w + r) % W].sum(1).max())
        steps.append({"round": r, "ms": ms, "heaviest_valid": heavy,
                      "us_a_step": ms * 1e3 / heavy})
    print(json.dumps({"step_latency": label, "T": T, "rounds": steps,
                      "gpu": gpu}))
    return [st["us_a_step"] for st in steps]


def _cells_cut(lay, arrays, n: int) -> dict:
    """Cut streams of the cell-grid form from the ragged layout: for each
    worker's round-0 chunk, the first ``n`` slots of each of its k cells
    (their tiles in order; a cell shorter than that padded with masked
    slots), a tile of ``n`` slots a cell, ``cot`` naming global blocks."""
    k, tile = lay.k, lay.tile
    keys = ("tok_doc", "tok_wrd", "tok_valid", "tok_bound", "z")
    rows = {key: _round0(arrays, lay, key).cpu().numpy() for key in keys}
    cot = _round0(arrays, lay, "cell_of_tile").cpu().numpy()
    out = {key: np.zeros((W, k * n), np.int32) for key in keys}
    for w in range(W):
        for j in range(k):
            pos = (np.nonzero(cot[w] == j)[0][:, None] * tile
                   + np.arange(tile)).reshape(-1)[:n]
            for key in keys:
                out[key][w, j * n:j * n + pos.size] = rows[key][w, pos]
    cut = {key: torch.as_tensor(v, device=DEV).view(W, 1, -1)
           for key, v in out.items()}
    cut["cot"] = (torch.arange(W, device=DEV)[:, None] * k
                  + torch.arange(k, device=DEV)).to(torch.int32).view(
                      W, 1, k).contiguous()
    return cut


def _paged_cut(cut: dict, I_max: int) -> dict:
    """``cut`` with a slab map: every T4_DTILE positions (or the largest
    divisor of the stream's length below it) of stream w lie in
    slab (i + 7 w) mod n_slabs of T4_SLAB_ROWS rows (the last one
    partial), each token's doc moved into its slab."""
    Wc, _, S = cut["tok_doc"].shape
    n_slabs = -(-I_max // T4_SLAB_ROWS)
    dtile = math.gcd(T4_DTILE, S)
    g = (torch.arange(S // dtile, device=DEV)
         + 7 * torch.arange(Wc, device=DEV)[:, None]) % n_slabs
    g_tok = g.repeat_interleave(dtile, dim=1)
    height = torch.clamp(I_max - g_tok * T4_SLAB_ROWS, max=T4_SLAB_ROWS)
    doc = g_tok * T4_SLAB_ROWS + cut["tok_doc"].view(Wc, S) % height
    return dict(cut, tok_doc=doc.to(torch.int32).view(Wc, 1, S),
                dto=g.to(torch.int32).view(Wc, 1, -1).contiguous())


def _six_forms(lay, arrays, beta_bar: float, gen, r, tiles: int = T4_TILES,
               stream_tokens: int = T4_STREAM_TOKENS, cell_slots: int =
               CELL_SLOTS, r_modes=("dense", "sparse")) -> dict:
    """The six fused forms against their plain versions at ``lay.T`` on
    cut streams of a ragged layout: the single stream of
    ``stream_tokens``; round 0's ragged streams, ``tiles`` tiles each;
    cell queues of ``cell_slots`` slots a cell cut from them; and the
    three paged twins on the same cuts with a slab map of T4_SLAB_ROWS
    rows (a T4 slab of 32 rows would not fit a block's shared memory; at
    16,384 topics and above no slab does, and the kernel reads the rows
    in place), in ``r_modes``."""
    T = lay.T
    alpha = 50.0 / T
    tables = (arrays["n_td"].view(-1, T), arrays["n_wt"].view(-1, T),
              arrays["n_t"])
    kw = dict(I_max=lay.I_max, J_max=lay.J_max, beta_bar=beta_bar, gen=gen,
              alpha=alpha, doc_rows=T4_SLAB_ROWS, r_modes=r_modes)
    rag = _ragged_cut(lay, arrays, np.zeros(W, np.int64), tiles)
    cells = _cells_cut(lay, arrays, cell_slots)
    one = {key: v[:1] for key, v in rag.items()}
    res = {"fused_sweep": _stream_phase(arrays, lay, r, stream_tokens,
                                        alpha, r_modes)}
    for name, cut, tile in (
            ("fused_sweep_ragged", rag, lay.tile),
            ("fused_sweep_cells", cells, cell_slots),
            ("fused_sweep_ragged_docs", _paged_cut(rag, lay.I_max),
             lay.tile),
            ("fused_sweep_cells_docs", _paged_cut(cells, lay.I_max),
             cell_slots),
            ("fused_sweep_docs", _paged_cut(one, lay.I_max), lay.tile)):
        n_td = tables[0][:cut["tok_doc"].shape[0] * lay.I_max]
        res[name] = _form_check(name, cut, n_td, *tables[1:], tile=tile,
                                **kw)
    return res


def _t4_phase(corpus: Corpus, gpu: str, gen, r) -> dict:
    """(d) T4 at full width: the six forms against their plain versions
    on cut streams, the step's latency on whole rounds, then T4_SWEEPS
    dense r-mode sweeps of ``NomadLDA(inner_mode="fused")`` on the ragged
    layout, every count 0 before: 2·W launches a sweep and no other
    kernel, a rising log-likelihood, counts equal to ``z``."""
    lay = _layout(corpus, "ragged", T=T4)
    model = NomadLDA(layout=lay, alpha=50.0 / T4, beta=BETA,
                     sync_mode="stoken", inner_mode="fused",
                     ring_mode="pipelined", device=DEV)
    a0 = model.init_arrays(SEED)
    res = _six_forms(lay, a0, model.beta_bar, gen, r)
    res["step_us"] = _step_us(f"T={T4}", lay, a0, model.beta_bar, gen, gpu)
    n_tok = int(lay.cell_sizes.sum())
    arrays = a0
    _zero_counts()
    for s in range(T4_SWEEPS):
        torch.cuda.synchronize()
        host = time.perf_counter()
        arrays, ms = _timed(lambda: model.sweep(arrays, s))
        host = time.perf_counter() - host
        print(json.dumps({"run": f"ragged, T={T4}", "sweep": s,
                          "r_mode": "dense", "device_ms": ms,
                          "host_s": host, "tokens_per_s": n_tok / host,
                          "gpu": gpu}))
    launches = _all_launches()
    if launches.pop("fused_sweep_ragged") != 2 * W * T4_SWEEPS or any(
            launches.values()):
        raise SystemExit(f"T={T4}: launches {_all_launches()}")
    ll0, ll1 = model.log_likelihood(a0), model.log_likelihood(arrays)
    bad = _mismatches(model, arrays)
    print(f"T={T4}: log-likelihood {ll0:.6e} -> {ll1:.6e}, count "
          f"mismatches {bad}, kernel launches {2 * W * T4_SWEEPS}")
    if not ll1 > ll0:
        raise SystemExit(f"T={T4}: the log-likelihood did not rise")
    if bad:
        raise SystemExit(f"T={T4}: {bad} count mismatches against z")
    return res


def _first_docs(corpus: Corpus, n: int, dense_words: bool) -> Corpus:
    """The corpus's first ``n`` documents; with ``dense_words`` their word
    ids numbered densely (the words they use, in id order)."""
    keep = corpus.doc_ids < n
    words, num_words = corpus.word_ids[keep], corpus.num_words
    if dense_words:
        used, words = np.unique(words, return_inverse=True)
        num_words = used.size
    return Corpus(doc_ids=corpus.doc_ids[keep],
                  word_ids=words.astype(np.int32), num_docs=n,
                  num_words=num_words)


def _card_mismatches(model: NomadLDA, arrays) -> int:
    """:func:`_mismatches` on the card, for the large-T runs (its host
    tables of n_wt take tens of seconds there): the global counts of
    ``arrays`` against those rebuilt from ``z`` (``counts_from_layout``'s
    geometry), summed absolute differences."""
    lay, T = model.layout, model.layout.T
    canon = torch.as_tensor(lay.canon_idx, device=DEV)
    zz = arrays["z"].view(-1)[canon].long()
    gdoc, gwrd = (torch.as_tensor(x, device=DEV).long()
                  for x in lay.token_globals())
    one = torch.ones_like(zz, dtype=torch.int32)
    bad = 0
    for key, rows, index in (("n_td", lay.doc_of_worker, gdoc),
                             ("n_wt", lay.word_of_block, gwrd)):
        rows = torch.as_tensor(rows.reshape(-1), device=DEV).long()
        m = rows >= 0
        want = torch.zeros((int(rows.max()) + 1, T), dtype=torch.int32,
                           device=DEV)
        want.index_put_((index, zz), one, accumulate=True)
        got = arrays[key].view(-1, T)[m]
        bad += int((got - want[rows[m]]).abs().sum())
        del want, got
    nt = torch.bincount(zz, minlength=T).to(torch.int32)
    return bad + int((arrays["n_t"].view(-1) - nt).abs().sum())


def _large_t_sweeps(lay, arrays, gpu: str, doc_tile=None,
                    n_dense: int = TL_DENSE, sparse: bool = True) -> tuple:
    """``n_dense`` dense sweeps and (``sparse``) one sparse (r_cap = T) of
    ``NomadLDA(inner_mode="fused", ring_mode="pipelined",
    sync_mode="stoken")`` at ``lay.T``, each with every count set to 0
    before it and read after: 2·W launches of its form and no other
    kernel, the log-likelihood rising, the counts equal to ``z``.
    Returns the final arrays, the launches and the chain after each
    sweep: canonical ``z`` and ``n_t`` (the counts equal those of ``z``,
    so two chains with equal ``z`` have equal counts)."""
    T = lay.T
    kernel = "fused_sweep_ragged" + ("_docs" if doc_tile else "")
    models = [NomadLDA(layout=lay, alpha=50.0 / T, beta=BETA,
                       sync_mode="stoken", inner_mode="fused",
                       ring_mode="pipelined", r_mode=m, doc_tile=doc_tile,
                       device=DEV) for m in ("dense", "sparse")]
    n_tok = int(lay.cell_sizes.sum())
    canon = torch.as_tensor(lay.canon_idx, device=DEV)
    label = f"ragged, T={T}" + (f", doc_tile {doc_tile}" if doc_tile
                                 else "")
    ll = models[0].log_likelihood(arrays)
    states, launches = [], 0
    for s in range(n_dense + sparse):
        model = models[s == n_dense]
        if s == n_dense:
            arrays = _with_tables(arrays, lay)
        _zero_counts()
        torch.cuda.synchronize()
        host = time.perf_counter()
        arrays, ms = _timed(lambda: model.sweep(arrays, s))
        host = time.perf_counter() - host
        got = _all_launches()
        n = got.pop(kernel)
        if n != 2 * W or any(got.values()):
            raise SystemExit(f"{label}: sweep {s} launched "
                             f"{_all_launches()}; want 2·W {kernel}")
        launches += n
        ll1 = model.log_likelihood(arrays)
        bad = _card_mismatches(model, arrays)
        print(json.dumps({"run": label, "sweep": s, "r_mode": model.r_mode,
                          "device_ms": ms, "host_s": host,
                          "tokens_per_s": n_tok / host,
                          "log_likelihood": ll1, "count_mismatches": bad,
                          "launches": n, "gpu": gpu}))
        if not ll1 > ll:
            raise SystemExit(f"{label}: the log-likelihood did not rise at "
                             f"sweep {s}: {ll} -> {ll1}")
        if bad:
            raise SystemExit(f"{label}: {bad} count mismatches at sweep {s}")
        ll = ll1
        states.append({"z": arrays["z"].view(-1)[canon],
                       "n_t": arrays["n_t"].clone()})
    return arrays, launches, states


def _cut_words(T: int) -> int:
    """φ rows of (l)'s cut vocabulary at T: the fewest whose J × T entries
    pass 2^31, plus 8 (2,056 rows, 8.6 GB, at T = 1,048,574)."""
    return 2**31 // T + 8


def _large_t_serving(cdf: np.ndarray, r: np.random.Generator, gpu: str,
                     T_s: int = TS, words: int = J,
                     reps_of: dict = TS_REPS, sweeps: int = 20) -> None:
    """``LdaEngine(inner_mode="fused", sweeps=sweeps)`` at ``T_s`` over a
    ``words`` × ``T_s`` φ drawn from SEED on the card (the snapshot's
    host table is its copy): queries of NYTimes-shaped documents (their
    Zipf word ids taken modulo ``words``) of each size of ``reps_of``
    through the kernel, each answer checked, p50/p99 printed; fails
    unless the queries launched the kernel."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    phi = torch.rand((words, T_s), generator=gen, device=DEV).cpu()
    snap = PhiSnapshot(phi=phi.numpy(), meta=dict(
        format_version=PHI_FORMAT_VERSION, alpha=50.0 / T_s, beta=BETA,
        J=words, T=T_s))
    engine = LdaEngine(snap, sweeps=sweeps, inner_mode="fused", device=DEV)
    del phi, snap
    print(f"T={T_s} engine: φ {words} x {T_s} f32 drawn and published in "
          f"{time.perf_counter() - t0:.1f} s")
    pool = [d % words for d in _docs(r, 200, cdf)]
    fold_in_mod.launches = 0
    for n, reps in reps_of.items():
        lat = []
        for i in range(reps):
            docs = [pool[(i * n + j) % len(pool)] for j in range(n)]
            res = engine.query(TopicQuery(docs=tuple(docs)))
            lat.append(res.latency_s)
            _check_answer(res, docs)
        p50, p99 = _p50_p99(lat)
        print(json.dumps({"T": T_s, "batch_docs": n, "queries": reps,
                          "sweeps": sweeps,
                          "tokens": sum(d.size for d in docs),
                          "p50_ms": p50, "p99_ms": p99, "gpu": gpu}))
    if fold_in_mod.launches == 0:
        raise SystemExit(f"T={T_s}: the queries never launched the fold-in "
                         f"kernel")
    print(f"T={T_s} engine: answers finite, rows sum to 1, counts sum to "
          f"the lengths, kernel launches={fold_in_mod.launches}")
    del engine
    torch.cuda.empty_cache()


def _large_t_fold_in(cdf: np.ndarray, r: np.random.Generator) -> dict:
    """The fold-in kernel against its plain version at each T of TF, on a
    J × T φ drawn on the card (rows 0..6 zero; above TF_CUT of
    :func:`_cut_words` rows, past 2^31 entries, the words taken modulo
    them and every other token of document 0 on the last four rows) and
    TF_D short documents (one masked, one on the zero rows)."""
    out = {}
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    for T_f in TF:
        words = J if T_f <= TF_CUT else _cut_words(T_f)
        phi = torch.rand((words, T_f), generator=gen, device=DEV)
        phi[:7] = 0.0
        b = _fold_batch(phi, cdf, r, D=TF_D, L=TF_L, sweeps=TF_SWEEPS)
        if words < J:
            w = b["w"] % words
            w[0, ::2] = words - 1 - torch.arange(
                (TF_L + 1) // 2, device=DEV, dtype=torch.int32) % 4
            b["w"] = w

        def kernel():
            return fold_in_mod.fold_in_cuda(b["w"], b["v"], b["z0"],
                                            b["u_flat"], ALPHA, phi)

        got, ms = _timed(kernel)
        plain, plain_ms = _timed(lambda: fold_in_kernel_ref(
            b["w"], b["v"], b["z0"], b["u"], ALPHA, phi))
        if not torch.equal(got, plain):
            raise SystemExit(f"fold_in kernel at T={T_f} disagrees with its "
                             f"plain version")
        if not np.array_equal(got.sum(1).cpu().numpy(), b["lens"]):
            raise SystemExit(f"fold_in kernel at T={T_f}: counts do not "
                             f"sum to the lengths")
        ms = _event_ms(kernel, 3)
        steps = int(b["lens"].max()) * TF_SWEEPS
        rows = int(torch.unique(b["w"][b["v"] != 0]).numel())
        # as _fold_in_phase: the batch, uniforms, touched φ rows and the
        # counts moved once; add α, multiply, scan add, 2 compares a topic
        bound, by = bytes_ops_bound(
            4 * (3 * TF_D * TF_L + TF_D * TF_SWEEPS * TF_L + rows * T_f
                 + TF_D * T_f), int(b["lens"].sum()) * TF_SWEEPS * 5 * T_f)
        print(f"fold_in kernel: T={T_f}, φ {words} x {T_f}, D={TF_D} "
              f"L={TF_L} sweeps={TF_SWEEPS}, kernel {ms:.3f} ms "
              f"({ms * 1e3 / steps:.3f} us a step of the longest "
              f"document's {steps}), plain {plain_ms:.1f} ms, bound "
              f"{bound:.5f} ms ({by}), equal counts; n_td in device memory")
        out[T_f] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "us_a_step": ms * 1e3 / steps}
        del phi, b, got, plain
        torch.cuda.empty_cache()
    return out


def _large_t_vectorized(small: Corpus, gpu: str, gen) -> dict:
    """``NomadLDA(inner_mode="vectorized")`` at TL on the ragged layout of
    ``small`` (:func:`_vec_train`, on the card): VEC_SWEEPS sweeps of
    W·k pass-form launches each and one profiled, then the pass form on
    its first launch's tokens against its plain version
    (:func:`_pass_check`), then one sweep on the dense grid, its chain
    equal to the ragged one's."""
    lay = _layout(small, "ragged", T=TL)
    launches, states, model, a0 = _vec_train(
        f"ragged, vectorized, T={TL}", lay, gpu, profile=True, on_card=True)
    res = dict(_pass_check(model, a0, gen), launches=launches)
    del model, a0, lay
    torch.cuda.empty_cache()
    dense = _layout(small, "dense", T=TL)
    grid = _vec_train(f"dense grid, vectorized, T={TL}", dense, gpu,
                      sweeps=1, on_card=True)[1]
    _same_chain(f"T={TL} vectorized: dense grid vs ragged", grid,
                states[:1])
    print(f"T={TL} dense grid, vectorized: z and n_t equal the ragged "
          f"run's after its first sweep")
    del dense, grid, states
    torch.cuda.empty_cache()
    return res


def _score_inputs(T: int, gen) -> tuple:
    """Cut inputs of the pass form at ``T``: TV_TOKENS tokens of one cell,
    sorted by word (as the trainer's cells are), over TV_DOCS document
    rows, TV_WORDS word rows and one ``n_t`` row; their rows, topics,
    uniforms and the three tables."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=DEV,
                             dtype=torch.int32)

    n = TV_TOKENS
    rows = (ints(0, TV_DOCS, (n,)), ints(0, TV_WORDS, (n,)).sort().values,
            torch.zeros(n, dtype=torch.int32, device=DEV))
    tables = (ints(1, 5, (TV_DOCS, T)), ints(1, 30, (TV_WORDS, T)),
              ints(2000, 3000, (1, T)))
    return rows, ints(0, T, (n,)), torch.rand(n, generator=gen,
                                              device=DEV), tables


def _scores_check(T: int, gen) -> dict:
    """Both ``lda_scores`` forms at ``T`` on :func:`_score_inputs`, each
    against its plain version on the card (``z``, ``norm`` and, with the
    deltas applied, the three tables bit for bit) and timed; the op
    ``vectorized_pass`` driven once, every count 0 before (its launches)."""
    rows, z, u, tables = _score_inputs(T, gen)
    kw = dict(alpha=50.0 / T, beta=BETA, beta_bar=BETA * TV_WORDS)
    n = z.numel()
    plain, plain_ms = _timed(lambda: lda_scores_pass_ref(*rows, z, u,
                                                         *tables, **kw))
    want = [t.clone() for t in tables]
    apply_deltas(z, plain, rows, want)
    got = [t.clone() for t in tables]
    _zero_counts()
    drawn = vectorized_pass(*rows, z, u, *got, **kw)
    launches = _all_launches()
    if launches.pop("lda_scores_pass") != 1 or any(launches.values()):
        raise SystemExit(f"vectorized_pass at T={T} launched "
                         f"{_all_launches()}")
    _same(f"lda_scores pass form, T={T}", [drawn, *got], [plain, *want])
    ms = _event_ms(lambda: ls_mod.lda_scores_pass_cuda(*rows, z, u, *tables,
                                                       **kw), 5)
    uniq = [int(torch.unique(row).numel()) for row in rows]
    bound, by = bytes_ops_bound(4 * T * sum(uniq) + 4 * 6 * n,
                                 n * _SCORE_OPS * T)
    ntd, nwt = (t[row.long()] for t, row in zip(tables[:2], rows[:2]))
    got = lda_scores_draw(ntd, nwt, tables[2][0], u, **kw)
    plain_rows, rows_plain_ms = _timed(lambda: lda_scores_draw_ref(
        ntd, nwt, tables[2][0], u, **kw))
    _same(f"lda_scores rows form, T={T}", got, plain_rows)
    rows_ms = _event_ms(lambda: ls_mod.lda_scores_cuda(
        ntd, nwt, tables[2][0], u, **kw), 5)
    rows_bound = bytes_ops_bound(n * (8 * T + 12) + 4 * T,
                                 n * _SCORE_OPS * T)[0]
    where = ls_mod.placement(T)
    print(f"lda_scores at T={T} ({where}): {n} tokens, rows {uniq}; pass "
          f"form {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound:.5f} ms "
          f"({by}); rows form {rows_ms:.4f} ms, plain {rows_plain_ms:.2f} "
          f"ms, bound {rows_bound:.5f} ms; z, norm and tables equal")
    del ntd, nwt, got, plain_rows, want, tables
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, by=by, launches=1,
                placement=where, rows_ms=rows_ms,
                rows_plain_ms=rows_plain_ms, rows_bound_ms=rows_bound)


def _large_t_batched(gen) -> dict:
    """The batched F+tree path at SAMPLE_MAX_T, every count 0 before:
    DRAWS draws from a tree over seeded leaves (a third of them 0), one
    ``ftree_update`` by those draws, DRAWS draws again; the draws held to
    the plain version on the card, the tree to the plain version on the
    CPU (real deltas: the same order of adds).  Then ``ftree_update``
    with UPDATES integer deltas on an integer tree (against the plain
    version on the card and the CPU) and real ones (against the CPU);
    returns :func:`_update_check`'s numbers of the path's update."""
    Tn = SAMPLE_MAX_T
    p = torch.rand(Tn, generator=gen, device=DEV)
    p[torch.rand(Tn, generator=gen, device=DEV) < 0.3] = 0.0
    tree = ftree.build(p)
    u = torch.rand(DRAWS, generator=gen, device=DEV)
    u[:2] = torch.tensor([1.0 - 2**-24, 0.0], device=DEV)
    ones = torch.ones(DRAWS, device=DEV)
    _zero_counts()
    z = ftree_sample(tree, u)
    grown = ftree_update_batch(tree, z, ones)
    z2 = ftree_sample(grown, u)
    launches = _all_launches()
    if launches.pop("ftree_sample") != 2 or launches.pop(
            "ftree_update") != 1 or any(launches.values()):
        raise SystemExit(f"batched path at T={Tn} launched "
                         f"{_all_launches()}")
    _same(f"batched path draws, T={Tn}", [z, z2],
          [ftree_sample_ref(tree, u), ftree_sample_ref(grown, u)])
    _same(f"batched path tree vs the CPU, T={Tn}", [grown.cpu()],
          [ftree_update_ref(tree.cpu(), z.cpu(), ones.cpu())])
    print(f"batched path, T={Tn}: {DRAWS} draws, root "
          f"{float(tree[1]):.6g} -> {float(grown[1]):.6g}, redrawn topics "
          f"changed {int((z2 != z).sum())}, launches 2 + 1, equal")
    counts = torch.randint(0, 50, (Tn,), generator=gen, device=DEV).float()
    res = _update_check(
        {f"path, T={Tn}, its draws": (tree, z, ones),
         **_update_cases({f"integer, T={Tn}": ftree.build(counts),
                          f"real, T={Tn}": tree}, gen)})
    return dict(res, launches=1)


def _large_t_forms(corpus: Corpus, small: Corpus, gpu: str, gen,
                   r: np.random.Generator, t_forms=TL_FORMS) -> dict:
    """The six fused forms at each T of ``t_forms`` against their plain
    versions, on the ragged layout of ``small`` (the first TL_DOCS
    documents) at TL, else of the first TL_FORM_DOCS or, from TH_FROM,
    TH_DOCS; the trainer at TL (TL_DENSE dense sweeps and one sparse) and
    at TH (one dense, one sparse).  Returns the forms' numbers by T."""
    forms = {}
    for T_l, r_modes in t_forms:
        docs = (TL_DOCS if T_l == TL else TH_DOCS if T_l >= TH_FROM
                else TL_FORM_DOCS)
        lay = (_layout(small, "ragged", T=T_l) if T_l == TL else _layout(
            _first_docs(corpus, docs, dense_words=True), "ragged", T=T_l))
        model = NomadLDA(layout=lay, alpha=50.0 / T_l, beta=BETA,
                         inner_mode="fused", device=DEV)
        a0 = model.init_arrays(SEED)
        forms[T_l] = _six_forms(lay, a0, model.beta_bar, gen, r, TL_TILES,
                                TL_STREAM_TOKENS, TL_CELL_SLOTS, r_modes)
        if T_l in (TL, TH):
            heavy = int(a0["tok_valid"].sum(-1).max())
            print(f"T={T_l}: {docs} documents, {lay.num_words} words, "
                  f"{int(lay.cell_sizes.sum())} tokens, tile {lay.tile}, "
                  f"J_max {lay.J_max}, heaviest stream {heavy} valid "
                  f"tokens a round, n_wt {4 * a0['n_wt'].numel()} B; "
                  f"placement " + json.dumps({
                      m: fs_mod.placement(T_l, T_l, 0, m == "sparse")
                      for m in ("dense", "sparse")}))
            arrays, launches, _ = _large_t_sweeps(
                lay, a0, gpu, n_dense=TL_DENSE if T_l == TL else 1)
            forms[T_l]["fused_sweep_ragged"]["launches"] = launches
            del arrays
        del a0, model, lay
        torch.cuda.empty_cache()
    return forms


def _large_t_phase(corpus: Corpus, cdf: np.ndarray, gpu: str, gen,
                   r: np.random.Generator) -> dict:
    """(l) Large T.  The six fused forms at each T of TL_FORMS against
    their plain versions, and the fused trainer at TL and TH
    (:func:`_large_t_forms`); then one dense sweep at TL on the
    ``doc_tile=32`` grouped layout paged and unpaged, one chain; the
    ``lda_scores`` forms at each T of TV_FORMS; the vectorized trainer at
    TL on the first TL_DOCS documents; the batched F+tree path at
    SAMPLE_MAX_T; the engine at TS and at TE (a cut vocabulary); the
    fold-in kernel at each T of TF.  Returns the forms', the fold-in's,
    ``lda_scores``' and ``ftree_update``'s numbers by T."""
    # The first TL_DOCS documents' words numbered densely: a word without
    # tokens never enters a sweep, and the layout would pile every such
    # word into one block, padding n_wt to (B, J_max) with J_max ~20,000.
    small = _first_docs(corpus, TL_DOCS, dense_words=True)
    forms = _large_t_forms(corpus, small, gpu, gen, r)
    grouped = _layout(small, "ragged", DOC_TILE, T=TL)
    a0 = NomadLDA(layout=grouped, alpha=50.0 / TL, beta=BETA,
                  inner_mode="fused", doc_tile=DOC_TILE,
                  device=DEV).init_arrays(SEED)
    launches, paged = _large_t_sweeps(grouped, a0, gpu, DOC_TILE, 1,
                                      False)[1:]      # the arrays freed
    forms[TL]["fused_sweep_ragged_docs"]["launches"] = launches
    torch.cuda.empty_cache()
    unpaged = _large_t_sweeps(grouped, a0, gpu, None, 1, False)[2]
    _same_chain(f"T={TL} grouped ragged: paged vs unpaged", paged, unpaged)
    print(f"T={TL} grouped: one dense sweep paged == unpaged")
    del a0, paged, unpaged, grouped
    torch.cuda.empty_cache()
    scores = {T_v: _scores_check(T_v, gen) for T_v in TV_FORMS}
    scores[TL] = dict(scores[TL], **_large_t_vectorized(small, gpu, gen))
    update = {SAMPLE_MAX_T: _large_t_batched(gen)}
    torch.cuda.empty_cache()
    _large_t_serving(cdf, r, gpu)
    _large_t_serving(cdf, r, gpu, TE, _cut_words(TE), TE_REPS, TE_SWEEPS)
    return {"forms": forms, "fold_in": _large_t_fold_in(cdf, r),
            "lda_scores": {T_v: scores[T_v] for T_v in TV_KEYS},
            "ftree_update": update}


def _layout(corpus: Corpus, kind: str, doc_tile=None, T: int = T):
    t0 = time.perf_counter()
    lay = build_layout(corpus, n_workers=W, T=T, n_blocks=B, layout=kind,
                       doc_tile=doc_tile)
    last = lay.I_max - (lay.n_doc_tiles - 1) * lay.doc_tile
    extra = (f", doc_tile {lay.doc_tile}: {lay.n_doc_tiles} slabs a "
             f"worker, the last of {last} rows" if doc_tile else "")
    print(f"{kind} layout, T={T}: {time.perf_counter() - t0:.1f} s on the "
          f"host; "
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
    arrays, res["launches"], states, model, _ = _train(
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
    against their plain versions and the single-stream form's path.
    Returns the forms' numbers, the grouped ragged layout and the chain
    state after its first paged sweep."""
    lay = _layout(corpus, "ragged", DOC_TILE)
    model, a0 = _init(lay, DOC_TILE)
    res = {"fused_sweep_ragged_docs": _ragged_docs_check(
        lay, a0, model.beta_bar, gen)}
    res["fused_sweep_docs"] = _docs_check(lay, a0, model.beta_bar, gen)
    _paging_ab(lay, a0, model.beta_bar, gen, gpu)
    arrays, launches, paged, _, _ = _train(
        "grouped ragged, paged", lay, a0, 1, gpu,
        "fused_sweep_ragged_docs", DOC_TILE)
    res["fused_sweep_ragged_docs"]["launches"] = launches
    del arrays
    arrays, _, unpaged, _, _ = _train("grouped ragged, unpaged", lay, a0, 1,
                                   gpu, "fused_sweep_ragged")
    del arrays
    _same_chain("grouped ragged: paged vs unpaged", paged, unpaged)
    res["fused_sweep_docs"]["launches"] = _docs_path(lay, a0,
                                                     model.beta_bar, gen)
    grouped = lay
    del a0, unpaged, model
    torch.cuda.empty_cache()
    lay = _layout(corpus, "dense", DOC_TILE)
    model, arrays = _init(lay, DOC_TILE)
    res["fused_sweep_cells_docs"] = _cells_docs_check(lay, arrays,
                                                      model.beta_bar, gen)
    arrays, launches, dense, _, _ = _train(
        "grouped dense, paged", lay, arrays, 1, gpu,
        "fused_sweep_cells_docs", DOC_TILE)
    res["fused_sweep_cells_docs"]["launches"] = launches
    _same_chain("grouped dense paged vs grouped ragged paged", dense, paged)
    print("grouped: ragged paged == ragged unpaged == dense paged after "
          "each of 2 sweeps")
    return res, grouped, paged[0]


def _cross_check_phase(r: np.random.Generator, cdf: np.ndarray) -> None:
    """A small run at T=1024, W=4, one sweep, both r-modes: the dense
    grid equals the ragged stream (fused, both ring modes); on the grouped
    order, paged equals unpaged, dense equals ragged, both ring modes.
    The plain scan's chain is held to the fused one on the card by
    ``tests/test_torch_gpu.py`` (at T = 1024 too), not here."""
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
                      ("dense", None, "fused", "barrier")],
        "grouped": [("ragged", dt, "fused", "pipelined"),
                    ("ragged", dt, "fused", "barrier"),
                    ("ragged", None, "fused", "pipelined"),
                    ("dense", dt, "fused", "pipelined"),
                    ("dense", dt, "fused", "barrier"),
                    ("dense", None, "fused", "barrier")]}
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
                for s in range(1):
                    a = m.sweep(a, s)
                    states[-1].append(_chain_state(lay, a, canon))
            for run, got in zip(runs[1:], states[1:]):
                _same_chain(f"small run {r_mode} {name}: {run} vs "
                            f"{runs[0]}", got, states[0])
    print(f"small run: {corpus.num_tokens} tokens, W=4, B=8, T={T}, "
          f"doc_tile {dt}: dense == ragged, paged == unpaged, both ring "
          f"modes, after 1 sweep, both r-modes")


def _fold_batch(phi: torch.Tensor, cdf: np.ndarray, r: np.random.Generator,
                D: int = D, L: int = L, sweeps: int = SWEEPS) -> dict:
    """The fold-in kernel's check batch on ``phi``'s device: D documents of
    NYTimes lengths clipped to L, Zipf word ids (row 0 full, row 1 fully
    masked, row 2 full and on words 0..6), their draws for ``sweeps``."""
    dev = phi.device
    lens = np.clip(r.geometric(1.0 / MEAN_LEN, D), 1, L)
    lens[:3] = (L, 0, L)[:D]                           # full, masked, full
    words = np.zeros((D, L), np.int32)
    for i, n in enumerate(lens):
        words[i, :n] = np.searchsorted(cdf, r.random(n))
    if D > 2:
        words[2] = np.arange(L) % 7                    # zero-φ document
    valid = np.arange(L)[None, :] < lens[:, None]
    keys = doc_fold_key(rng.key(SEED, dev), torch.arange(D, device=dev))
    z0, u = fold_in_draws(keys, L, phi.shape[1], sweeps)
    return dict(w=torch.as_tensor(words, device=dev),
                v=torch.as_tensor(valid.astype(np.int32), device=dev),
                z0=z0, u=u, u_flat=u.reshape(D, sweeps * L), lens=lens,
                rows=np.unique(words[valid]).size)


def _chain_floor_ms(steps: int, T: int) -> float:
    """The fold-in chain's floor, computed, not measured: ``steps``
    dependent steps, each a chain of dependent f32 operations of
    FADD_CYCLES each at the card's highest SM clock.  A step's chain: the
    α add and the φ product, the 16-long scan of each level (one add
    fewer than its entries, at most 15), the add of each upper level's
    prefix back into the level below, and the cdf's add before the
    compare: 37 at T = 1024."""
    lens, n = [], -(-T // SCAN_BLOCK)
    while True:
        lens.append(n)
        if n <= SCAN_BLOCK:
            break
        n = -(-n // SCAN_BLOCK)
    ops = (2 + min(T, SCAN_BLOCK) - 1
           + sum(min(m, SCAN_BLOCK) - 1 for m in lens) + len(lens))
    return steps * ops * FADD_CYCLES / (_max_sm_mhz() * 1e3)


def _fold_in_phase(phi: torch.Tensor, cdf: np.ndarray,
                   r: np.random.Generator) -> dict:
    """The fold-in kernel against its plain version at the main path's
    width."""
    phi_k = phi.clone()
    phi_k[:7] = 0.0                                    # all-zero φ rows
    b = _fold_batch(phi_k, cdf, r)
    w, v, z0, u, lens = b["w"], b["v"], b["z0"], b["u"], b["lens"]

    def kernel():
        return fold_in_mod.fold_in_cuda(w, v, z0, b["u_flat"], ALPHA, phi_k)

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
    longest = int(lens.max()) * SWEEPS
    bytes_moved = (3 * D * L * 4 + D * SWEEPS * L * 4 + b["rows"] * T * 4
                   + D * T * 4)
    # add α, multiply, scan add, 2 compares
    bound, by = bytes_ops_bound(bytes_moved, valid_steps * 5 * T)
    floor = _chain_floor_ms(longest, T)
    print(f"fold_in kernel: D={D} L={L} T={T} J={J} sweeps={SWEEPS} "
          f"valid steps={valid_steps} phi rows={b['rows']} "
          f"kernel {ms:.3f} ms ({ms * 1e3 / longest:.3f} us a step of the "
          f"longest document's {longest}), plain {plain_ms:.1f} ms, "
          f"equal counts; chain floor {floor:.3f} ms (computed, not "
          f"measured: {longest} steps of dependent f32 ops)")
    return {"name": "fold_in", "route": "cuda",
            "source": "src/repro_torch/kernels/fold_in/csrc/fold_in.cu",
            "replaces": "src/repro/kernels/fold_in/fold_in.py:83",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def _long_fold_in(phi: torch.Tensor, cdf: np.ndarray,
                  r: np.random.Generator) -> dict:
    """The fold-in kernel's long placement against its plain version at
    T on LONG_D rows of LONG_L (``_fold_batch``: a full row, past the
    14,000 positions whose per-token arrays fit shared memory beside the
    state, a masked one, a full one on the all-zero φ rows) over
    LONG_SWEEPS, then timed alone on one full row of LONG_BUCKET, the
    engine's bucket of a LONG_DOC-token document, over SWEEPS."""
    if not fold_in_mod.long_placement(LONG_L, T):
        raise SystemExit(f"L={LONG_L} at T={T} does not take the long "
                         f"placement")
    phi_k = phi.clone()
    phi_k[:7] = 0.0
    b = _fold_batch(phi_k, cdf, r, D=LONG_D, L=LONG_L, sweeps=LONG_SWEEPS)

    def kernel():
        return fold_in_mod.fold_in_cuda(b["w"], b["v"], b["z0"],
                                        b["u_flat"], ALPHA, phi_k)

    got = kernel()
    torch.cuda.synchronize()
    plain, plain_ms = _timed(lambda: fold_in_kernel_ref(
        b["w"], b["v"], b["z0"], b["u"], ALPHA, phi_k))
    err = int((got - plain).abs().max())
    if not torch.equal(got, plain):
        raise SystemExit(f"fold_in kernel at L={LONG_L} disagrees with its "
                         f"plain version (max abs err {err})")
    if not np.array_equal(got.sum(1).cpu().numpy(), b["lens"]):
        raise SystemExit(f"fold_in kernel at L={LONG_L}: counts do not sum "
                         f"to the lengths")
    ms = _event_ms(kernel, 3)
    steps = int(b["lens"].max()) * LONG_SWEEPS
    # as _fold_in_phase: the batch, uniforms, touched φ rows and the counts
    # moved once; add α, multiply, scan add, 2 compares a topic
    bound, by = bytes_ops_bound(
        4 * (3 * LONG_D * LONG_L + LONG_D * LONG_SWEEPS * LONG_L
             + b["rows"] * T + LONG_D * T),
        int(b["lens"].sum()) * LONG_SWEEPS * 5 * T)
    e = _fold_batch(phi_k, cdf, r, D=1, L=LONG_BUCKET, sweeps=SWEEPS)
    e_ms = _event_ms(lambda: fold_in_mod.fold_in_cuda(
        e["w"], e["v"], e["z0"], e["u_flat"], ALPHA, phi_k), 2)
    e_steps = LONG_BUCKET * SWEEPS
    print(f"fold_in kernel, long placement: D={LONG_D} L={LONG_L} T={T} "
          f"sweeps={LONG_SWEEPS}, kernel {ms:.3f} ms ({ms * 1e3 / steps:.3f}"
          f" us a step of the longest document's {steps}), plain "
          f"{plain_ms:.1f} ms, bound {bound:.5f} ms ({by}), equal counts; "
          f"one full row of L={LONG_BUCKET}, {SWEEPS} sweeps: {e_ms:.3f} ms "
          f"({e_ms * 1e3 / e_steps:.4f} us a step of {e_steps})")
    del phi_k, b, e, got, plain
    torch.cuda.empty_cache()
    return {"L": LONG_L, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "us_a_step": ms * 1e3 / steps, "err": err,
            f"L{LONG_BUCKET}_ms": e_ms,
            f"L{LONG_BUCKET}_us_a_step": e_ms * 1e3 / e_steps}


def _long_serving(snapshot, cdf: np.ndarray, r: np.random.Generator,
                  gpu: str) -> dict:
    """``LdaEngine`` (fused, 20 sweeps) on a query of 8 NYTimes-shaped
    documents and one of LONG_DOC tokens, which takes its own bucket of
    LONG_BUCKET positions (the kernel's long placement): one query to
    warm, then LONG_REPS timed, each answer checked; fails unless they
    launched the kernel."""
    engine = LdaEngine(snapshot, device=DEV)
    docs = _docs(r, 8, cdf)
    docs.append(np.searchsorted(cdf, r.random(LONG_DOC)).astype(np.int32))
    engine.query(TopicQuery(docs=tuple(docs)))          # warm up
    fold_in_mod.launches = 0
    lat = []
    for _ in range(LONG_REPS):
        res = engine.query(TopicQuery(docs=tuple(docs)))
        lat.append(res.latency_s)
        _check_answer(res, docs)
    launches = fold_in_mod.launches
    if launches == 0:
        raise SystemExit("the long query never launched the fold-in kernel")
    if (1, LONG_BUCKET) not in res.batch_shape:
        raise SystemExit(f"the {LONG_DOC}-token document did not take its "
                         f"own bucket of {LONG_BUCKET}: {res.batch_shape}")
    p50, p99 = _p50_p99(lat)
    print(json.dumps({"long_query": {
        "batch_docs": len(docs), "long_doc_tokens": LONG_DOC,
        "batch_shape": res.batch_shape, "queries": LONG_REPS,
        "sweeps": res.sweeps_used, "p50_ms": p50, "p99_ms": p99,
        "launches": launches}, "gpu": gpu}))
    print(f"checks: the long query's answers finite, rows sum to 1, counts "
          f"sum to the lengths, kernel launches={launches}")
    del engine
    return {"query_p50_ms": p50, "query_p99_ms": p99,
            "query_launches": launches}


def _check_answer(res, docs) -> None:
    if not np.isfinite(res.theta).all():
        raise SystemExit("non-finite θ")
    if not np.allclose(res.theta.sum(1), 1.0, rtol=0, atol=1e-5):
        raise SystemExit(f"θ rows do not sum to 1: {res.theta.sum(1)}")
    if not np.array_equal(res.n_td.sum(1), [d.size for d in docs]):
        raise SystemExit("fold-in counts do not sum to the lengths")


def _serving_phase(snapshot, phi: torch.Tensor, cdf: np.ndarray,
                   r: np.random.Generator, gpu: str):
    """LdaEngine queries of 1, 8 and 64 docs; returns the kernel launches
    and each size's p50 and p99 in ms."""
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
    answers, idle = {}, {}
    for n, qs in queries.items():
        lat = []
        wall = time.perf_counter()
        for docs in qs:
            res = engine.query(TopicQuery(docs=tuple(docs)))
            lat.append(res.latency_s)
            answers.setdefault(n, res)
            _check_answer(res, docs)
        wall = time.perf_counter() - wall
        idle[n] = _p50_p99(lat)
        print(json.dumps({
            "batch_docs": n, "queries": len(qs), "p50_ms": idle[n][0],
            "p99_ms": idle[n][1], "docs_per_s": n * len(qs) / wall,
            "gpu": gpu}))
    launches = fold_in_mod.launches
    if launches == 0:
        raise SystemExit("the queries never launched the fold-in kernel")
    shapes = answers[64].batch_shape
    if not (isinstance(shapes[0], tuple)
            and max(s[1] for s in shapes) >= OUTLIER_LEN):
        raise SystemExit(f"the outlier did not split the length buckets: "
                         f"{shapes}")

    # The answers against the plain fold_in_batch and the serial fold_in
    # are held on the card by tests/test_torch_gpu.py::
    # test_engine_answers_equal_the_plain_and_serial_fold_in.
    print(f"checks: answers finite, rows sum to 1, counts sum to the "
          f"lengths, kernel launches={launches}")
    return launches, idle


def _p50_p99(lat_s: list) -> tuple:
    return (float(np.percentile(lat_s, 50)) * 1e3,
            float(np.percentile(lat_s, 99)) * 1e3)


def _resume_phase(lay, rotation: str, want: dict, writes: list, gpu: str):
    """Resume and fall back: a fresh ``NomadLDA(resume_from=rotation,
    collect_lag=True)`` skips the corrupted newest slot, loads the one
    before and runs the missing sweep; its canonical ``z``, global counts
    and ``n_t`` must equal ``want`` (the straight run's after that sweep)
    and its lag trace must pass ``stoken_lag_check``'s fold-schedule and
    staleness checks.  Returns the model and its arrays."""
    model = NomadLDA(layout=lay, alpha=ALPHA, beta=BETA, sync_mode="stoken",
                     inner_mode="fused", ring_mode="pipelined",
                     resume_from=rotation, checkpoint_keep=2,
                     collect_lag=True, device=DEV)
    rot = CheckpointRotation(rotation, keep=2)
    slots, pointer = [s for s, _ in rot.slots()], rot.last_good()
    load, loaded, states = model.load_checkpoint, {}, []

    def timed_load(path):
        t0 = time.perf_counter()
        arrays, start = load(path)
        torch.cuda.synchronize()
        loaded.update(ms=(time.perf_counter() - t0) * 1e3, start=start,
                      n_t0=arrays["n_t"].cpu().numpy())
        return arrays, start
    model.load_checkpoint = timed_load
    model.sweep = _timed_sweeps(model, "resumed", gpu, states)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays, _ = model.run(DENSE_SWEEPS)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    launches = _all_launches()
    if launches.pop("fused_sweep_ragged") != 2 * W or any(launches.values()):
        raise SystemExit(f"resume: launches {_all_launches()}; want 2·W "
                         f"fused_sweep_ragged and nothing else")
    if loaded["start"] != DENSE_SWEEPS - 1 or slots != [DENSE_SWEEPS - 1,
                                                        DENSE_SWEEPS]:
        raise SystemExit(f"resume: slots {slots}, resumed from "
                         f"{loaded['start']}; want a fall back past the "
                         f"corrupted slot {DENSE_SWEEPS}")
    _same_chain("resumed vs straight", states, [want])
    lag = arrays["lag"]
    if tuple(lag.shape) != (W, W, 2, T) or lag.dtype != torch.int32:
        raise SystemExit(f"lag trace {tuple(lag.shape)} {lag.dtype}")
    t1 = time.perf_counter()
    report = lag_report(lag.cpu().numpy(), loaded["n_t0"], lay.cell_sizes,
                        lay.k)
    lag_s = time.perf_counter() - t1
    failed = [k for k in ("fold_schedule_exact", "lag_within_bound",
                          "lag_nonzero", "documented_bound_ok")
              if not report[k]]
    if failed:
        raise SystemExit(f"lag trace fails {failed}: {report}")
    print(json.dumps({
        "resume": "equal to the straight run", "slots": slots,
        "slot_bytes": [w["slot_bytes"] for w in writes],
        "write_ms": [w["write_ms"] for w in writes],
        "last_good_pointer": pointer, "resumed_from_slot": loaded["start"],
        "load_restore_ms": loaded["ms"], "recovery_s": recovery_s,
        "lag_bytes": lag.nelement() * 4, "lag_check_s": lag_s,
        "lag_max_l1": report["lag_max_l1"],
        "bound_max_l1": report["bound_max_l1"], "gpu": gpu}))
    return model, arrays


def _publish_phase(lay, rotation: str, first, want: dict, idle: dict,
                   cdf: np.ndarray, r: np.random.Generator, gpu: str) -> int:
    """Publish while serving: a thread resumes the chain from
    ``rotation`` and runs 2 sweeps with ``publish_every=1`` into an
    ``LdaEngine(inner_mode="fused")`` serving ``first``, while this thread
    queries it with 1 and 8 documents, at least PUBLISH_QUERIES times.
    Checks: no torn read, the publishing chain equal to ``want`` after its
    first sweep, and per generation the shortest one-document answers
    equal to the serial fold-in against that generation's φ.  Prints
    p50/p99 while training beside ``idle``; returns the fold-in
    launches."""
    engine = LdaEngine(first, inner_mode="fused", device=DEV)
    published = {1: (first.digest, torch.as_tensor(first.phi, device=DEV))}
    lock = threading.Lock()

    def record(snap):
        phi = torch.as_tensor(snap.phi, device=DEV)
        gen = engine.publish(snap)
        with lock:
            published[gen] = (snap.digest, phi)

    trainer = NomadLDA(layout=lay, alpha=ALPHA, beta=BETA,
                       sync_mode="stoken", inner_mode="fused",
                       ring_mode="pipelined", resume_from=rotation,
                       checkpoint_keep=2, device=DEV)
    canon = torch.as_tensor(lay.canon_idx, device=DEV)
    chain, errors = [], []

    def on_sweep(s, arrays):
        if s == DENSE_SWEEPS - 1:
            chain.append(_chain_state(lay, arrays, canon))

    def train():
        try:
            trainer.run(DENSE_SWEEPS + 1, publish_every=1,
                        on_publish=record, on_sweep=on_sweep)
        except Exception as e:
            errors.append(repr(e))

    pool = _docs(r, 64, cdf)
    _zero_counts()
    th = threading.Thread(target=train, daemon=True)
    t0 = time.perf_counter()
    th.start()
    answers, i = [], 0
    while i < PUBLISH_QUERIES or th.is_alive():
        n = (1, 8)[i % 2]
        docs = [pool[(i * 8 + j) % len(pool)] for j in range(n)]
        res = engine.query(TopicQuery(docs=tuple(docs),
                                      key=rng.key(1000 + i % 5, DEV)))
        _check_answer(res, docs)
        answers.append((n, i % 5, docs, res))
        i += 1
    th.join()
    wall = time.perf_counter() - t0
    launches = _all_launches()
    if errors:
        raise SystemExit(f"publishing trainer failed: {errors[0]}")
    torn = sum(published.get(res.generation, (None,))[0] != res.digest
               for *_, res in answers)
    gens = sorted({res.generation for *_, res in answers})
    if torn or len(published) != 3 or len(gens) < 2:
        raise SystemExit(f"publish while serving: {torn} torn reads, "
                         f"{len(published)} publishes, generations {gens}")
    _same_chain("publishing run vs straight", chain, [want])
    audited = 0
    for gen in gens:
        ones = sorted((a for a in answers if a[0] == 1
                       and a[3].generation == gen and a[2][0].size),
                      key=lambda a: a[2][0].size)[:2]
        for _, kidx, docs, res in ones:
            serial = fold_in(docs[0], np.zeros(docs[0].size, np.int64), 1,
                             published[gen][1], ALPHA,
                             rng.key(1000 + kidx, DEV), engine.sweeps)
            if not np.array_equal(serial.cpu().numpy(), res.n_td):
                raise SystemExit(f"generation {gen}: a served answer "
                                 f"differs from the serial fold-in")
            audited += 1
    fused = launches.pop("fused_sweep_ragged")
    folds = launches.pop("fold_in")
    if fused != 2 * W * 2 or folds == 0 or any(launches.values()):
        raise SystemExit(f"publish while serving: launches "
                         f"{_all_launches()}")
    lat = {n: _p50_p99([a[3].latency_s for a in answers if a[0] == n])
           for n in (1, 8)}
    print(json.dumps({
        "publish_while_serving": "no torn read", "queries": len(answers),
        "generations_seen": gens, "torn_reads": torn,
        "serial_audited": audited, "wall_s": wall,
        "training_p50_p99_ms": {str(n): lat[n] for n in lat},
        "idle_p50_p99_ms": {str(n): idle[n] for n in lat},
        "fused_sweep_ragged_launches": fused, "fold_in_launches": folds,
        "gpu": gpu}))
    return folds


def _same_layout(name: str, got, want) -> None:
    """Fail unless two layouts agree in every field, arrays byte for byte
    and dtype for dtype."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            if a.dtype != b.dtype or a.shape != b.shape \
                    or a.tobytes() != b.tobytes():
                raise SystemExit(f"{name}: {f.name} differs")
        elif a != b:
            raise SystemExit(f"{name}: {f.name} is {a}, want {b}")


def _carried_state(lay, z_canon: np.ndarray) -> dict:
    """The chain state of canonical topics ``z_canon`` on ``lay``: the
    count tables rebuilt from them on the card (global doc and word
    rows), as ``restore_chain_state`` takes them."""
    gdoc, gwrd = (torch.as_tensor(a, device=DEV).long()
                  for a in lay.token_globals())
    z = torch.as_tensor(z_canon, device=DEV).long()
    one = torch.ones_like(z, dtype=torch.int32)
    state = {"z_canon": z_canon.astype(np.int32),
             "n_t": torch.bincount(z, minlength=T).int().cpu().numpy()}
    for key, rows, ids in (("n_td", lay.doc_assign.shape[0], gdoc),
                           ("n_wt", lay.num_words, gwrd)):
        table = torch.zeros((rows, T), dtype=torch.int32, device=DEV)
        table.index_put_((ids, z), one, accumulate=True)
        state[key] = table.cpu().numpy()
    return state


def _launched(want: dict, label: str) -> dict:
    """The launches since the counts were set to 0; fail unless they are
    ``want`` (kernel: launches) and nothing else."""
    got = {k: v for k, v in _all_launches().items() if v}
    if got != want:
        raise SystemExit(f"{label}: launches {got}, want {want}")
    return got


def _store_phase(corpus: Corpus, grouped, want: dict, cdf: np.ndarray,
                 gpu: str) -> dict:
    """(e) The out-of-core store at the grouped ragged run's width: write
    the corpus into a ``CorpusStore`` (shards of STORE_SHARD tokens),
    build the layout from it and hold it byte for byte to ``grouped``
    (the ``build_layout`` of phase (b)), sweep it once fused and paged
    (equal to phase (b)'s first sweep, ``want``), retire STORE_CHURN
    documents and add as many, update the layout, carry the chain across
    and restore it into a fresh trainer; survivors keep their topics and
    uids, and one paged and one unpaged sweep from the carried state are
    equal, launch 2·W times each and keep the counts equal to ``z``.
    Returns the launches of the phase's sweeps."""
    times, launches = {}, {}
    kw = dict(alpha=ALPHA, beta=BETA, sync_mode="stoken",
              inner_mode="fused", ring_mode="pipelined", device=DEV)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-store-") as path:
        t0 = time.perf_counter()
        store = CorpusStore.from_corpus(corpus, path,
                                        tokens_per_shard=STORE_SHARD)
        times["store_write_s"] = time.perf_counter() - t0
        shard_bytes = sum(os.path.getsize(os.path.join(path, f))
                          for f in os.listdir(path) if f.endswith(".npz"))
        t0 = time.perf_counter()
        lay = build_layout_from_store(store, n_workers=W, T=T, n_blocks=B,
                                      layout="ragged", doc_tile=DOC_TILE)
        times["streaming_build_s"] = time.perf_counter() - t0
        _same_layout("build_layout_from_store vs build_layout", lay, grouped)
        model = NomadLDA(layout=lay, doc_tile=DOC_TILE, **kw)
        a0 = model.init_arrays(SEED)
        _zero_counts()
        arrays = model.sweep(a0, 0)
        launches["first"] = _launched({"fused_sweep_ragged_docs": 2 * W},
                                      "store layout, paged sweep")
        canon = torch.as_tensor(lay.canon_idx, device=DEV)
        _same_chain("store layout vs grouped layout, first sweep",
                    [_chain_state(lay, arrays, canon)], [want])
        z_old = lay.extract_canonical(arrays["z"].cpu().numpy())
        del a0, arrays, canon
        torch.cuda.empty_cache()

        r = np.random.default_rng(SEED)
        retire = np.sort(r.choice(DOCS, STORE_CHURN, replace=False))
        new = _docs(r, STORE_CHURN, cdf)
        ad = np.repeat(np.arange(DOCS, DOCS + STORE_CHURN, dtype=np.int32),
                       [d.size for d in new])
        aw = np.concatenate(new)
        t0 = time.perf_counter()
        store.retire(retire).append(ad, aw)
        times["store_retire_append_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        new_lay, o2n = update_layout(lay, add_doc_ids=ad, add_word_ids=aw,
                                     retire=retire, num_new_docs=STORE_CHURN)
        times["update_s"] = time.perf_counter() - t0
        gdoc, _ = new_lay.token_globals()
        if int(new_lay.cell_sizes.sum()) != store.num_tokens or not \
                np.array_equal(np.bincount(gdoc, minlength=store.num_docs),
                               store.doc_lengths()):
            raise SystemExit("the updated layout's documents are not the "
                             "store's")
    t0 = time.perf_counter()
    z_new = carry_assignments(z_old, o2n, new_lay, seed=SEED)
    state = _carried_state(new_lay, z_new)
    times["carry_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paged = NomadLDA(layout=new_lay, doc_tile=DOC_TILE, **kw)
    a1, seed = paged.restore_chain_state(state, paged._chain_meta(
        next_seed=1))
    torch.cuda.synchronize()
    times["restore_s"] = time.perf_counter() - t0

    surv = o2n >= 0
    tgt = o2n[surv]
    ow, ob, _, _ = lay.token_coords()
    nw, nb, _, _ = new_lay.token_coords()
    oslot = lay.extract_canonical(lay.tok_slot)
    nslot = new_lay.extract_canonical(new_lay.tok_slot)
    if not (np.array_equal(z_new[tgt], z_old[surv])
            and np.array_equal(ow[surv], nw[tgt])
            and np.array_equal(ob[surv], nb[tgt])
            and np.array_equal(oslot[surv], nslot[tgt])
            and new_lay.L == lay.L):
        raise SystemExit("a surviving token lost its topic or its uid")
    runs = {}
    for name, trainer, kernel in (
            ("paged", paged, "fused_sweep_ragged_docs"),
            ("unpaged", NomadLDA(layout=new_lay, **kw),
             "fused_sweep_ragged")):
        _zero_counts()
        torch.cuda.synchronize()
        host = time.perf_counter()
        out = trainer.sweep(a1, seed)
        torch.cuda.synchronize()
        times[f"{name}_sweep_s"] = time.perf_counter() - host
        launches[name] = _launched({kernel: 2 * W},
                                   f"carried chain, {name}")
        if _mismatches(trainer, out):
            raise SystemExit(f"carried chain, {name}: counts differ from z")
        runs[name] = _chain_state(new_lay, out,
                                  torch.as_tensor(new_lay.canon_idx,
                                                  device=DEV))
        del out
    _same_chain("carried chain: paged vs unpaged", [runs["paged"]],
                [runs["unpaged"]])
    print(json.dumps({"store": dict(
        times, shards=store.num_shards, shard_bytes=shard_bytes,
        retired=STORE_CHURN, added=STORE_CHURN, added_tokens=int(ad.size),
        survivors=int(surv.sum()), tokens=int(new_lay.cell_sizes.sum()),
        I_max=new_lay.I_max, L=new_lay.L,
        overflow_slots=int((nslot >= new_lay.L).sum()), gpu=gpu)}))
    print(f"store: streamed layout == build_layout; after retiring and "
          f"adding {STORE_CHURN} documents, survivors keep topics and "
          f"uids, paged == unpaged, counts == z")
    total = {}
    for run in launches.values():
        for k, v in run.items():
            total[k] = total.get(k, 0) + v
    return total


def _heldout_phase(counts: tuple, init_counts: tuple, cdf: np.ndarray,
                   gpu: str) -> dict:
    """(f) Document-completion perplexity of HELDOUT_DOCS held-out
    NYTimes-shaped documents (their own seed) against the trained counts
    and against the initial ones: the fold-in counts of the first
    HELDOUT_CHECKED documents equal the plain version's on the card, the
    scores are finite, and the trained score launches the fold-in kernel
    and nothing else.  The documents' words are drawn independently of
    each other, so no model beats the Zipf law that drew them; its own
    perplexity on the scored tokens is printed beside the two scores.
    Returns the launches of the trained score."""
    r = np.random.default_rng(HELDOUT_SEED)
    docs = _docs(r, HELDOUT_DOCS, cdf)
    held = Corpus(doc_ids=np.repeat(np.arange(HELDOUT_DOCS, dtype=np.int32),
                                    [d.size for d in docs]),
                  word_ids=np.concatenate(docs), num_docs=HELDOUT_DOCS,
                  num_words=J)
    key = rng.key(0, DEV)
    phi = heldout._phi_hat(torch.as_tensor(counts[0], device=DEV),
                           torch.as_tensor(counts[1], device=DEV), BETA)
    order = held.doc_order()
    first = heldout._positions_in_doc(held.doc_ids[order]) % 2 == 0
    est = order[first]
    folded = heldout._fold_in_halves(held.word_ids[est], held.doc_ids[est],
                                     HELDOUT_DOCS, phi, ALPHA, key, SWEEPS)
    rows = [d[::2] for d in docs[:HELDOUT_CHECKED]]
    width = max(x.size for x in rows)
    words = np.zeros((HELDOUT_CHECKED, width), np.int32)
    valid = np.arange(width)[None, :] < np.array([x.size
                                                  for x in rows])[:, None]
    words[valid] = np.concatenate(rows)
    t0 = time.perf_counter()
    plain = heldout.fold_in_batch(
        torch.as_tensor(words, device=DEV), torch.as_tensor(valid,
                                                            device=DEV),
        phi, ALPHA, doc_fold_key(key, torch.arange(HELDOUT_CHECKED,
                                                   device=DEV)), SWEEPS)
    plain_s = time.perf_counter() - t0
    if not torch.equal(folded[:HELDOUT_CHECKED], plain):
        raise SystemExit("held-out fold-in: the kernel's counts differ from "
                         "the plain version's")
    del folded, plain, phi
    p_law = np.diff(cdf, prepend=0.0)
    out = {"docs": HELDOUT_DOCS, "tokens": held.num_tokens,
           "checked_docs": HELDOUT_CHECKED, "plain_check_s": plain_s,
           "zipf_law_perplexity": float(np.exp(-np.log(
               p_law[held.word_ids[order[~first]]]).mean()))}
    for which, (n_wt, n_t) in (("trained", counts),
                               ("initial", init_counts)):
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[which] = heldout.document_completion_perplexity(
            held, n_wt, n_t, alpha=ALPHA, beta=BETA, fold_sweeps=SWEEPS,
            device=DEV)
        out[f"{which}_ms"] = (time.perf_counter() - t0) * 1e3
        if which == "trained":
            launches = {k: v for k, v in _all_launches().items() if v}
    out["fold_in_launches"] = launches.get("fold_in", 0)
    print(json.dumps({"heldout": dict(out, gpu=gpu)}))
    if list(launches) != ["fold_in"]:
        raise SystemExit(f"held-out: launches {launches}, want fold_in only")
    if not (math.isfinite(out["trained"]) and math.isfinite(out["initial"])):
        raise SystemExit(f"held-out: a perplexity is not finite: {out}")
    return launches


def _count(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def _twins_phase(gpu: str) -> dict:
    """(g) The launch twins and the serial leftovers at their own sizes:
    ``lda_matrix_check 4 1 smoke`` all exact; ``lda_dist_check`` on
    DIST_CONFIGS, every check passed; the quickstart twin's 20 sweeps
    with ll/token rising; one ``sweep_fplda_doc`` sweep over the
    quickstart corpus's first DOC_SWEEP_DOCS documents equal to the same
    sweep on the CPU.  Returns the launches of all of them."""
    total, times = {}, {}
    _zero_counts()
    t0 = time.perf_counter()
    rep = lda_matrix_check.run_matrix(4, 1, "smoke", device=DEV)
    times["matrix_smoke_s"] = time.perf_counter() - t0
    if not rep["all_exact"]:
        raise SystemExit(f"lda_matrix_check 4 1 smoke: {rep}")
    _count(total, {k: v for k, v in _all_launches().items() if v})
    print(json.dumps({"matrix_smoke": {
        "combos": len(rep["combos"]), "all_exact": rep["all_exact"],
        "slab_smem": rep["slab_smem"], "s": times["matrix_smoke_s"],
        "gpu": gpu}}))
    for args in DIST_CONFIGS:
        _zero_counts()
        t0 = time.perf_counter()
        rep = lda_dist_check.run_check(lda_dist_check.parse_args(
            args + ["--device", DEV]))
        wall = time.perf_counter() - t0
        got = {k: v for k, v in _all_launches().items() if v}
        _count(total, got)
        print(json.dumps({"dist_check": " ".join(args), "passed":
                          lda_dist_check.passed(rep), "ll": rep["ll"],
                          "tokens_per_sec": rep["tokens_per_sec"],
                          "ref_sweep_sec": rep["ref_sweep_sec"],
                          "launches": got, "s": wall, "gpu": gpu}))
        if not lda_dist_check.passed(rep):
            raise SystemExit(f"lda_dist_check {' '.join(args)}: {rep}")
    _zero_counts()
    t0 = time.perf_counter()
    canary = lda_canary_check.run(CANARY_WORKERS, CANARY_REPS, device=DEV)
    times["canary_s"] = time.perf_counter() - t0
    got = {k: v for k, v in _all_launches().items() if v}
    _count(total, got)
    print(json.dumps({"canary": canary, "launches": got, "gpu": gpu}))
    # two layouts, CANARY_REPS + 1 sweeps each, a launch a round at least
    if (list(got) != ["fused_sweep_ragged"]
            or got["fused_sweep_ragged"]
            < 2 * (CANARY_REPS + 1) * CANARY_WORKERS
            or not all(math.isfinite(canary[k]) and canary[k] > 0
                       for k in ("tokens_per_sec_w", "tokens_per_sec_4w",
                                 "ratio_4w_over_w"))):
        raise SystemExit(f"lda_canary_check: {canary}, launches {got}")
    _zero_counts()
    t0 = time.perf_counter()
    out = quickstart.main(["--device", DEV])
    times["quickstart_s"] = time.perf_counter() - t0
    _count(total, _launched({"fused_sweep": 20}, "quickstart twin"))
    lls = [ll for _, ll in out["ll"]]
    if not all(b > a for a, b in zip(lls, lls[1:])):
        raise SystemExit(f"quickstart twin: ll/token did not rise: {lls}")
    corpus, _, _ = synthetic.make_corpus(num_docs=400, vocab_size=512,
                                         num_topics=16, mean_doc_len=60.0,
                                         seed=0)
    sub = corpus.subset(np.arange(corpus.num_docs) < DOC_SWEEP_DOCS)
    order = sub.doc_order()
    d = sub.doc_ids[order]
    bound = np.concatenate([[True], d[1:] != d[:-1]])
    after = {}
    for dev in (DEV, "cpu"):
        state = cgs.init_state(sub, 16, rng.key(SEED, dev))
        t0 = time.perf_counter()
        after[dev] = cgs.sweep_fplda_doc(state, sub.doc_ids, sub.word_ids,
                                         order, bound, 50.0 / 16, 0.01)
        times[f"doc_sweep_{dev}_s"] = time.perf_counter() - t0
    for got, want in zip(after[DEV][:4], after["cpu"][:4]):
        if not torch.equal(got.cpu(), want):
            raise SystemExit("sweep_fplda_doc: the card's chain differs "
                             "from the CPU's")
    bad = cgs.check_invariants(after[DEV], sub)
    if any(bad.values()):
        raise SystemExit(f"sweep_fplda_doc: invariants {bad}")
    print(json.dumps({"twins": dict(times, quickstart_ll=lls,
                                    doc_sweep_tokens=sub.num_tokens,
                                    gpu=gpu)}))
    print("twins: matrix smoke all exact, the distributed checks passed, "
          "the canary timed, quickstart ll/token rising, the doc-by-doc "
          "sweep equal to the CPU's")
    return total


def _host_s(fn):
    """``fn()``'s result and its host time in s, the card drained before
    and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same_tuple(name: str, got: tuple, want: tuple) -> None:
    """Fail unless every field of two states (or outputs) is equal."""
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if not torch.equal(g.cpu(), w.cpu()):
            raise SystemExit(f"{name}: field {i} on the card differs from "
                             f"the CPU's")


def _table1_ops(name: str, T: int, dev) -> tuple:
    """Sampler ``name`` at ``T`` on ``dev``, as ``benchmarks/sampler_bench.
    py`` drives it: ``init`` of its row, TABLE1_OPS draws in one batch,
    TABLE1_OPS updates in sequence (for Alias one rebuild, the update of
    paper Table 1), each op run once untimed first.  Returns the states
    after init and after the updates, the draws and each op's µs (host
    clock, the card drained before and after)."""
    init, draw, update = samplers.SAMPLERS[name]
    p = torch.as_tensor((np.random.default_rng(T).random(T) + 0.01).astype(
        np.float32), device=dev)
    u = torch.as_tensor(np.random.default_rng(1).random(TABLE1_OPS).astype(
        np.float32), device=dev)
    ts = torch.as_tensor(np.random.default_rng(2).integers(
        0, T, TABLE1_OPS).astype(np.int32), device=dev)
    ds = torch.as_tensor((np.random.default_rng(3).random(TABLE1_OPS)
                          * 0.1).astype(np.float32), device=dev)
    if name == "alias":
        def many(n):
            return samplers.alias_update(state, ts[0], ds[0], p=p)
    else:
        def many(n):
            st = state
            for t, d in zip(ts[:n], ds[:n]):
                st = update(st, t, d)
            return st
    n_upd = 1 if name == "alias" else TABLE1_OPS
    state = init(p)                       # each op once, untimed
    draw(state, u[:1])
    many(1)
    state, s_init = _host_s(lambda: init(p))
    z, s_draw = _host_s(lambda: draw(state, u))
    after, s_upd = _host_s(lambda: many(n_upd))
    return state, after, z, {"init_us": s_init * 1e6,
                             "draw_us": s_draw * 1e6 / TABLE1_OPS,
                             "update_us": s_upd * 1e6 / n_upd}


def _table1_phase(gpu: str) -> None:
    """(h) Paper Table 1's ops of the four samplers at each of TABLE1_T,
    on the card and on the CPU: the states after init and after the
    updates and the draws equal bit for bit, the F+tree's draws launched
    through ``ftree_sample`` and equal to ``ftree_sample_ref``; µs an op
    printed for each device."""
    for T in TABLE1_T:
        for name in samplers.SAMPLERS:
            card = _table1_ops(name, T, DEV)
            cpu = _table1_ops(name, T, "cpu")
            _same_tuple(f"table1 {name} T={T} init", card[0], cpu[0])
            _same_tuple(f"table1 {name} T={T} update", card[1], cpu[1])
            _same_tuple(f"table1 {name} T={T} draws", (card[2],), (cpu[2],))
            if name == "ftree":
                u = torch.as_tensor(np.random.default_rng(1).random(
                    TABLE1_OPS).astype(np.float32), device=DEV)
                if not torch.equal(card[2], ftree_sample_ref(card[0].F, u)):
                    raise SystemExit(f"table1 ftree T={T}: the kernel's "
                                     "draws differ from ftree_sample_ref")
            print(json.dumps({"table1": name, "T": T, "card": card[3],
                              "cpu": cpu[3], "gpu": gpu}))


def _table2_sweep(kind: str, state: dict, corpus: Corpus,
                  order: np.ndarray, dev) -> tuple:
    """One SparseLDA (bucket stats) or AliasLDA (TABLE2_MH steps, MH
    stats) sweep over ``order`` from ``state`` on ``dev``, the key
    ``rng.key(SEED)``; the next state, the stats and the host seconds."""
    st = cgs.LDAState(*(state[k].to(dev) for k in ("z", "n_td", "n_wt",
                                                   "n_t")),
                      key=rng.key(SEED, dev))
    if kind == "sparse":
        fn = lambda: sweep_sparse_lda(st, corpus.doc_ids, corpus.word_ids,
                                      order, ALPHA, BETA,
                                      return_bucket_stats=True)
    else:
        fn = lambda: sweep_alias_lda(st, corpus.doc_ids, corpus.word_ids,
                                     order, ALPHA, BETA, num_mh=TABLE2_MH,
                                     return_mh_stats=True)
    (new, stats), s = _host_s(fn)
    return new, stats, s


def _table2_phase(lay, state: dict, gpu: str) -> None:
    """(h) Paper Table 2's baselines at the smoke's width: one
    ``sweep_sparse_lda`` and one ``sweep_alias_lda`` over the first
    TABLE2_TOKENS tokens in document order, each from the trained ragged
    chain (its ``z`` in the layout's canonical token order, with the
    tokens' global documents and words, and its counts), on the card and
    on the CPU: ``z``, the counts, the key and the stats equal bit for
    bit, the counts equal to ``z``, every MH step ok; µs a token and the
    bucket shares printed."""
    gdoc, gwrd = lay.token_globals()
    corpus = Corpus(doc_ids=gdoc.astype(np.int32),
                    word_ids=gwrd.astype(np.int32),
                    num_docs=state["n_td"].shape[0], num_words=J)
    order = corpus.doc_order()[:TABLE2_TOKENS]
    for kind in ("sparse", "alias"):
        card, stats, s_card = _table2_sweep(kind, state, corpus, order, DEV)
        cpu, stats_cpu, s_cpu = _table2_sweep(kind, state, corpus, order,
                                              "cpu")
        _same_tuple(f"table2 {kind}", (*card[:4], stats),
                    (*cpu[:4], stats_cpu))
        if not torch.equal(card.key.cpu(), cpu.key):
            raise SystemExit(f"table2 {kind}: the keys differ")
        bad = cgs.check_invariants(card, corpus)
        if any(bad.values()):
            raise SystemExit(f"table2 {kind}: invariants {bad}")
        out = {"table2": kind, "tokens": int(order.size), "T": T,
               "card_us_a_token": s_card * 1e6 / order.size,
               "cpu_us_a_token": s_cpu * 1e6 / order.size}
        if kind == "sparse":
            share = torch.bincount(stats.long(), minlength=3) / order.size
            out["bucket_share"] = dict(zip(("smoothing", "doc", "word"),
                                           share.tolist()))
        else:
            out["num_mh"] = TABLE2_MH
            out["mh_ok"] = int(stats.sum())
            if not bool(stats.all()):
                raise SystemExit(f"table2 alias: {order.size - out['mh_ok']}"
                                 " tokens with a broken MH step")
        print(json.dumps(dict(out, gpu=gpu)))


def _baselines_phase(lay, state: dict, gpu: str) -> dict:
    """(h) The baseline samplers on the card (Table 1 ops, then the
    Table 2 sweeps); returns the launches of the phase."""
    _zero_counts()
    _table1_phase(gpu)
    _table2_phase(lay, state, gpu)
    launches = {k: v for k, v in _all_launches().items() if v}
    want = {"ftree_sample": 2 * len(TABLE1_T)}    # untimed, then timed
    if launches != want:
        raise SystemExit(f"baselines: launches {launches}, want {want}")
    print("baselines: card equal to the CPU, the F+tree's draws through "
          "the kernel, every MH step ok")
    return launches


def _sweep_entry(name: str, replaces: str, res: dict):
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/fused_sweep/csrc/"
                      "fused_sweep.cu",
            "replaces": replaces, "launches": res["launches"],
            "max_abs_err": res["err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["by"], "library_ms": None,
            **res.get("extra", {})}


def _card_rates() -> dict:
    """The card's own rates, by CUDA events: an f32 matmul (TF32 off) and
    a bf16 matmul of 8192², and a 4 GB device-to-device copy (read and
    write counted)."""
    n, out = RATE_N, {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = torch.randn(n, n, device=DEV, dtype=dt)
        ms = _event_ms(lambda: x @ x, 10)
        out[f"{name}_matmul_ms"] = ms
        out[f"{name}_flops_per_s"] = 2 * n ** 3 / ms * 1e3
        del x
    a = torch.empty(RATE_COPY_BYTES // 4, device=DEV)
    b = torch.empty_like(a)
    ms = _event_ms(lambda: b.copy_(a), 5)
    out["copy_ms"] = ms
    out["hbm_bytes_per_s"] = 2 * RATE_COPY_BYTES / ms * 1e3
    del a, b
    torch.cuda.empty_cache()
    return out


def _dryrun_phase(gpu: str, granite: dict) -> None:
    """(k): the card's rates beside ``HW``'s, (j)'s counted ``granite``
    step against its roofline, and the full-size dry-runs (raises on a
    report with an ``error``)."""
    rates = _card_rates()
    print(json.dumps({"card_rates": dict(rates, gpu=gpu, hw={
        "card": HW.CARD, "power_limit_w": HW.POWER_LIMIT_W,
        "f32_flops_per_s": HW.PEAK_FLOPS_F32,
        "bf16_flops_per_s": HW.PEAK_FLOPS_BF16,
        "hbm_bytes_per_s": HW.HBM_BW, "link_bytes_per_s": HW.LINK_BW})}))
    c = granite["counted_step"]
    print(json.dumps({"granite_step_roofline": {
        "flops": c["flops"], "dry_run_flops": c["dry_run_flops"],
        "bytes": c["bytes"],
        "compute_s_at_measured_f32": c["flops"] / rates["f32_flops_per_s"],
        "compute_s_at_data_sheet_f32": c["flops"] / HW.PEAK_FLOPS_F32,
        "memory_s_at_measured_copy": c["bytes"] / rates["hbm_bytes_per_s"],
        "step_s_measured": granite["steady_step_ms"] / 1e3, "gpu": gpu}}))
    for arch, shape, multi_pod in DRYRUN_COMBOS:
        t0 = time.perf_counter()
        mesh_name = "2x16x16" if multi_pod else "16x16"
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
            rep = dryrun.dry_run(arch, shape, mesh, mesh_name)
        _dryrun_line(rep, time.perf_counter() - t0)
    _dryrun_line(dryrun.lda_report("train_4k", 256, "lda-256"), 0.0)


def _dryrun_line(rep: dict, seconds: float) -> None:
    if "error" in rep:
        print(rep["trace"], file=sys.stderr)
        raise SystemExit(f"dry-run {rep['arch']} {rep['shape']} "
                         f"{rep['mesh']}: {rep['error']}")
    print(json.dumps({"dryrun": {
        k: rep[k] for k in ("arch", "shape", "mesh", "chips",
                            "flops_per_device", "bytes_per_device",
                            "roofline_seconds", "bottleneck", "fits",
                            "memory", "trace_seconds")} | {
        "collective_bytes": rep["collective_bytes_per_device"]["total"],
        "seconds": seconds}}))


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
    init_counts = tuple(c.astype(np.int32)
                        for c in model.global_counts(arrays)[1:])

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    # the ragged run's checkpoint slots, removed at the end
    rotation = tempfile.TemporaryDirectory(prefix="chip-smoke-chain-")
    t0 = _phase_done("set-up", start)
    stream = _stream_phase(arrays, lay, r)
    ragged = _ragged_check("fused_sweep_ragged", lay, arrays,
                           np.zeros(W, np.int64), ROUND_TILES,
                           model.beta_bar, gen)
    step_us = {T: _step_us(f"T={T}", lay, arrays, model.beta_bar, gen, gpu)}
    t0 = _phase_done("kernel checks", t0)
    arrays, ragged["launches"], ragged_states, writes = _train_phase(
        corpus, model, arrays, gpu, rotation.name)
    snapshot = model.export_phi_snapshot(arrays, sweep=DENSE_SWEEPS + 1)
    counts = tuple(c.astype(np.int32)
                   for c in model.global_counts(arrays)[1:])
    batched = _batched_phase(lay, arrays, model.beta_bar, gen)
    t0 = _phase_done("ragged run and batched kernels", t0)
    del arrays
    torch.cuda.empty_cache()
    vec, vec_states, vec_model, a0 = _vec_train("ragged, vectorized", lay,
                                                gpu, profile=True)
    rows = batched["lda_scores"]
    pass_form = _pass_check(vec_model, a0, gen)
    # The path launches the pass form; the rows form's measured numbers
    # ride along (its bound is on its own line above).
    batched["lda_scores"] = dict(
        pass_form, launches=vec, err=max(rows["err"], pass_form["err"]),
        extra={"rows_form_tokens": ROWS_TOKENS, "rows_form_ms": rows["ms"],
               "rows_form_plain_ms": rows["plain_ms"]})
    del a0, model, vec_model
    torch.cuda.empty_cache()
    stream["launches"] = _serial_phase(corpus)
    t0 = _phase_done("ragged vectorized run and serial sweep", t0)

    forms = {"fused_sweep_cells": _dense_phase(corpus, ragged_states,
                                               snapshot.phi, vec_states,
                                               gpu, gen)}
    want = ragged_states[DENSE_SWEEPS - 1]   # the chain at the lost slot
    trained = {k: v.cpu() for k, v in ragged_states[-1].items()}   # (h)
    del ragged_states, vec_states
    torch.cuda.empty_cache()
    t0 = _phase_done("(a) dense grid", t0)
    grouped, grouped_lay, first = _grouped_phases(corpus, gpu, gen)
    forms.update(grouped)
    torch.cuda.empty_cache()
    t0 = _phase_done("(b), (c) grouped", t0)
    notes = {"store": _store_phase(corpus, grouped_lay, first, cdf, gpu)}
    del grouped_lay, first
    torch.cuda.empty_cache()
    t0 = _phase_done("(e) store", t0)
    t4 = _t4_phase(corpus, gpu, gen, r)
    step_us[T4] = t4.pop("step_us")
    torch.cuda.empty_cache()
    t0 = _phase_done(f"(d) T={T4}", t0)
    _cross_check_phase(r, cdf)
    t0 = _phase_done("small cross-check", t0)

    phi = torch.tensor(snapshot.phi, device=DEV)
    fold = _fold_in_phase(phi, cdf, r)
    fold["launches"], idle = _serving_phase(snapshot, phi, cdf, r, gpu)
    r_long = np.random.default_rng(LONG_SEED)         # leaves r as it was
    long_fold = _long_fold_in(phi, cdf, r_long)
    long_fold.update(_long_serving(snapshot, cdf, r_long, gpu))
    fold["max_abs_err"] = max(fold["max_abs_err"], long_fold.pop("err"))
    del phi
    t0 = _phase_done("serving", t0)
    notes["heldout"] = _heldout_phase(counts, init_counts, cdf, gpu)
    del counts, init_counts
    t0 = _phase_done("(f) held-out perplexity", t0)
    resumed, arrays = _resume_phase(lay, rotation.name, want, writes, gpu)
    first = resumed.export_phi_snapshot(arrays)
    del arrays
    torch.cuda.empty_cache()
    _publish_phase(lay, rotation.name, first, want, idle, cdf, r, gpu)
    rotation.cleanup()
    t0 = _phase_done("lifecycle", t0)
    notes["twins"] = _twins_phase(gpu)
    t0 = _phase_done("(g) twins", t0)
    notes["baselines"] = _baselines_phase(lay, trained, gpu)
    del trained, lay
    torch.cuda.empty_cache()
    t0 = _phase_done("(h) baselines", t0)
    _zero_counts()
    zoo_serve_check.run(DEV, gpu=gpu)    # raises on a failed check
    notes["zoo"] = _all_launches()
    t0 = _phase_done("(i) model zoo", t0)
    gc.collect()                         # what (i) left on the card
    torch.cuda.empty_cache()
    _zero_counts()
    trained_zoo = zoo_train_check.run(DEV, gpu=gpu)   # raises on a fail
    notes["zoo_train"] = _all_launches()
    t0 = _phase_done("(j) zoo training", t0)
    gc.collect()
    torch.cuda.empty_cache()
    _zero_counts()
    _dryrun_phase(gpu, trained_zoo["granite"])
    notes["dryrun"] = _all_launches()
    t0 = _phase_done("(k) dry-run and roofline", t0)
    del trained_zoo
    gc.collect()
    torch.cuda.empty_cache()
    large = _large_t_phase(corpus, cdf, gpu, gen, r)
    _phase_done("(l) large T", t0)
    print(f"whole script: {time.perf_counter() - start:.1f} s")
    forms.update(fused_sweep=stream, fused_sweep_ragged=ragged)
    for name, res in t4.items():      # the same forms at T4, measured
        forms[name]["err"] = max(forms[name]["err"], res["err"])
        forms[name]["extra"] = {f"t{T4}_ms": res["ms"],
                                f"t{T4}_plain_ms": res["plain_ms"]}
    for T_l, res_t in large["forms"].items():     # and at large T
        for name, res in res_t.items():
            forms[name]["err"] = max(forms[name]["err"], res["err"])
            forms[name]["extra"].update({
                f"t{T_l}_ms": res["ms"], f"t{T_l}_plain_ms": res["plain_ms"],
                f"t{T_l}_placement": res.get("placement", {}).get("dense")})
            if "launches" in res:
                forms[name]["extra"][f"t{T_l}_launches"] = res["launches"]
    fold["extra"] = {f"t{T_f}_{k}": v for T_f, res in
                     large["fold_in"].items() for k, v in res.items()}
    fold["extra"].update({f"long_{k}": v for k, v in long_fold.items()})
    print(json.dumps({"heaviest_cta_us_a_step": step_us, "gpu": gpu}))
    kernels = [dict(fold, **fold.pop("extra"))]
    kernels += [_sweep_entry(name, f"{PALLAS}:{line}", forms[name])
                for name, line in REPLACES.items()]
    kernels += [_batched_entry(
        name, f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
        f"src/repro/kernels/{name}/{name}.py:{line}", batched[name])
        for name, line in (("ftree_sample", 41), ("ftree_update", 35),
                           ("lda_scores", 43))]
    by_t = {name: large[name] for name in ("lda_scores", "ftree_update")}
    for entry in kernels:         # lda_scores and ftree_update at large T
        for T_k, res in by_t.get(entry["name"], {}).items():
            entry.update({f"t{T_k}_{key}": res[key] for key in (
                "ms", "plain_ms", "launches", "bound_ms", "placement")
                if key in res})
    for entry in kernels:         # the launches of this slice's paths
        entry["new_path_launches"] = {
            path: sum(v for k, v in got.items()
                      if k.removesuffix("_pass") == entry["name"])
            for path, got in notes.items()}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
