"""Data partition and subtask split for Nomad LDA (paper §4.1, Fig. 2b): the
port's own copy of ``repro/data/sharding.py`` (numpy only), byte for byte
the same layouts.

The corpus grid: documents are partitioned into ``W`` worker shards (block
rows of Fig. 2b) and the vocabulary into ``B`` word blocks (the nomadic
tokens).  Cell ``(w, b)`` holds every occurrence of a block-``b`` word inside
a worker-``w`` document, sorted by word id — the "unit subtask" t_j of the
paper, batched per block.

Load balance (DESIGN.md §3): the paper relies on asynchrony to absorb the
power-law skew of word frequencies; on a lock-step TPU mesh we instead
balance statically — greedy LPT bin-packing of documents by length and of
words by corpus frequency — and measure the residual imbalance.

Two token geometries (``layout=``, DESIGN.md §4/§7), both plain numpy
arrays (the port moves them to the card as tensors of the same shapes):

``"dense"`` — the padded cell grid: every cell padded to the globally
heaviest cell length ``L``:

    tok_doc   (W, B, L) int32   local doc index (within worker shard)
    tok_wrd   (W, B, L) int32   local word index (within block)
    tok_gwrd  (W, B, L) int32   global word id (diagnostics)
    tok_valid (W, B, L) bool    padding mask
    tok_bound (W, B, L) bool    first occurrence of a word within the cell

``"ragged"`` — the CSR-style tile stream: per (worker, ring chunk) the
chunk's ``k`` cells are concatenated into ONE stream of ``tile``-token
tiles, each cell padded only up to its next tile multiple (and each
pipelined half-queue padded to its own global tile max, so the half split
is a *static tile split*).  Same five ``tok_*`` arrays with shape
``(W, W, S)`` — axis 1 is the ring *chunk* id, ``S = n_tiles·tile`` — plus

    cell_of_tile (W, W, n_tiles) int32  queue-local cell (0..k-1) per tile
    tok_slot     (W, W, S)       int32  slot of the token within its cell

Both layouts order valid tokens identically (by worker, block, word id) —
the *canonical* token order, recorded in ``canon_idx`` — so the per-token
Gibbs chain is bit-identical across layouts (the nomad sweep derives its
uniforms and initial ``z`` from canonical coordinates, ``core/nomad.py``).

``doc_tile`` (DESIGN.md §7) additionally partitions each worker's local
document rows into groups of ``doc_tile`` consecutive rows and refines the
canonical order to (worker, block, **doc group**, word id): every aligned
token tile then touches exactly one ``(doc_tile, T)`` slab of the
doc-topic table, which is what lets the fused kernels page the slab
through VMEM instead of holding the whole ``(I_max, T)`` shard resident.
The grouped order is itself a canonical order — dense, ragged, tiled and
untiled execution over the *same* layout all run the bit-identical chain —
but it differs from the ``doc_tile=None`` order, so ``doc_tile`` is a
layout-build-time choice, not a runtime switch.  ``doc_tile_of`` maps each
token tile (dense: ``doc_blk`` tokens, ragged: ``tile`` tokens) to its doc
group; ``tok_slot`` (emitted for dense layouts too when grouping) keeps
the per-token RNG ids position-independent exactly like the ragged stream.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.data.corpus import Corpus

__all__ = ["NomadLayout", "counts_from_layout", "lpt_assign",
           "build_layout", "half_queue_split", "default_ragged_tile"]


def _pow2_ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _segments_from_counts(seg_counts: np.ndarray, gran: int):
    """Doc-group segment geometry from the ``(W·B, G)`` per-(cell, group)
    token-count accumulator, with each segment padded to a multiple of
    ``gran``.

    Segments are the non-empty (cell, group) pairs in cell-major, group-
    ascending order — exactly the runs a (cell, group)-sorted token stream
    produces, but derived purely from counts so the chunked store path
    (the reference's ``repro.data.corpus_store``) can accumulate them shard by shard
    without the token arrays.  Returns ``(seg_cell, seg_g, seg_start,
    seg_pad, cell_pad, seg_start_arr)``: per-segment cell id / group id /
    start-within-cell / padded length, the per-cell padded length
    (``(W·B,)``), and a ``(W·B, G)`` start-within-cell lookup used to
    place tokens one worker at a time.
    """
    WB, G = seg_counts.shape
    seg_cell, seg_g = np.nonzero(seg_counts)           # row-major = sorted
    seg_sizes = seg_counts[seg_cell, seg_g]
    seg_pad = -(-seg_sizes // gran) * gran
    cell_change = np.ones(seg_cell.shape[0], bool)
    cell_change[1:] = seg_cell[1:] != seg_cell[:-1]
    run = np.cumsum(seg_pad) - seg_pad                 # global segment start
    base = np.maximum.accumulate(np.where(cell_change, run, 0))
    seg_start = run - base                             # start within cell
    cell_pad = np.zeros(WB, np.int64)
    np.add.at(cell_pad, seg_cell, seg_pad)
    seg_start_arr = np.zeros((WB, G), np.int64)
    seg_start_arr[seg_cell, seg_g] = seg_start
    return seg_cell, seg_g, seg_start, seg_pad, cell_pad, seg_start_arr


#: The reference's fused-kernel token tile (``fused_sweep.py:114``): the
#: dense doc-tiling grid step and the tile ``total_tiles`` counts in.
N_BLK = 256


def _dense_doc_blk() -> int:
    """Default dense doc-tiling grid step: the fused kernel's native token
    tile, so doc-group padding aligns with the grid the kernel runs."""
    return N_BLK


def _ffill_nonneg(a: np.ndarray) -> np.ndarray:
    """Forward-fill negative entries along the last axis (remaining
    leading negatives become 0) — pads ``doc_tile_of`` tiles that carry
    no tokens with the previous real group so paging never flips slabs
    for padding-only tiles."""
    neg = a < 0
    idx = np.where(neg, 0, np.arange(a.shape[-1]))
    np.maximum.accumulate(idx, axis=-1, out=idx)
    out = np.take_along_axis(a, idx, axis=-1)
    return np.where(out < 0, 0, out)


def default_ragged_tile(cell_sizes: np.ndarray) -> int:
    """Default ragged token-tile size: ~a quarter of the mean occupied
    cell load, rounded to a power of two and clamped to [8, 256].

    Per-cell padding in the ragged stream is < one tile, so a tile well
    under the typical cell keeps pad_fraction small at any ``B`` — and
    because the mean cell shrinks with ``B``, the chosen tile shrinks
    too, keeping the per-round *slot* count (the work the kernel actually
    sweeps) roughly flat in ``B`` instead of favouring small ``B``.  The
    256 ceiling matches the fused kernel's native ``N_BLK`` so
    large-scale layouts land on the TPU-friendly tile, and the floor of
    8 keeps the tile count (one grid step each) from exploding on tiny
    corpora.
    """
    occupied = cell_sizes[cell_sizes > 0]
    mean = float(occupied.mean()) if occupied.size else 1.0
    return int(min(max(_pow2_ceil(max(int(mean) // 4, 1)), 8), 256))


def half_queue_split(k: int) -> int:
    """Split point ``k0`` of a ``k``-cell queue for the pipelined ring.

    ``ring_mode="pipelined"`` (``core/nomad.py``) sweeps cells ``[0, k0)``,
    forwards their blocks immediately, then sweeps ``[k0, k)`` while that
    hop is in flight.  ``k0 = k // 2`` keeps the two half-queues
    load-matched: within a ring chunk the ``k`` blocks are themselves
    LPT-packed (:func:`build_layout`'s hierarchical split), so any
    contiguous ``k // 2`` of them carry ≈ half the chunk's tokens and the
    second half's sweep time can actually hide the first half's hop.
    ``k < 2`` returns 0 — a single-cell queue has nothing to overlap and
    the pipelined schedule degenerates to the barrier one.
    """
    return k // 2 if k >= 2 else 0


def _order_bins_for_halves(bins: np.ndarray, weights: np.ndarray,
                           kq: int, k0: int,
                           worker_loads: np.ndarray | None = None
                           ) -> np.ndarray:
    """Renumber a chunk's ``kq`` LPT bins so the pipelined half-queues
    ``[0, k0)`` and ``[k0, kq)`` are load-matched.

    LPT gives near-equal bins but arbitrary ids; under power-law skew one
    bin can hold most of a chunk's tokens, and if its id landed in the
    wrong half the pipelined ring would have nothing to overlap.  Greedy
    capacity-constrained partition (heaviest bin to the lighter half with
    room) keeps ``|half0 − half1| ≤ max bin load`` — the best any
    block-granular split can do.

    ``worker_loads`` (``(W, kq)`` per-worker bin loads) refines the choice:
    among the partitions that respect the greedy global-gap bound, pick the
    one minimizing ``max_w half0 + max_w half1`` — the quantity the ragged
    layout's stream capacity pays, since each half is padded to its
    heaviest (worker, chunk) occurrence (DESIGN.md §4).  Global halves can
    be perfectly matched while one worker's halves are badly skewed, so
    the global objective alone leaves real padding on the table.  The
    search enumerates subsets when that is cheap and keeps the greedy
    answer otherwise; the bound invariant is unchanged either way.
    Returns the remapped bin assignment.
    """
    loads = np.bincount(bins, weights=weights, minlength=kq)
    h0, h1 = [], []
    l0 = l1 = 0.0
    for b in np.argsort(-loads, kind="stable"):
        if len(h0) >= k0:
            h1.append(b); l1 += loads[b]
        elif len(h1) >= kq - k0:
            h0.append(b); l0 += loads[b]
        elif l0 <= l1:
            h0.append(b); l0 += loads[b]
        else:
            h1.append(b); l1 += loads[b]

    from math import comb
    if worker_loads is not None and 0 < k0 < kq and comb(kq, k0) <= 20000:
        from itertools import combinations
        gap_bound = max(abs(l0 - l1), float(loads.max()))
        best = (float(worker_loads[:, h0].sum(1).max()
                      + worker_loads[:, h1].sum(1).max()),
                abs(l0 - l1))
        for sub in combinations(range(kq), k0):
            s = np.array(sub)
            gap = abs(2.0 * loads[s].sum() - loads.sum())
            if gap > gap_bound:
                continue
            r = np.setdiff1d(np.arange(kq), s, assume_unique=True)
            key = (float(worker_loads[:, s].sum(1).max()
                         + worker_loads[:, r].sum(1).max()), gap)
            if key < best:
                best, h0, h1 = key, list(s), list(r)

    perm = np.empty(kq, np.int64)
    perm[np.array(h0 + h1, np.int64)] = np.arange(kq)   # old bin → new id
    return perm[bins].astype(bins.dtype)


def lpt_assign(weights: np.ndarray, n_bins: int,
               balance: bool = True) -> np.ndarray:
    """Assign items to bins. ``balance=True``: greedy LPT (largest first to
    lightest bin); else contiguous equal-count chunks (the naive split)."""
    n = weights.shape[0]
    if not balance:
        return (np.arange(n) * n_bins // max(n, 1)).astype(np.int32)
    import heapq
    order = np.argsort(-weights, kind="stable")
    out = np.zeros(n, dtype=np.int32)
    # LPT via a min-heap keyed on bin load: pop lightest, assign, push back.
    heap = [(0, b) for b in range(n_bins)]
    heapq.heapify(heap)
    for i in order:
        load, b = heapq.heappop(heap)
        out[i] = b
        heapq.heappush(heap, (load + int(weights[i]), b))
    return out


@dataclass
class NomadLayout:
    """Padded cell grid + count-table geometry for a nomad run.

    ``B`` must be a multiple of ``W``: each worker owns a queue of
    ``k = B // W`` blocks that travels the ring as one payload.  At ring
    round ``r`` (of ``W`` per sweep) worker ``w`` holds chunk
    ``c = (w + r) % W``, i.e. global blocks ``c*k .. c*k + k - 1``, and
    sweeps all ``k`` of those cells before the queue hops (DESIGN.md §4).
    ``B = W`` (``k = 1``) is the paper's minimal setup; ``B ≫ W`` is the
    paper's actual choice — finer blocks shrink the per-block vocabulary
    (the fused kernel's VMEM page) and, thanks to the hierarchical LPT in
    :func:`build_layout`, cost nothing in round balance.

    ``kind`` selects the token geometry (module docstring): ``"dense"``
    token arrays are ``(W, B, L)`` cell rows; ``"ragged"`` token arrays are
    ``(W, W, S)`` per-chunk tile streams with ``S = n_tiles·tile``,
    ``tile_split`` tiles covering the pipelined first half-queue, and the
    ``cell_of_tile``/``tok_slot`` side arrays.  ``L`` is always the true
    heaviest cell size — the dense pad length AND the canonical slot
    stride both layouts derive per-token RNG ids from.
    """
    W: int                       # workers (ring length)
    B: int                       # word blocks (multiple of W)
    L: int                       # heaviest cell (dense pad len / RNG stride)
    T: int                       # topics
    num_words: int               # true vocabulary size J (for β̄)
    tok_doc: np.ndarray          # (W,B,L)|(W,W,S) int32 local doc index
    tok_wrd: np.ndarray          # (W,B,L)|(W,W,S) int32 local word in block
    tok_gwrd: np.ndarray         # (W,B,L)|(W,W,S) int32 global word id
    tok_valid: np.ndarray        # (W,B,L)|(W,W,S) bool
    tok_bound: np.ndarray        # (W,B,L)|(W,W,S) bool
    doc_of_worker: np.ndarray    # (W, I_max) int32 global doc id (-1 pad)
    word_of_block: np.ndarray    # (B, J_max) int32 global word id (-1 pad)
    I_max: int                   # padded docs per worker
    J_max: int                   # padded words per block
    doc_assign: np.ndarray       # (I,) worker of each document
    word_assign: np.ndarray      # (J,) block of each word
    cell_sizes: np.ndarray       # (W,B) true token counts (imbalance stats)
    canon_idx: np.ndarray        # (N,) int64 flat tok_* position of each
                                 #   token in canonical (w, block, word) order
    kind: str = "dense"          # token geometry: "dense" | "ragged"
    tile: int = 0                # ragged: tokens per tile
    n_tiles: int = 0             # ragged: tiles per (worker, chunk) stream
    tile_split: int = 0          # ragged: first-half tiles (pipelined split)
    cell_of_tile: np.ndarray | None = None   # ragged (W,W,n_tiles) int32
    tok_slot: np.ndarray | None = None       # ragged (W,W,S) int32;
                                 #   dense too when doc_tile grouping is on
    r_cap: int = 0               # sparse r-bucket capacity: the per-shard
                                 #   T_d_max bound min(T, max doc length)
                                 #   (0 = unknown, callers fall back to T)
    doc_tile: int = 0            # doc rows per slab (0 = ungrouped)
    n_doc_tiles: int = 1         # slabs per worker shard (ceil(I_max/doc_tile))
    doc_blk: int = 0             # dense: tokens per doc-tile-aligned grid step
    doc_tile_of: np.ndarray | None = None
                                 #   dense (W,B,Lrow//doc_blk) int32 /
                                 #   ragged (W,W,n_tiles) int32: tile → slab

    @property
    def k(self) -> int:
        """Blocks per worker queue (``B // W``)."""
        return self.B // self.W

    @property
    def stream_len(self) -> int:
        """Ragged: tokens per (worker, chunk) stream (``n_tiles·tile``)."""
        return self.n_tiles * self.tile

    @property
    def pad_fraction(self) -> float:
        """Padding overhead of this layout's actual token capacity: the
        dense grid's ``W·B·Lrow`` slots (``Lrow ≥ L`` once doc-tile
        grouping pads group segments), or the ragged streams' ``W·W·S``."""
        return 1.0 - self.cell_sizes.sum() / self.tok_doc.size

    @property
    def total_tiles(self) -> int:
        """Token tiles one full sweep runs through the fused kernel: the
        ragged streams' tile count, or the dense grid's row length padded
        to the kernel's grid step (``doc_blk`` when doc-tile grouping
        fixes it, the kernel's native ``N_BLK`` otherwise — the dense
        kernel tiles at call time)."""
        if self.kind == "ragged":
            return self.W * self.W * self.n_tiles
        if self.doc_blk > 0:
            return self.W * self.B * (self.tok_doc.shape[-1] // self.doc_blk)
        return self.W * self.B * -(-self.L // N_BLK)

    @property
    def ntd_row_bytes(self) -> int:
        """Bytes of one int32 doc-topic row — the unit the ``doc_tile``
        VMEM budget scales with."""
        return 4 * self.T

    @property
    def ntd_whole_bytes(self) -> int:
        """Doc-topic bytes of whole-shard residency: the ``(I_max, T)``
        table in VMEM twice (input + output buffers, DESIGN.md §7)."""
        return 2 * self.I_max * self.ntd_row_bytes

    @property
    def ntd_slab_bytes(self) -> int:
        """Doc-topic bytes the fused kernels keep VMEM-resident per
        worker: one ``(doc_tile, T)`` slab when grouping is on, else
        :attr:`ntd_whole_bytes`."""
        if self.doc_tile > 0:
            return self.doc_tile * self.ntd_row_bytes
        return self.ntd_whole_bytes

    # -- canonical token order ------------------------------------------------
    def extract_canonical(self, a: np.ndarray) -> np.ndarray:
        """Values of a token-geometry array at the valid tokens, in
        canonical (worker, block, word, occurrence) order — identical
        across layouts, the basis of every cross-layout comparison."""
        return np.asarray(a).reshape(-1)[self.canon_idx]

    def place_canonical(self, vals: np.ndarray, fill=0) -> np.ndarray:
        """Scatter canonical-order per-token values into this layout's
        token geometry (padding slots get ``fill``)."""
        out = np.full(self.tok_doc.shape, fill, np.asarray(vals).dtype)
        out.reshape(-1)[self.canon_idx] = vals
        return out

    def token_coords(self):
        """Canonical-order (worker, block, local_doc, local_word) of every
        token, derived purely from the layout arrays."""
        flat = lambda a: self.extract_canonical(a)
        if self.kind == "ragged":
            S = self.stream_len
            w = self.canon_idx // (self.W * S)
            c = (self.canon_idx // S) % self.W
            cell = np.repeat(self.cell_of_tile, self.tile,
                             axis=2).reshape(-1)[self.canon_idx]
            b = c * self.k + cell
        else:
            Lrow = self.tok_doc.shape[-1]      # ≥ L under doc-tile grouping
            w = self.canon_idx // (self.B * Lrow)
            b = (self.canon_idx // Lrow) % self.B
        return w, b, flat(self.tok_doc), flat(self.tok_wrd)

    def token_globals(self):
        """Canonical-order (global doc id, global word id) per token."""
        w, b, d, j = self.token_coords()
        return self.doc_of_worker[w, d], self.word_of_block[b, j]

    def word_map_mismatches(self) -> int:
        """Tokens whose stored global word id disagrees with the
        block/local maps — the layout self-consistency diagnostic."""
        _, gwrd = self.token_globals()
        return int((gwrd != self.extract_canonical(self.tok_gwrd)).sum())

    @property
    def round_imbalance(self) -> float:
        """max/mean token count over the per-worker queue loads in a ring
        round, worst round — the 'last reducer' exposure of the static
        schedule.  A round's load on worker ``w`` is the sum over its
        ``k``-cell queue, so larger ``B`` (smaller blocks, more of them)
        averages the power-law word skew down within each round."""
        W, k = self.W, self.k
        worst = 0.0
        for r in range(W):
            chunk = (np.arange(W) + r) % W
            active = np.array([
                self.cell_sizes[w, chunk[w] * k:(chunk[w] + 1) * k].sum()
                for w in range(W)])
            if active.mean() > 0:
                worst = max(worst, active.max() / active.mean())
        return float(worst)

    def half_balance_gaps(self) -> np.ndarray:
        """(W, 2) per ring chunk: the global-load gap between the two
        pipelined half-queues, and the chunk's heaviest block load — the
        bound :func:`_order_bins_for_halves` guarantees (``gap ≤ max``).
        The single statement of the half-balance invariant the tests
        assert."""
        k = self.k
        k0 = half_queue_split(k)
        block_loads = self.cell_sizes.sum(axis=0)           # (B,)
        out = np.zeros((self.W, 2), np.int64)
        for c in range(self.W):
            q = block_loads[c * k:(c + 1) * k]
            out[c] = (abs(int(q[:k0].sum()) - int(q[k0:].sum())),
                      int(q.max()))
        return out

    def half_loads(self) -> np.ndarray:
        """(W_rounds, W, 2) token loads of the two pipelined half-queues.

        Entry ``[r, w]`` is ``(first-half, second-half)`` token counts of
        the queue worker ``w`` sweeps in ring round ``r`` when split at
        :func:`half_queue_split`.  With ``k < 2`` the first column is all
        zero (degenerate split)."""
        W, k = self.W, self.k
        k0 = half_queue_split(k)
        out = np.zeros((W, W, 2), np.int64)
        for r in range(W):
            for w in range(W):
                c = (w + r) % W
                q = self.cell_sizes[w, c * k:(c + 1) * k]
                out[r, w] = (q[:k0].sum(), q[k0:].sum())
        return out


def counts_from_layout(lay: NomadLayout, z: np.ndarray, T: int):
    """Rebuild compact global ``(n_td, n_wt, n_t)`` from the assignment
    array ``z`` in the layout's token geometry (dense grid or ragged
    streams) — the single oracle every distributed exactness check
    compares ``NomadLDA.global_counts`` against.

    (Distinct from :func:`repro_torch.core.cgs.counts_from_assignments`, which
    rebuilds from the flat serial corpus arrays.)"""
    zz = lay.extract_canonical(z)
    gdoc, gwrd = lay.token_globals()
    I = lay.doc_assign.shape[0]        # full doc-id space: retired docs
    n_td = np.zeros((I, T), np.int64)  # keep zero rows (corpus_store)
    n_wt = np.zeros((lay.num_words, T), np.int64)
    np.add.at(n_td, (gdoc, zz), 1)
    np.add.at(n_wt, (gwrd, zz), 1)
    return n_td, n_wt, np.bincount(zz, minlength=T).astype(np.int64)


def _validate_build_args(W: int, B: int, layout: str,
                         doc_tile: int | None, doc_blk: int | None) -> None:
    """Shared argument validation for the monolithic and chunked layout
    builds."""
    if layout not in ("dense", "ragged"):
        raise ValueError(f"unknown layout {layout!r} (dense|ragged)")
    if doc_tile is not None and int(doc_tile) < 1:
        raise ValueError(f"doc_tile must be >= 1, got {doc_tile}")
    if doc_blk is not None and doc_tile is None:
        raise ValueError("doc_blk only applies with doc_tile grouping")
    if doc_blk is not None and layout == "ragged":
        raise ValueError(
            "ragged doc grouping is tiled at the stream's own `tile` "
            "granularity; doc_blk only applies to layout='dense'")
    if B % W != 0 or B < W:
        raise ValueError(
            f"n_blocks must be a positive multiple of n_workers so each "
            f"worker's block queue has equal length; got n_blocks={B}, "
            f"n_workers={W}")


def _plan_partition(doc_lengths: np.ndarray, freqs: np.ndarray, *,
                    W: int, B: int, balance: bool, freq_w):
    """Assign docs → workers and words → blocks from the marginal stats.

    Hierarchical word packing: LPT into W ring chunks first (so per-round
    queue loads are exactly as balanced as the B = W packing — flat LPT
    into B small bins lets single heavy words dominate a bin and would
    *worsen* round balance), then LPT each chunk into k = B/W blocks.
    Block b of chunk c gets global id c*k + b, matching the queue layout.

    ``freq_w`` is a callable ``doc_assign -> (W, J)`` per-worker word
    frequency table, invoked only when the pipelined half ordering needs
    it — the chunked store path streams it shard by shard instead of
    indexing the full token arrays.
    """
    doc_assign = lpt_assign(doc_lengths, W, balance)
    chunk_assign = lpt_assign(freqs, W, balance)
    if B == W:
        return doc_assign, chunk_assign
    kq = B // W
    k0 = half_queue_split(kq)
    # per-worker word frequencies: the half ordering balances not just
    # the chunk's global halves but each worker's (identically for
    # both layouts — the ragged streams pad each half to its heaviest
    # per-worker occurrence)
    fw = freq_w(doc_assign) if (balance and k0 > 0) else None
    word_assign = np.zeros_like(chunk_assign)
    for c in range(W):
        ids = np.nonzero(chunk_assign == c)[0]
        bins = lpt_assign(freqs[ids], kq, balance)
        if balance and k0 > 0:
            # order blocks within the chunk so the pipelined ring's
            # half-queues [0, k0) / [k0, kq) are load-matched
            wl = np.stack([np.bincount(bins, weights=fw[w, ids],
                                       minlength=kq) for w in range(W)])
            bins = _order_bins_for_halves(bins, freqs[ids], kq, k0, wl)
        word_assign[ids] = c * kq + bins
    return doc_assign, word_assign


def _local_maps(doc_assign: np.ndarray, word_assign: np.ndarray,
                W: int, B: int):
    """Local doc / word index maps from the assignment vectors."""
    I_counts = np.bincount(doc_assign, minlength=W)
    J_counts = np.bincount(word_assign, minlength=B)
    I_max, J_max = int(I_counts.max()), int(J_counts.max())
    doc_of_worker = np.full((W, I_max), -1, np.int32)
    doc_local = np.zeros(doc_assign.shape[0], np.int32)
    for w in range(W):
        ids = np.nonzero(doc_assign == w)[0]
        doc_of_worker[w, :len(ids)] = ids
        doc_local[ids] = np.arange(len(ids))
    word_of_block = np.full((B, J_max), -1, np.int32)
    word_local = np.zeros(word_assign.shape[0], np.int32)
    for b in range(B):
        ids = np.nonzero(word_assign == b)[0]
        word_of_block[b, :len(ids)] = ids
        word_local[ids] = np.arange(len(ids))
    return (doc_of_worker, doc_local, word_of_block, word_local,
            I_max, J_max)


@dataclass
class _Geom:
    """Token-geometry constants derived purely from count accumulators
    (``cell_sizes`` and, under doc grouping, the per-(cell, group) segment
    counts) — everything :class:`_LayoutAssembler` needs to place one
    worker's tokens without seeing any other worker's."""
    layout: str
    W: int
    B: int
    L: int                       # heaviest cell (RNG stride)
    dt: int                      # doc_tile (0 = ungrouped)
    gran: int                    # segment grid step (doc_blk / tile)
    n_doc_tiles: int
    shape: tuple
    seg_start_arr: np.ndarray | None   # (W·B, G) segment start within cell
    L_row: int = 0               # dense row length (≥ L under grouping)
    tile: int = 0                # ragged tokens per tile
    R0: int = 0                  # ragged first-half tiles
    R: int = 0                   # ragged tiles per stream
    S: int = 0                   # ragged stream length (R·tile)
    off: np.ndarray | None = None          # ragged (W, W, k) cell → tile
    cell_of_tile: np.ndarray | None = None
    dto: np.ndarray | None = None          # doc_tile_of map


def _build_geometry(cell_sizes: np.ndarray, seg_counts: np.ndarray | None,
                    *, layout: str, W: int, B: int, dt: int, gran: int,
                    n_doc_tiles: int, tile: int) -> _Geom:
    """Global token geometry from the count accumulators alone."""
    L = max(int(cell_sizes.max()), 1)
    if layout == "dense":
        if dt:
            seg_cell, seg_g, seg_start, seg_pad, cp, seg_start_arr = \
                _segments_from_counts(seg_counts, gran)
            L_row = max(int(cp.max()), gran)
            dto = np.full((W, B, L_row // gran), -1, np.int32)
            for s in range(seg_cell.shape[0]):
                w_, b_ = divmod(int(seg_cell[s]), B)
                t0 = int(seg_start[s]) // gran
                dto[w_, b_, t0:t0 + int(seg_pad[s]) // gran] = seg_g[s]
            return _Geom(layout, W, B, L, dt, gran, n_doc_tiles,
                         (W, B, L_row), seg_start_arr, L_row=L_row,
                         dto=_ffill_nonneg(dto))
        return _Geom(layout, W, B, L, 0, 0, 1, (W, B, L), None, L_row=L)
    k = B // W
    k0 = half_queue_split(k)
    # Tiles per cell (empty cells keep one tile so every block is paged
    # through the kernel exactly once per round), grouped (W, chunk, k).
    if dt:
        seg_cell, seg_g, seg_start, seg_pad, cp, seg_start_arr = \
            _segments_from_counts(seg_counts, gran)
        tiles_cell = np.maximum(1, cp // tile).reshape(W, W, k)
    else:
        seg_start_arr = None
        tiles_cell = np.maximum(1, -(-cell_sizes // tile)).reshape(W, W, k)
    half0 = tiles_cell[:, :, :k0].sum(axis=2)          # (W, W) tiles
    half1 = tiles_cell[:, :, k0:].sum(axis=2)
    # Each pipelined half-queue is padded to its own global tile max so
    # the half split is one static tile index for every (w, chunk).
    R0 = int(half0.max()) if k0 > 0 else 0
    R1 = int(half1.max())
    R = R0 + R1
    S = R * tile
    # tile offset of cell j within its (w, chunk) stream
    start = np.cumsum(tiles_cell, axis=2) - tiles_cell
    off = np.where(np.arange(k)[None, None, :] < k0,
                   start, R0 + start - half0[:, :, None])
    cell_of_tile = np.zeros((W, W, R), np.int32)
    if k0 > 0:                     # half-padding tiles: last cell of the
        cell_of_tile[:, :, :R0] = k0 - 1      # half (keeps the tile→cell
    cell_of_tile[:, :, R0:] = k - 1           # map non-decreasing)
    for w in range(W):
        for c in range(W):
            for j in range(k):
                o, n = int(off[w, c, j]), int(tiles_cell[w, c, j])
                cell_of_tile[w, c, o:o + n] = j
    geom = _Geom("ragged", W, B, L, dt, gran, n_doc_tiles, (W, W, S),
                 seg_start_arr, tile=tile, R0=R0, R=R, S=S, off=off,
                 cell_of_tile=cell_of_tile)
    if dt:
        dto = np.full((W, W, R), -1, np.int32)
        for s in range(seg_cell.shape[0]):
            w_, b_ = divmod(int(seg_cell[s]), B)
            c_, j_ = divmod(b_, k)
            t0 = int(off[w_, c_, j_]) + int(seg_start[s]) // tile
            dto[w_, c_, t0:t0 + int(seg_pad[s]) // tile] = seg_g[s]
        geom.dto = _ffill_nonneg(dto)
    return geom


class _LayoutAssembler:
    """Fills the token-geometry arrays one worker at a time.

    Canonical order is worker-major, so feeding workers in ascending
    order with each worker's tokens already sorted by (block[, doc
    group], word id) — ties in original corpus order — reproduces the
    global lexsorted order exactly.  Both :func:`build_layout` (which
    sorts the whole corpus at once) and the chunked store path (which
    sorts one worker's shard-streamed tokens at a time) feed this same
    assembler, which is what makes their outputs byte-identical by
    construction.

    ``slot`` may be supplied per worker to *preserve* historical slot
    indices (the incremental add/retire path, where surviving tokens must
    keep their RNG uids); by default it is the within-cell running count,
    the initial-build rule.
    """

    def __init__(self, geom: _Geom, n_tokens: int):
        g = self.geom = geom
        self.tok_doc = np.zeros(g.shape, np.int32)
        self.tok_wrd = np.zeros(g.shape, np.int32)
        self.tok_gwrd = np.zeros(g.shape, np.int32)
        self.tok_valid = np.zeros(g.shape, bool)
        self.tok_bound = np.zeros(g.shape, bool)
        need_slot = g.layout == "ragged" or g.dt > 0
        self.tok_slot = np.zeros(g.shape, np.int32) if need_slot else None
        self.canon_idx = np.zeros(n_tokens, np.int64)
        self._n0 = 0
        self._last_w = -1

    def add_worker(self, w: int, sb: np.ndarray, dloc: np.ndarray,
                   wloc: np.ndarray, gwrd: np.ndarray,
                   sg: np.ndarray | None = None,
                   slot: np.ndarray | None = None) -> None:
        """Place worker ``w``'s tokens (sorted by (block[, group], word))."""
        if w <= self._last_w:
            raise ValueError("workers must be added in ascending order")
        self._last_w = w
        g = self.geom
        n = sb.shape[0]
        flat_cell = w * np.int64(g.B) + sb.astype(np.int64)
        if slot is None:
            # slot index of each token within its cell (canonical order is
            # the lexsorted order itself: worker, block, word, occurrence)
            slot = _running_count(flat_cell)
        # word boundary within cell: first slot, or word differs from
        # previous (the first token of a cell always bounds — its
        # predecessor in the global order is another worker's cell)
        prev_same_cell = np.zeros(n, bool)
        prev_same_cell[1:] = flat_cell[1:] == flat_cell[:-1]
        prev_same_word = np.zeros(n, bool)
        prev_same_word[1:] = gwrd[1:] == gwrd[:-1]
        bound = ~(prev_same_cell & prev_same_word)
        if g.dt:
            seg_key = flat_cell * np.int64(g.n_doc_tiles) + sg
            pos_c = (g.seg_start_arr[flat_cell, sg]
                     + _running_count(seg_key))
        if g.layout == "dense":
            pos = pos_c if g.dt else slot
            canon = flat_cell * g.L_row + pos
        else:
            k = g.B // g.W
            sc, sj = sb // k, sb % k
            pos = g.off[w, sc, sj] * g.tile + (pos_c if g.dt else slot)
            canon = (np.int64(w) * g.W + sc.astype(np.int64)) * g.S + pos
        for arr, vals in ((self.tok_doc, dloc), (self.tok_wrd, wloc),
                          (self.tok_gwrd, gwrd), (self.tok_valid, True),
                          (self.tok_bound, bound), (self.tok_slot, slot)):
            if arr is not None:
                arr.reshape(-1)[canon] = vals
        self.canon_idx[self._n0:self._n0 + n] = canon
        self._n0 += n

    def finish(self, *, T: int, num_words: int, doc_of_worker, word_of_block,
               I_max: int, J_max: int, doc_assign, word_assign, cell_sizes,
               r_cap: int) -> NomadLayout:
        if self._n0 != self.canon_idx.shape[0]:
            raise ValueError(
                f"assembled {self._n0} tokens but the layout was sized for "
                f"{self.canon_idx.shape[0]}")
        g = self.geom
        extra = {}
        if g.layout == "dense":
            if g.dt:
                extra = dict(doc_tile=g.dt, n_doc_tiles=g.n_doc_tiles,
                             doc_blk=g.gran, doc_tile_of=g.dto,
                             tok_slot=self.tok_slot)
        else:
            extra = dict(kind="ragged", tile=g.tile, n_tiles=g.R,
                         tile_split=g.R0, cell_of_tile=g.cell_of_tile,
                         tok_slot=self.tok_slot)
            if g.dt:
                extra.update(doc_tile=g.dt, n_doc_tiles=g.n_doc_tiles,
                             doc_blk=g.gran, doc_tile_of=g.dto)
        return NomadLayout(
            W=g.W, B=g.B, L=g.L, T=T, num_words=num_words,
            tok_doc=self.tok_doc, tok_wrd=self.tok_wrd,
            tok_gwrd=self.tok_gwrd, tok_valid=self.tok_valid,
            tok_bound=self.tok_bound,
            doc_of_worker=doc_of_worker, word_of_block=word_of_block,
            I_max=I_max, J_max=J_max,
            doc_assign=doc_assign, word_assign=word_assign,
            cell_sizes=cell_sizes, canon_idx=self.canon_idx,
            r_cap=r_cap, **extra)


def _resolve_gran(layout: str, dt: int, doc_blk: int | None,
                  tile: int | None, cell_sizes: np.ndarray) -> tuple:
    """Resolve the (segment grid step, ragged tile) pair for a build."""
    if layout == "ragged":
        tile = (default_ragged_tile(cell_sizes) if tile is None
                else int(tile))
        if tile < 1:
            raise ValueError(f"ragged tile must be >= 1, got {tile}")
        return tile, tile
    if dt:
        gran = int(doc_blk) if doc_blk is not None else _dense_doc_blk()
        if gran < 1:
            raise ValueError(f"doc_blk must be >= 1, got {gran}")
        return gran, 0
    return 0, 0


def build_layout(corpus: Corpus, *, n_workers: int, T: int,
                 n_blocks: int | None = None,
                 balance: bool = True, seed: int = 0,
                 layout: str = "dense",
                 tile: int | None = None,
                 doc_tile: int | None = None,
                 doc_blk: int | None = None) -> NomadLayout:
    """Partition ``corpus`` into the nomad cell grid.

    ``layout="dense"`` pads every cell to the heaviest cell's length;
    ``layout="ragged"`` builds per-(worker, chunk) tile streams with
    per-cell padding only up to the next ``tile`` multiple (default
    :func:`default_ragged_tile`).  Word/doc assignment, cell membership
    and the canonical token order are identical in both layouts.

    ``doc_tile`` groups each worker's local doc rows into slabs of that
    many consecutive rows and refines the canonical order to (worker,
    block, doc group, word): within every cell the doc-group segments are
    laid out back to back, each padded to the layout's grid step
    (``doc_blk`` tokens for dense — default the fused kernel's ``N_BLK`` —
    and ``tile`` for ragged), so every aligned token tile touches exactly
    one ``(doc_tile, T)`` doc-topic slab, recorded in ``doc_tile_of``.
    ``doc_tile=None`` (default) keeps the ungrouped order bit-for-bit.

    The reference's ``repro.data.corpus_store.build_layout_from_store``
    builds the identical layout from an out-of-core shard store through the
    same :class:`_LayoutAssembler`; the store is not ported yet.
    """
    B = n_workers if n_blocks is None else n_blocks
    W = n_workers
    _validate_build_args(W, B, layout, doc_tile, doc_blk)

    def freq_w(doc_assign):
        fw = np.zeros((W, corpus.num_words), np.int64)
        np.add.at(fw, (doc_assign[corpus.doc_ids], corpus.word_ids), 1)
        return fw

    doc_assign, word_assign = _plan_partition(
        corpus.doc_lengths(), corpus.word_freqs(), W=W, B=B,
        balance=balance, freq_w=freq_w)
    (doc_of_worker, doc_local, word_of_block, word_local,
     I_max, J_max) = _local_maps(doc_assign, word_assign, W, B)

    # Cell grid: sort tokens by (worker, block[, doc group], word id).
    tw = doc_assign[corpus.doc_ids]
    tb = word_assign[corpus.word_ids]
    if doc_tile is not None:
        dt = int(doc_tile)
        n_doc_tiles = max(-(-I_max // dt), 1)
        g_tok = (doc_local[corpus.doc_ids] // dt).astype(np.int64)
        order = np.lexsort((corpus.word_ids, g_tok, tb, tw)).astype(np.int64)
        sg = g_tok[order]
    else:
        dt, n_doc_tiles, sg = 0, 1, None
        order = np.lexsort((corpus.word_ids, tb, tw)).astype(np.int64)
    sw, sb = tw[order], tb[order]
    sdoc, swrd = corpus.doc_ids[order], corpus.word_ids[order]

    cell_sizes = np.zeros((W, B), np.int64)
    np.add.at(cell_sizes, (sw, sb), 1)
    seg_counts = None
    if dt:
        seg_counts = np.zeros((W * B, n_doc_tiles), np.int64)
        np.add.at(seg_counts, (sw.astype(np.int64) * B + sb, sg), 1)
    gran, tile = _resolve_gran(layout, dt, doc_blk, tile, cell_sizes)

    geom = _build_geometry(cell_sizes, seg_counts, layout=layout, W=W, B=B,
                           dt=dt, gran=gran, n_doc_tiles=n_doc_tiles,
                           tile=tile)
    asm = _LayoutAssembler(geom, sw.shape[0])
    w_bounds = np.searchsorted(sw, np.arange(W + 1))
    for w in range(W):
        lo, hi = int(w_bounds[w]), int(w_bounds[w + 1])
        asm.add_worker(w, sb[lo:hi], doc_local[sdoc[lo:hi]],
                       word_local[swrd[lo:hi]], swrd[lo:hi],
                       sg[lo:hi] if dt else None)

    # Sparse r-bucket capacity (rbucket module docstring): a document of n
    # tokens holds ≤ min(T, n) distinct topics, and at increment time one
    # token is unassigned, so min(T, max doc length) slots always suffice.
    r_cap = max(1, min(T, int(corpus.doc_lengths().max(initial=1))))
    return asm.finish(
        T=T, num_words=corpus.num_words, doc_of_worker=doc_of_worker,
        word_of_block=word_of_block, I_max=I_max, J_max=J_max,
        doc_assign=doc_assign, word_assign=word_assign,
        cell_sizes=cell_sizes, r_cap=r_cap)


def _running_count(groups: np.ndarray) -> np.ndarray:
    """For a sorted group array, the 0-based occurrence index within group."""
    n = groups.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    starts = np.ones(n, bool)
    starts[1:] = groups[1:] != groups[:-1]
    idx = np.arange(n)
    start_idx = np.maximum.accumulate(np.where(starts, idx, 0))
    return idx - start_idx
