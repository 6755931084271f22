"""Out-of-core chunked corpus store with streaming and incremental layout
builds: the port's own copy of ``repro/data/corpus_store.py`` (numpy only,
on the host), byte for byte the same stores and layouts.

The paper's regime is millions of documents and billions of tokens; holding
the flat occurrence arrays (``data/corpus.py``) on the host is the ceiling
once each worker's shard is bound by device memory.  Three pieces:

**The store** (:class:`CorpusStore`): an append-only directory of token
shards, each an ``.npz`` with the shard's ``doc_ids``/``word_ids`` slice
and its per-shard document and word occurrence stats, under a
format-versioned ``meta.json``.  Shards are contiguous slices of the
corpus occurrence stream, so concatenating them in order gives back the
corpus; documents may span shards.  ``doc_lengths`` and ``word_freqs``
add up the per-shard stat arrays without reading the token arrays
(``np.load`` reads npz members lazily).  The on-disk format is the
reference's: a store written by either package opens in the other.

**Streaming build** (:func:`build_layout_from_store`): builds the
:class:`~repro_torch.data.sharding.NomadLayout` from shard streams without
holding the whole ``doc_ids``/``word_ids``.  The global geometry comes from
streamed count accumulators (document lengths, word frequencies, the
``(W, B)`` cell sizes and the per-(cell, doc-group) segment counts); the
token arrays are then filled one worker at a time.  Canonical order is
worker-major, and a stable per-worker sort of shard-streamed tokens equals
the global lexsort restricted to that worker, so
:func:`~repro_torch.data.sharding.build_layout` and this builder feed the
same ``_LayoutAssembler`` and give **byte-identical** layouts.  Peak memory
is one worker's token slice plus the output arrays.

**Incremental add and retire** (:func:`update_layout`): documents join or
leave a *live* layout, and only the touched (worker, block, doc-group)
segments are re-padded.  Invariants:

- a ``doc_tile``-grouped layout is required: new documents start at a
  fresh doc-group boundary, so their tokens sort strictly after every
  existing token of the same cell and the canonical order of untouched
  tokens is kept verbatim;
- surviving tokens keep their within-cell ``slot``, and the stride ``L``
  is frozen, so live chains keep their counter-mode RNG uids
  (``uid = global_block·L + slot``, ``core/nomad.py``);
- new tokens get slots above the cell's historical high-water mark
  (retired slots are never reused while the cell still has survivors'
  slots above them); a cell whose demand exceeds ``L`` routes its
  overflow slots past ``B·L``, into the worker's free uid region;
- retired documents leave ``-1`` holes in ``doc_of_worker``/``doc_assign``;
  consumers mask on ``>= 0`` (count tables keep zero rows).

The returned ``old_to_new`` canonical index map (``-1`` for retired
tokens) carries a live chain across the update
(:func:`remap_canonical`, :func:`carry_assignments`).
"""
from __future__ import annotations

import heapq
import json
import os

import numpy as np

from repro_torch.data import sharding
from repro_torch.data.corpus import Corpus
from repro_torch.data.sharding import NomadLayout

__all__ = ["CorpusStore", "build_layout_from_store", "update_layout",
           "remap_canonical", "carry_assignments", "STORE_FORMAT_VERSION"]

STORE_FORMAT_VERSION = 1
_META = "meta.json"
_RETIRED_WFREQ = "retired_wfreq.npy"


def _as_token_array(a, name: str) -> np.ndarray:
    """Validate + canonicalize one shard token/metadata array to int32."""
    a = np.asarray(a)
    if a.ndim != 1:
        raise ValueError(f"{name} must be 1-D, got shape {a.shape}")
    if not np.issubdtype(a.dtype, np.integer):
        raise ValueError(f"{name} must be an integer array, got {a.dtype}")
    if a.size and (int(a.min()) < np.iinfo(np.int32).min
                   or int(a.max()) > np.iinfo(np.int32).max):
        raise ValueError(f"{name} values overflow int32")
    return a.astype(np.int32)


class CorpusStore:
    """Append-only on-disk corpus shard store (module docstring).

    Layout on disk::

        <path>/meta.json            format version, sizes, shard index,
                                    retired doc ids
        <path>/shard-00000.npz      doc_ids, word_ids (the token slice)
                                    + stat_doc_ids/stat_doc_len,
                                      stat_word_ids/stat_word_freq
        <path>/retired_wfreq.npy    word-frequency mass of retired docs
                                    (subtracted from the stat aggregate)
    """

    def __init__(self, path: str, meta: dict):
        self.path = path
        self._meta = meta

    # -- construction -------------------------------------------------------
    @classmethod
    def create(cls, path: str, *, num_words: int,
               num_docs: int = 0) -> "CorpusStore":
        if num_words < 1:
            raise ValueError(f"num_words must be >= 1, got {num_words}")
        os.makedirs(path, exist_ok=True)
        if os.path.exists(os.path.join(path, _META)):
            raise FileExistsError(f"store already exists at {path}")
        store = cls(path, {
            "format_version": STORE_FORMAT_VERSION,
            "num_docs": int(num_docs), "num_words": int(num_words),
            "shards": [], "retired": []})
        store._write_meta()
        return store

    @classmethod
    def open(cls, path: str) -> "CorpusStore":
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        v = meta.get("format_version")
        if v != STORE_FORMAT_VERSION:
            raise ValueError(
                f"corpus store at {path} has format_version={v}; this "
                f"build reads version {STORE_FORMAT_VERSION}")
        return cls(path, meta)

    @classmethod
    def from_corpus(cls, corpus: Corpus, path: str, *,
                    tokens_per_shard: int = 1 << 20) -> "CorpusStore":
        """Chunk a materialized corpus into contiguous token-slice shards
        (round-trips exactly: shard order preserves occurrence order)."""
        if tokens_per_shard < 1:
            raise ValueError(
                f"tokens_per_shard must be >= 1, got {tokens_per_shard}")
        store = cls.create(path, num_words=corpus.num_words,
                           num_docs=corpus.num_docs)
        for lo in range(0, corpus.num_tokens, tokens_per_shard):
            hi = min(lo + tokens_per_shard, corpus.num_tokens)
            store.append(corpus.doc_ids[lo:hi], corpus.word_ids[lo:hi])
        return store

    def _write_meta(self) -> None:
        # atomic: a kill mid-write must not corrupt the store index
        tmp = os.path.join(self.path, _META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self._meta, f, indent=1)
        os.replace(tmp, os.path.join(self.path, _META))

    # -- properties ----------------------------------------------------------
    @property
    def num_docs(self) -> int:
        return self._meta["num_docs"]

    @property
    def num_words(self) -> int:
        return self._meta["num_words"]

    @property
    def num_shards(self) -> int:
        return len(self._meta["shards"])

    @property
    def retired(self) -> np.ndarray:
        return np.asarray(self._meta["retired"], np.int64)

    @property
    def num_tokens(self) -> int:
        """Live (non-retired) token count."""
        total = sum(s["n_tokens"] for s in self._meta["shards"])
        return total - int(self._retired_doc_lengths().sum())

    # -- ingestion -----------------------------------------------------------
    def append(self, doc_ids, word_ids, *, num_docs: int | None = None):
        """Append one shard of occurrences.  Doc ids may be new (the doc-id
        space grows) or existing (documents may span shards); ``num_docs``
        forces a larger doc-id space (for trailing empty documents)."""
        d = _as_token_array(doc_ids, "doc_ids")
        w = _as_token_array(word_ids, "word_ids")
        if d.shape != w.shape:
            raise ValueError(
                f"doc_ids/word_ids length mismatch: {d.shape} vs {w.shape}")
        if d.size and int(d.min()) < 0:
            raise ValueError(f"doc_ids must be >= 0, got min {d.min()}")
        if w.size and (int(w.min()) < 0 or int(w.max()) >= self.num_words):
            raise ValueError(
                f"word_ids out of range [0, {self.num_words}): "
                f"[{w.min()}, {w.max()}]")
        if d.size and self.retired.size and np.isin(d, self.retired).any():
            raise ValueError("cannot append occurrences of retired docs")
        sd, sl = np.unique(d, return_counts=True)
        sw, sf = np.unique(w, return_counts=True)
        name = f"shard-{self.num_shards:05d}.npz"
        np.savez(os.path.join(self.path, name),
                 doc_ids=d, word_ids=w,
                 stat_doc_ids=sd.astype(np.int32),
                 stat_doc_len=sl.astype(np.int64),
                 stat_word_ids=sw.astype(np.int32),
                 stat_word_freq=sf.astype(np.int64))
        self._meta["shards"].append({"file": name, "n_tokens": int(d.size)})
        nd = self.num_docs if num_docs is None else int(num_docs)
        if d.size:
            nd = max(nd, int(d.max()) + 1)
        self._meta["num_docs"] = nd
        self._write_meta()
        return self

    def retire(self, doc_ids) -> "CorpusStore":
        """Tombstone documents: their occurrences vanish from every stream
        and stat.  One pass over the shards containing them records the
        word-frequency mass to subtract from the stat aggregate."""
        ids = np.unique(np.asarray(doc_ids, np.int64))
        if ids.size == 0:
            return self
        if int(ids.min()) < 0 or int(ids.max()) >= self.num_docs:
            raise ValueError(
                f"retire ids out of range [0, {self.num_docs})")
        if np.isin(ids, self.retired).any():
            raise ValueError("some doc ids are already retired")
        delta = np.zeros(self.num_words, np.int64)
        for s in self._meta["shards"]:
            with np.load(os.path.join(self.path, s["file"])) as z:
                if not np.isin(z["stat_doc_ids"], ids).any():
                    continue
                m = np.isin(z["doc_ids"], ids)
                np.add.at(delta, z["word_ids"][m], 1)
        old = self._retired_wfreq()
        np.save(os.path.join(self.path, _RETIRED_WFREQ), old + delta)
        self._meta["retired"] = sorted(
            set(self._meta["retired"]) | set(map(int, ids)))
        self._write_meta()
        return self

    # -- streams & stats ------------------------------------------------------
    def iter_tokens(self, include_retired: bool = False):
        """Yield ``(doc_ids, word_ids)`` per shard, in corpus order."""
        retired = self.retired
        for s in self._meta["shards"]:
            with np.load(os.path.join(self.path, s["file"])) as z:
                d, w = z["doc_ids"], z["word_ids"]
            if not include_retired and retired.size:
                keep = ~np.isin(d, retired)
                d, w = d[keep], w[keep]
            yield d, w

    def _retired_wfreq(self) -> np.ndarray:
        p = os.path.join(self.path, _RETIRED_WFREQ)
        if os.path.exists(p):
            a = np.load(p)
            if a.shape != (self.num_words,) or a.dtype != np.int64:
                raise ValueError(
                    f"corrupt {_RETIRED_WFREQ}: expected "
                    f"({self.num_words},) int64, got {a.shape} {a.dtype}")
            return a
        return np.zeros(self.num_words, np.int64)

    def _retired_doc_lengths(self) -> np.ndarray:
        """(num_docs,) lengths of retired docs only (0 elsewhere)."""
        out = np.zeros(self.num_docs, np.int64)
        if not self._meta["retired"]:
            return out
        retired = self.retired
        for s in self._meta["shards"]:
            with np.load(os.path.join(self.path, s["file"])) as z:
                ids, ln = z["stat_doc_ids"], z["stat_doc_len"]
            m = np.isin(ids, retired)
            np.add.at(out, ids[m].astype(np.int64), ln[m])
        return out

    def doc_lengths(self) -> np.ndarray:
        """(num_docs,) live token count per doc — stats only, no token IO."""
        out = np.zeros(self.num_docs, np.int64)
        for s in self._meta["shards"]:
            with np.load(os.path.join(self.path, s["file"])) as z:
                np.add.at(out, z["stat_doc_ids"].astype(np.int64),
                          z["stat_doc_len"])
        out -= self._retired_doc_lengths()
        return out

    def word_freqs(self) -> np.ndarray:
        """(num_words,) live corpus frequency per word — stats only."""
        out = np.zeros(self.num_words, np.int64)
        for s in self._meta["shards"]:
            with np.load(os.path.join(self.path, s["file"])) as z:
                np.add.at(out, z["stat_word_ids"].astype(np.int64),
                          z["stat_word_freq"])
        return out - self._retired_wfreq()

    def to_corpus(self) -> Corpus:
        """Materialize the live occurrence stream (tests / small stores)."""
        parts = list(self.iter_tokens())
        d = (np.concatenate([p[0] for p in parts]) if parts
             else np.zeros(0, np.int32))
        w = (np.concatenate([p[1] for p in parts]) if parts
             else np.zeros(0, np.int32))
        return Corpus(doc_ids=d, word_ids=w, num_docs=self.num_docs,
                      num_words=self.num_words)


def build_layout_from_store(store: CorpusStore, *, n_workers: int, T: int,
                            n_blocks: int | None = None,
                            balance: bool = True, seed: int = 0,
                            layout: str = "dense",
                            tile: int | None = None,
                            doc_tile: int | None = None,
                            doc_blk: int | None = None) -> NomadLayout:
    """Build the nomad layout from shard streams — byte-identical to
    ``build_layout(store.to_corpus(), ...)`` without ever holding the full
    token arrays (module docstring).  Same signature as
    :func:`repro_torch.data.sharding.build_layout`."""
    B = n_workers if n_blocks is None else n_blocks
    W = n_workers
    sharding._validate_build_args(W, B, layout, doc_tile, doc_blk)
    doc_lengths = store.doc_lengths()
    freqs = store.word_freqs()

    def freq_w(doc_assign):
        fw = np.zeros((W, store.num_words), np.int64)
        for d, wds in store.iter_tokens():
            np.add.at(fw, (doc_assign[d], wds), 1)
        return fw

    doc_assign, word_assign = sharding._plan_partition(
        doc_lengths, freqs, W=W, B=B, balance=balance, freq_w=freq_w)
    (doc_of_worker, doc_local, word_of_block, word_local,
     I_max, J_max) = sharding._local_maps(doc_assign, word_assign, W, B)

    dt = int(doc_tile) if doc_tile is not None else 0
    n_doc_tiles = max(-(-I_max // dt), 1) if dt else 1

    # count pass: everything the global geometry needs, streamed
    cell_sizes = np.zeros((W, B), np.int64)
    seg_counts = np.zeros((W * B, n_doc_tiles), np.int64) if dt else None
    n_tokens = 0
    for d, wds in store.iter_tokens():
        tw, tb = doc_assign[d], word_assign[wds]
        np.add.at(cell_sizes, (tw, tb), 1)
        if dt:
            g = (doc_local[d] // dt).astype(np.int64)
            np.add.at(seg_counts, (tw.astype(np.int64) * B + tb, g), 1)
        n_tokens += d.size
    gran, tile = sharding._resolve_gran(layout, dt, doc_blk, tile,
                                        cell_sizes)
    geom = sharding._build_geometry(
        cell_sizes, seg_counts, layout=layout, W=W, B=B, dt=dt, gran=gran,
        n_doc_tiles=n_doc_tiles, tile=tile)
    asm = sharding._LayoutAssembler(geom, n_tokens)

    # fill pass, one worker at a time: gather worker w's tokens in shard
    # order (= corpus order, so sort ties match the monolithic lexsort),
    # stable-sort by (block[, group], word), place.
    for w in range(W):
        pd, pw = [], []
        for d, wds in store.iter_tokens():
            m = doc_assign[d] == w
            if m.any():
                pd.append(d[m])
                pw.append(wds[m])
        dw = np.concatenate(pd) if pd else np.zeros(0, np.int32)
        jw = np.concatenate(pw) if pw else np.zeros(0, np.int32)
        tbw = word_assign[jw]
        if dt:
            sgw = (doc_local[dw] // dt).astype(np.int64)
            order = np.lexsort((jw, sgw, tbw)).astype(np.int64)
        else:
            sgw = None
            order = np.lexsort((jw, tbw)).astype(np.int64)
        asm.add_worker(w, tbw[order], doc_local[dw[order]],
                       word_local[jw[order]], jw[order],
                       sgw[order] if dt else None)

    r_cap = max(1, min(T, int(doc_lengths.max(initial=1))))
    return asm.finish(
        T=T, num_words=store.num_words, doc_of_worker=doc_of_worker,
        word_of_block=word_of_block, I_max=I_max, J_max=J_max,
        doc_assign=doc_assign, word_assign=word_assign,
        cell_sizes=cell_sizes, r_cap=r_cap)


def update_layout(lay: NomadLayout, *, add_doc_ids=None, add_word_ids=None,
                  retire=None, num_new_docs: int | None = None):
    """Incremental doc add/retire with localized layout rebuild.

    Returns ``(new_layout, old_to_new)`` where ``old_to_new`` maps each
    old canonical token index to its new canonical index (``-1`` for
    tokens of retired docs).  See the module docstring for the
    order/slot/uid invariants; the canonical order of surviving tokens is
    preserved verbatim, only touched (worker, block, doc-group) segments
    re-pad, and the RNG stride ``L`` is frozen.

    ``add_doc_ids``/``add_word_ids`` are the new documents' occurrences
    with *fresh* global doc ids (``>= lay.doc_assign.shape[0]``);
    ``retire`` is an iterable of existing doc ids to drop.
    """
    dt = lay.doc_tile
    if dt <= 0:
        raise ValueError(
            "incremental update needs a doc_tile-grouped layout: ungrouped "
            "layouts derive RNG uids from token position, so any insertion "
            "would re-key every live token's chain (rebuild instead, or "
            "build with doc_tile=)")
    W, B, T = lay.W, lay.B, lay.T
    num_docs_old = lay.doc_assign.shape[0]

    retired = np.unique(np.asarray(list(retire) if retire is not None
                                   else [], np.int64))
    if retired.size:
        if int(retired.min()) < 0 or int(retired.max()) >= num_docs_old:
            raise ValueError(
                f"retire ids out of range [0, {num_docs_old})")
        if (lay.doc_assign[retired] < 0).any():
            raise ValueError("some retire ids are already retired")

    # old tokens in canonical order
    ow, ob, odl, owl = lay.token_coords()
    ogd = lay.doc_of_worker[ow, odl]
    ogw = lay.extract_canonical(lay.tok_gwrd)
    oslot = lay.extract_canonical(lay.tok_slot).astype(np.int64)
    og = (odl // dt).astype(np.int64)
    n_old = ow.shape[0]
    keep = (~np.isin(ogd, retired) if retired.size
            else np.ones(n_old, bool))

    # new documents
    if add_doc_ids is None:
        ad = np.zeros(0, np.int64)
        aw = np.zeros(0, np.int64)
    else:
        ad = _as_token_array(add_doc_ids, "add_doc_ids").astype(np.int64)
        aw = _as_token_array(add_word_ids, "add_word_ids").astype(np.int64)
        if ad.shape != aw.shape:
            raise ValueError("add_doc_ids/add_word_ids length mismatch")
        if ad.size and int(ad.min()) < num_docs_old:
            raise ValueError(
                f"added documents must use fresh doc ids >= "
                f"{num_docs_old} (existing documents are immutable)")
        if aw.size and (int(aw.min()) < 0
                        or int(aw.max()) >= lay.num_words):
            raise ValueError(
                f"add_word_ids out of range [0, {lay.num_words})")
    num_new = (int(num_new_docs) if num_new_docs is not None
               else (int(ad.max()) + 1 - num_docs_old if ad.size else 0))
    if ad.size and int(ad.max()) >= num_docs_old + num_new:
        raise ValueError("num_new_docs smaller than the added id range")
    new_len = np.bincount(ad - num_docs_old, minlength=num_new) \
        if num_new else np.zeros(0, np.int64)

    # assign new docs to workers: LPT against the live loads
    live_loads = np.bincount(ow[keep], minlength=W)
    heap = [(int(live_loads[w]), w) for w in range(W)]
    heapq.heapify(heap)
    assign_new = np.zeros(num_new, np.int32)
    for i in np.argsort(-new_len, kind="stable"):
        load, w = heapq.heappop(heap)
        assign_new[i] = w
        heapq.heappush(heap, (load + int(new_len[i]), w))

    # local ids: each worker's new docs start at the next doc-group
    # boundary past its historical high-water mark (never reuse local
    # slots — retired rows stay holes), so new groups are strictly fresh.
    used = np.zeros(W, np.int64)
    for w in range(W):
        occ = np.nonzero(lay.doc_of_worker[w] >= 0)[0]
        used[w] = int(occ[-1]) + 1 if occ.size else 0
    ctr = -(-used // dt) * dt
    new_dloc = np.zeros(num_new, np.int64)
    for i in range(num_new):           # doc-id order → deterministic ids
        w = assign_new[i]
        new_dloc[i] = ctr[w]
        ctr[w] += 1
    recv = np.unique(assign_new) if num_new else np.zeros(0, np.int64)
    I_max_new = max(lay.I_max, int(ctr[recv].max()) if recv.size else 0)
    n_doc_tiles_new = max(-(-I_max_new // dt), 1)

    # doc bookkeeping
    doc_assign_new = np.concatenate(
        [lay.doc_assign, assign_new]).astype(np.int32)
    doc_assign_new[retired] = -1
    doc_of_worker_new = np.full((W, I_max_new), -1, np.int32)
    doc_of_worker_new[:, :lay.I_max] = lay.doc_of_worker
    if retired.size:
        doc_of_worker_new[np.isin(doc_of_worker_new, retired)] = -1
    new_gids = np.arange(num_docs_old, num_docs_old + num_new)
    doc_of_worker_new[assign_new, new_dloc] = new_gids

    # word-local map back from word_of_block
    word_local = np.zeros(lay.num_words, np.int32)
    for b in range(B):
        ids = lay.word_of_block[b]
        m = ids >= 0
        word_local[ids[m]] = np.nonzero(m)[0]

    # new tokens, sorted by (worker, block, group, word, arrival)
    tw_n = assign_new[ad - num_docs_old] if ad.size else np.zeros(0, np.int64)
    dl_n = new_dloc[ad - num_docs_old] if ad.size else np.zeros(0, np.int64)
    tb_n = lay.word_assign[aw] if ad.size else np.zeros(0, np.int64)
    g_n = dl_n // dt
    order_n = np.lexsort((aw, g_n, tb_n, tw_n)).astype(np.int64)
    tw_n, dl_n, tb_n, g_n, aw_s = (tw_n[order_n], dl_n[order_n],
                                   tb_n[order_n], g_n[order_n],
                                   aw[order_n])

    # slots: survivors keep theirs; new tokens continue above the cell's
    # historical high-water mark (uid stride L is frozen)
    hwm = np.zeros(W * B, np.int64)        # high-water mark = max slot + 1
    cellkey_old = ow * B + ob
    np.maximum.at(hwm, cellkey_old, oslot + 1)
    cellkey_n = tw_n.astype(np.int64) * B + tb_n
    slot_n = hwm[cellkey_n] + sharding._running_count(cellkey_n)
    # RNG-uid safety (uniforms are drawn from a per-worker key,
    # core/nomad.py): uid = global_block·L + slot, so a slot >= L would
    # alias into the next block's uid range.  Slots are arbitrary int32s
    # whose only job is the uid, so tokens that would overflow a cell's
    # normal [0, L) range instead take slots mapping into the per-worker
    # uid region past B·L — free by construction at build time (every
    # build-time uid is < B·L) and kept free across repeated updates by
    # continuing past the worker's live uid maximum.
    over = slot_n >= lay.L
    if over.any():
        uid_keep = ob[keep] * np.int64(lay.L) + oslot[keep]
        live_uid_max = np.full(W, np.int64(B) * lay.L - 1)
        np.maximum.at(live_uid_max, ow[keep], uid_keep)
        uid_over = (live_uid_max + 1)[tw_n[over]] \
            + sharding._running_count(tw_n[over])
        slot_n[over] = uid_over - tb_n[over].astype(np.int64) * lay.L
    if slot_n.size and int(slot_n.max(initial=0)) > np.iinfo(np.int32).max:
        raise ValueError(
            "overflow slots no longer fit int32 — the uid space is "
            "exhausted; rebuild the layout (build_layout_from_store)")

    # merge: old survivors (their canonical order intact) + new tokens.
    # New docs occupy strictly fresh doc-groups, so a stable sort on
    # (worker, block, group) alone restores the full canonical
    # (w, b, g, word) order — no (w, b, g) key ever mixes old and new.
    mw = np.concatenate([ow[keep], tw_n])
    mb = np.concatenate([ob[keep], tb_n])
    mg = np.concatenate([og[keep], g_n])
    mdl = np.concatenate([odl[keep].astype(np.int64), dl_n])
    mwl = np.concatenate([owl[keep].astype(np.int64),
                          word_local[aw_s].astype(np.int64)])
    mgw = np.concatenate([ogw.astype(np.int64)[keep], aw_s])
    mslot = np.concatenate([oslot[keep], slot_n])
    src = np.concatenate([np.nonzero(keep)[0],
                          np.full(tw_n.shape[0], -1, np.int64)])
    perm = np.lexsort((mg, mb, mw)).astype(np.int64)
    mw, mb, mg, mdl, mwl, mgw, mslot, src = (
        a[perm] for a in (mw, mb, mg, mdl, mwl, mgw, mslot, src))
    n_new_total = mw.shape[0]
    old_to_new = np.full(n_old, -1, np.int64)
    kept_pos = np.nonzero(src >= 0)[0]
    old_to_new[src[kept_pos]] = kept_pos

    # re-derive geometry from the merged counts (untouched cells get the
    # identical segment layout; touched segments re-pad) with L frozen
    cell_sizes_new = np.zeros((W, B), np.int64)
    np.add.at(cell_sizes_new, (mw, mb), 1)
    seg_counts_new = np.zeros((W * B, n_doc_tiles_new), np.int64)
    np.add.at(seg_counts_new, (mw * B + mb, mg), 1)
    geom = sharding._build_geometry(
        cell_sizes_new, seg_counts_new, layout=lay.kind, W=W, B=B, dt=dt,
        gran=lay.doc_blk, n_doc_tiles=n_doc_tiles_new, tile=lay.tile)
    geom.L = lay.L                       # freeze the RNG stride

    asm = sharding._LayoutAssembler(geom, n_new_total)
    w_bounds = np.searchsorted(mw, np.arange(W + 1))
    for w in range(W):
        lo, hi = int(w_bounds[w]), int(w_bounds[w + 1])
        asm.add_worker(w, mb[lo:hi], mdl[lo:hi], mwl[lo:hi], mgw[lo:hi],
                       mg[lo:hi], slot=mslot[lo:hi])

    r_cap = max(lay.r_cap,
                min(T, int(new_len.max())) if num_new else 1)
    new_lay = asm.finish(
        T=T, num_words=lay.num_words, doc_of_worker=doc_of_worker_new,
        word_of_block=lay.word_of_block, I_max=I_max_new, J_max=lay.J_max,
        doc_assign=doc_assign_new, word_assign=lay.word_assign,
        cell_sizes=cell_sizes_new, r_cap=r_cap)
    return new_lay, old_to_new


def remap_canonical(old_vals: np.ndarray, old_to_new: np.ndarray,
                    n_new: int, *, fill=0) -> np.ndarray:
    """Carry per-token canonical-order values across an
    :func:`update_layout` (retired entries dropped, new tokens ``fill``)."""
    out = np.full(n_new, fill, dtype=np.asarray(old_vals).dtype)
    m = old_to_new >= 0
    out[old_to_new[m]] = np.asarray(old_vals)[m]
    return out


def carry_assignments(z_canon_old: np.ndarray, old_to_new: np.ndarray,
                      new_lay: NomadLayout, *, seed: int = 0) -> np.ndarray:
    """Carry a live chain's canonical ``z`` across an update: surviving
    tokens keep their topics, new tokens draw fresh ones from ``seed``."""
    n_new = new_lay.canon_idx.shape[0]
    z = remap_canonical(z_canon_old, old_to_new, n_new, fill=-1)
    fresh = z < 0
    if fresh.any():
        rng = np.random.default_rng(seed)
        z[fresh] = rng.integers(0, new_lay.T, int(fresh.sum()))
    return z.astype(np.int32)
