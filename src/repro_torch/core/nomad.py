"""Nomad F+LDA on one GPU (paper §4), the port of ``repro/core/nomad.py``.

The reference runs ``W`` workers as a ring over a device mesh: in round
``r`` (of ``W`` per sweep) worker ``w`` holds chunk ``c = (w + r) % W`` of
the word-topic blocks, global blocks ``c·k … c·k+k−1``, sweeps its ragged
stream against them and passes them on with ``ppermute``.  On one card the
W workers run in lock step and the ring becomes indexing: the arrays keep
the reference's global shapes, and worker ``w`` sweeps its chunk of
``n_wt`` ``(B, J_max, T)`` in place.  The chunks of a round are disjoint
and so are the workers' documents, so one kernel launch covers all W
workers of a round (one CTA each), each with its own ``n_t`` copy.

Both token geometries of the reference run.  The ragged layout's
``(W, W, S)`` streams go through the kernel as they are, ``cell_of_tile``
naming each tile's block.  The dense layout's ``(W, B, L)`` cell grid is
read as ``(W, W, k·L)``: chunk ``c``'s queue, blocks ``c·k … c·k+k−1``, is
contiguous, so it is one stream whose tile of ``L`` slots is a cell.
``ring_mode="pipelined"`` splits a round into two launches, as the
reference splits it into two half-queue calls: at ``layout.tile_split``
on the ragged stream, at cell ``half_queue_split(k)`` on the dense grid.
The chain is the same, so both ring modes give the same bits.

A layout built with ``doc_tile`` orders each cell's tokens by doc slab;
``NomadLDA(doc_tile=layout.doc_tile)`` then pages one ``(doc_tile, T)``
slab of each worker's ``n_td`` through the kernel's shared memory, and
``doc_tile=None`` runs the same grouped order unpaged.  Paged, unpaged,
dense and ragged sweeps of one grouped order give the same bits.

The s token (``n_t``) follows the reference's three sync modes, folded at
the same point of every round with integer tensor ops between launches:
``"stoken"`` (the worker holding chunk 0 folds its delta into the one
travelling ``s`` vector), ``"stale"`` (nothing until the sweep's end) and
``"allreduce"`` (every worker resyncs every round).  Every mode ends the
sweep with the exact ``n_t``.  Uniforms are the reference's counter-mode
draws per canonical token id (block and slot; an ungrouped dense row's
slot is its position), so for the same corpus, seed and modes both
packages, and both layouts, run the same chain bit for bit.

``inner_mode="vectorized"`` is the reference's batched delayed-count
mode (``_vectorized_pass``): each cell is one pass in which every token of
the cell is drawn against the counts as they were when the cell began,
minus its own count, and the integer deltas are applied after.  On one
card a pass covers cell ``j`` of all W workers' queues at once: the
round's valid tokens are gathered once, sorted by cell (with their
uniforms, the same counter-mode draws), and each cell is one launch of
the ``lda_scores`` kernel's pass form over its slice of them, then
``index_add_`` of the deltas.  Cells run in queue order in both ring
modes (the pipelined split moves no freeze point), so the dense grid and
the ragged stream run one chain, as the reference promises.  It ignores
``doc_tile`` paging and refuses ``r_mode="sparse"``, as the reference
does.

``collect_lag=True`` makes the sweep also return, under ``"lag"``, the
reference's ``(W, W, 2, T)`` int32 trace: for each round and worker,
``n_t_local`` after the round's sync and the cumulative ``delta_mine``
(``launch/stoken_lag_check.py`` checks the s token's staleness bound on
it).  It reads the chain and never writes it.

The lifecycle is the reference's: :meth:`export_chain_state` snapshots
the chain at a sweep boundary (``z`` in canonical order, compact counts,
the sparse side tables verbatim, the chain-affecting knobs in meta),
:meth:`restore_chain_state` is its exact inverse for this trainer's
layout, and :meth:`run` drives sweeps with checkpoints every
``checkpoint_every`` sweeps into a ``.npz`` file or a rotation directory,
resumes from ``resume_from``, publishes φ snapshots to a serving engine
and fires the fault sites of a ``FaultPlan``.  Checkpoint files are the
reference's format: a chain checkpointed by either package resumes in
the other and stays bit-equal.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import fault, rng
from repro_torch._device import resolve
from repro_torch.core.likelihood import lgamma_sum
from repro_torch.data.sharding import NomadLayout, half_queue_split
from repro_torch.kernels.fused_sweep import rbucket
from repro_torch.kernels.fused_sweep.ops import sweep_streams
from repro_torch.kernels.fused_sweep.ref import sweep_streams_ref
from repro_torch.kernels.lda_scores.ops import vectorized_pass
from repro_torch.train import checkpoint

__all__ = ["NomadLDA"]

#: The meta keys a restore compares with this trainer's: any of them
#: different would fork the chain.  ``layout_kind`` is written but not
#: compared: ``z`` is stored in canonical order, so a checkpoint of one
#: layout resumes on the other.
_COMPARED_META = ("T", "alpha", "beta", "sync_mode", "r_mode", "r_cap",
                  "rng_stride", "n_tokens", "W", "B", "doc_tile",
                  "num_docs", "num_words")


@dataclass
class NomadLDA:
    """The F+Nomad LDA trainer on one device, with ``layout.W`` lock-step
    workers.  ``inner_mode``: ``"fused"`` (the CUDA kernel on the card,
    its plain version on the CPU), ``"scan"`` (the plain version on any
    device, never paged) or ``"vectorized"`` (the batched cell pass; the
    ``lda_scores`` kernel on the card, its plain version on the CPU).
    ``doc_tile``: ``None``, or the layout's ``doc_tile`` to page ``n_td``
    slabs in fused mode (other modes run the same order unpaged).
    ``r_cap=0`` means ``T``.  ``device=None`` means CUDA.
    ``checkpoint_every``/``checkpoint_path``/``resume_from``/
    ``checkpoint_keep`` drive :meth:`run`'s checkpoints (a path ending
    ``.npz`` is one file, anything else a rotation directory keeping
    ``checkpoint_keep`` slots)."""
    layout: NomadLayout
    alpha: float
    beta: float
    sync_mode: str = "stoken"
    inner_mode: str = "scan"
    ring_mode: str = "barrier"
    r_mode: str = "dense"
    r_cap: int = 0
    device: str | torch.device | None = None
    doc_tile: int | None = None
    collect_lag: bool = False
    checkpoint_every: int | None = None
    checkpoint_path: str | None = None
    resume_from: str | None = None
    checkpoint_keep: int = 3

    def __post_init__(self):
        lay = self.layout
        if self.checkpoint_every is not None:
            if self.checkpoint_every < 1:
                raise ValueError(
                    f"checkpoint_every must be >= 1, got "
                    f"{self.checkpoint_every}")
            if not self.checkpoint_path:
                raise ValueError(
                    "checkpoint_every needs checkpoint_path to write to")
        if self.doc_tile is not None \
                and self.doc_tile != (lay.doc_tile or None):
            raise ValueError(
                f"doc_tile={self.doc_tile} but the layout was built with "
                f"doc_tile={lay.doc_tile or None}; the slab height is a "
                f"layout-build-time choice (it fixes the token order)")
        if self.inner_mode not in ("scan", "fused", "vectorized"):
            raise ValueError(self.inner_mode)
        if self.sync_mode not in ("stoken", "stale", "allreduce"):
            raise ValueError(self.sync_mode)
        if self.ring_mode not in ("barrier", "pipelined"):
            raise ValueError(self.ring_mode)
        if self.r_mode not in ("dense", "sparse"):
            raise ValueError(f"r_mode must be 'dense' or 'sparse', got "
                             f"{self.r_mode}")
        if self.r_mode == "sparse" and self.inner_mode == "vectorized":
            raise ValueError(
                "r_mode='sparse' needs an exact per-token chain; the batched "
                "'vectorized' inner mode has no per-token side-table order")
        if lay.B % lay.W:
            raise ValueError(f"layout B={lay.B} is not a multiple of "
                             f"W={lay.W}")
        self.cap = int(self.r_cap) or lay.T
        if not 1 <= self.cap <= lay.T:
            raise ValueError(f"r_cap must be in [1, T]; got {self.r_cap}")
        self.beta_bar = self.beta * lay.num_words
        self.dev = resolve(self.device)
        fused = self.inner_mode == "fused"
        self.paged = fused and self.doc_tile is not None
        name = {"dense": "fused_sweep_cells",
                "ragged": "fused_sweep_ragged"}[lay.kind]
        self._sweep_fn = {
            "fused": functools.partial(sweep_streams, kernel=name),
            "scan": sweep_streams_ref, "vectorized": None}[self.inner_mode]

    # -- state construction --------------------------------------------------
    def init_arrays(self, seed: int = 0) -> dict:
        """The sweep arrays on the device, in the reference's global
        shapes and with its keys: tok_*/z ``(W, B, L)`` (dense) or ``(W,
        W, S)`` (ragged) int32, ``tok_valid`` and ``tok_bound`` as 0/1;
        ``n_td`` ``(W, I_max, T)``, ``n_wt`` ``(B, J_max, T)``, ``n_t``
        ``(T,)``; ``cell_of_tile`` (ragged), ``tok_slot`` (ragged or
        grouped), ``doc_tile_of`` (grouped), and ``rb_topics``/
        ``rb_counts`` ``(W, I_max, cap)`` in sparse r-mode.  The initial
        topics are the reference's numpy draws in canonical token order."""
        lay = self.layout
        r = np.random.default_rng(seed)
        z_canon = r.integers(0, lay.T,
                             lay.canon_idx.shape[0]).astype(np.int32)
        n_td = np.zeros((lay.W, lay.I_max, lay.T), np.int32)
        n_wt = np.zeros((lay.B, lay.J_max, lay.T), np.int32)
        w_idx, b_idx, d_idx, j_idx = lay.token_coords()
        np.add.at(n_td, (w_idx, d_idx, z_canon), 1)
        np.add.at(n_wt, (b_idx, j_idx, z_canon), 1)
        n_t = np.bincount(z_canon, minlength=lay.T)
        arrays = self._device_arrays(z_canon, n_td, n_wt, n_t)
        if self.r_mode == "sparse":
            tpc, cnt = rbucket.build_side_table(
                arrays["n_td"].reshape(-1, lay.T), self.cap)
            shape = (lay.W, lay.I_max, self.cap)
            arrays.update(rb_topics=tpc.reshape(shape).contiguous(),
                          rb_counts=cnt.reshape(shape).contiguous())
        return arrays

    def _device_arrays(self, z_canon, n_td, n_wt, n_t) -> dict:
        """The layout's token arrays and the chain (canonical ``z``,
        padded ``n_td``/``n_wt``, ``n_t``) as int32 tensors on the device,
        under the reference's keys."""
        lay = self.layout
        host = dict(tok_doc=lay.tok_doc, tok_wrd=lay.tok_wrd,
                    tok_valid=lay.tok_valid, tok_bound=lay.tok_bound,
                    z=lay.place_canonical(z_canon), n_td=n_td, n_wt=n_wt,
                    n_t=n_t)
        if lay.kind == "ragged":
            host.update(cell_of_tile=lay.cell_of_tile)
        if lay.kind == "ragged" or lay.doc_tile:
            host.update(tok_slot=lay.tok_slot)
        if lay.doc_tile:
            host.update(doc_tile_of=lay.doc_tile_of)
        return {k: torch.as_tensor(np.ascontiguousarray(v, np.int32),
                                   device=self.dev)
                for k, v in host.items()}

    def _geometry(self, arrays: dict, k0: int) -> dict:
        """The round's stream geometry for the kernel: ``(W, W, S)``
        views of the token arrays, the tile→cell map and tile size, the
        slot of each stream position, the paging map, and the launches
        ``(tile_start, num_tiles)`` of a round."""
        lay = self.layout
        W, k = lay.W, lay.k
        dev = self.dev
        if lay.kind == "ragged":
            view = lambda a: a
            tile, n_tiles = lay.tile, lay.n_tiles
            cot = arrays["cell_of_tile"]
            split, dtile = (lay.tile_split if k0 > 0 else 0), lay.tile
        else:                               # a cell row is a tile
            tile, n_tiles = arrays["tok_doc"].shape[-1], k
            view = lambda a: a.view(W, W, k * a.shape[-1])
            cot = torch.arange(k, dtype=torch.int32, device=dev).expand(
                W, W, k).contiguous()
            split, dtile = k0, lay.doc_blk
        if lay.kind == "ragged" or lay.doc_tile:
            slot = view(arrays["tok_slot"])
        else:                               # an ungrouped row's slot
            slot = torch.arange(tile, device=dev).repeat(k).expand(W, W, -1)
        paging = {}
        if self.paged:
            paging = dict(dto=view(arrays["doc_tile_of"]), dtile=dtile,
                          doc_rows=lay.doc_tile)
        halves = ([(0, split), (split, n_tiles - split)] if split > 0
                  else [(0, n_tiles)])
        return dict(view=view, tile=tile, cot=cot, slot=slot, paging=paging,
                    halves=halves)

    def sweep(self, arrays: dict, seed: int) -> dict:
        """One sweep of all W ring rounds; returns new arrays (the given
        ones are not changed), with the ``(W, W, 2, T)`` ``"lag"`` trace
        when ``collect_lag`` is set."""
        lay = self.layout
        W, k, T = lay.W, lay.k, lay.T
        dev = self.dev
        out = dict(arrays)
        z = arrays["z"].clone()
        n_td = arrays["n_td"].clone()
        n_wt = arrays["n_wt"].clone()
        n_t0 = arrays["n_t"]
        sparse = self.r_mode == "sparse"
        tables = {}
        if sparse:
            tables = dict(topics=arrays["rb_topics"].clone(),
                          counts=arrays["rb_counts"].clone())
        flat = {key: v.view(-1, v.shape[-1]) for key, v in tables.items()}
        k0 = half_queue_split(k) if self.ring_mode == "pipelined" else 0
        g = self._geometry(arrays, k0)
        tile, cot, slot, view = g["tile"], g["cot"], g["slot"], g["view"]
        toks = [view(arrays[key]) for key in ("tok_doc", "tok_wrd",
                                               "tok_valid", "tok_bound")]
        z_s = view(z)
        workers = torch.arange(W, device=dev)
        keys = rng.fold_in(rng.key(seed, dev), workers)
        n_t_local = n_t0.expand(W, T).clone()
        delta_mine = torch.zeros((W, T), dtype=torch.int32, device=dev)
        delta_folded = torch.zeros_like(delta_mine)
        s_tok = n_t0.clone()
        common = dict(k=k, tile=tile, I_max=lay.I_max, J_max=lay.J_max,
                      alpha=self.alpha, beta=self.beta,
                      beta_bar=self.beta_bar, cap=self.cap, **flat,
                      **g["paging"])
        rounds = (self._round_tokens(toks[2], cot, tile)
                  if self._sweep_fn is None else None)
        lag = []
        for r in range(W):
            n_t_before = n_t_local.clone()
            if rounds is not None:
                self._vectorized_round(*rounds[r], toks[:2], z_s, cot, slot,
                                       rng.fold_in(keys, r), n_td, n_wt,
                                       n_t_local, tile=tile)
            else:
                c = (workers + r) % W
                cell_tok = cot[workers, c].long().repeat_interleave(
                    tile, dim=1)
                uid = (((c * k)[:, None] + cell_tok) * lay.L
                       + slot[workers, c])
                u = rng.token_uniforms(rng.fold_in(keys, r), uid)
                for start, count in g["halves"]:
                    self._sweep_fn(*toks, z_s, u, cot, n_td.view(-1, T),
                                   n_wt.view(-1, T), n_t_local, r=r,
                                   tile_start=start, num_tiles=count,
                                   **common)
            delta_mine += n_t_local - n_t_before
            if self.sync_mode == "allreduce":
                n_t_local[:] = n_t0 + delta_mine.sum(0, dtype=torch.int32)
            elif self.sync_mode == "stoken":
                w0 = (-r) % W                    # the worker on chunk 0
                s_tok = s_tok + (delta_mine[w0] - delta_folded[w0])
                n_t_local[w0] = s_tok
                delta_folded[w0] = delta_mine[w0]
            if self.collect_lag:
                lag.append(torch.stack([n_t_local, delta_mine], dim=1))
        out.update(z=z, n_td=n_td, n_wt=n_wt,
                   n_t=n_t0 + delta_mine.sum(0, dtype=torch.int32))
        if sparse:
            out.update(rb_topics=tables["topics"],
                       rb_counts=tables["counts"])
        if self.collect_lag:
            out["lag"] = torch.stack(lag)
        return out

    def _round_tokens(self, valid, cot, tile: int) -> list:
        """The valid slots of each round's W streams, as flat positions
        into the ``(W, W, S)`` stream geometry (round ``r`` holds worker
        w's stream of chunk ``(w + r) % W``), sorted by cell: for each
        round, its positions and the sizes of its k cells' slices.  Two
        host syncs a sweep."""
        W, k = self.layout.W, self.layout.k
        S = valid.shape[-1]
        pos = torch.nonzero(valid.reshape(-1)).flatten()
        w, c = pos // (W * S), pos // S % W
        key = (c - w) % W * k + cot[w, c, pos % S // tile].long()
        pos = pos[torch.argsort(key, stable=True)]
        sizes = torch.bincount(key, minlength=W * k).tolist()
        cells = [sizes[r * k:(r + 1) * k] for r in range(W)]
        return list(zip(pos.split([sum(n) for n in cells]), cells))

    def _round_batch(self, pos, toks, z_s, cot, slot, key_r, *,
                     tile: int) -> dict:
        """The pass inputs of one round's valid tokens ``pos`` (flat
        positions, :meth:`_round_tokens`), as int32 ``(N,)`` arrays: their
        ``n_td``, ``n_wt`` and ``n_t_local`` rows and topics, and their
        uniforms, the reference's counter-mode draws taken for these
        tokens only (``toks``: the ``(W, W, S)`` doc and word arrays)."""
        lay = self.layout
        W, k = lay.W, lay.k
        S = z_s.shape[-1]
        w, c, s = pos // (W * S), pos // S % W, pos % S
        cell = cot[w, c, s // tile].long()
        flat = lambda a: a.reshape(-1)[pos]
        uid = (c * k + cell) * lay.L + slot[w, c, s]
        i32 = lambda x: x.to(torch.int32).contiguous()
        return dict(
            rows=(i32(w * lay.I_max + flat(toks[0])),
                  i32((c * k + cell) * lay.J_max + flat(toks[1])), i32(w)),
            z=i32(flat(z_s)), u=rng.uniform(rng.fold_in(key_r[w], uid)))

    def _vectorized_round(self, pos, cells, toks, z_s, cot, slot, key_r,
                          n_td, n_wt, n_t_local, *, tile: int) -> None:
        """One round of the vectorized mode, in place, over the round's
        valid tokens ``pos``, sorted by cell with the slice sizes
        ``cells``: the k cells of every worker's queue in order, one pass
        each over all W workers' tokens of the cell, each token against
        its own worker's ``n_t_local`` row."""
        T = self.layout.T
        b = self._round_batch(pos, toks, z_s, cot, slot, key_r, tile=tile)
        z = b["z"]
        start = 0
        for n in cells:
            part = slice(start, start + n)
            start += n
            if n:
                z[part] = vectorized_pass(
                    *(row[part] for row in b["rows"]), z[part], b["u"][part],
                    n_td.view(-1, T), n_wt.view(-1, T), n_t_local,
                    alpha=self.alpha, beta=self.beta, beta_bar=self.beta_bar)
        z_s.view(-1)[pos] = z

    # -- evaluation -----------------------------------------------------------
    def log_likelihood(self, arrays: dict) -> float:
        """Joint LL from the padded tables (pad rows contribute 0), each
        ``lgamma`` term in f32 and the sums in f64.  ``T·α`` and ``J·β``
        are Python doubles rounded once to f32, as the reference forms
        them here."""
        lay = self.layout
        T, J = lay.T, lay.num_words
        a = float(torch.tensor(self.alpha, dtype=torch.float32))
        b = float(torch.tensor(self.beta, dtype=torch.float32))
        lg = lambda x: float(torch.lgamma(torch.tensor(x,
                                                       dtype=torch.float32)))
        n_td = arrays["n_td"].to(torch.float32)
        is_doc = torch.as_tensor(lay.doc_of_worker >= 0, device=n_td.device)
        I = int(is_doc.sum())
        pads = lay.W * lay.I_max - I
        doc = (I * (lg(T * self.alpha) - T * lg(a))
               - lgamma_sum(T * self.alpha + n_td.sum(2), is_doc)
               + lgamma_sum(a + n_td) - pads * T * lg(a))
        topic = (T * (lg(J * self.beta) - J * lg(b))
                 - lgamma_sum(J * self.beta
                              + arrays["n_t"].to(torch.float32))
                 + lgamma_sum(b + arrays["n_wt"].to(torch.float32))
                 - (lay.B * lay.J_max - J) * T * lg(b))
        return doc + topic

    def global_counts(self, arrays: dict):
        """Compact global ``(n_td, n_wt, n_t)`` as int64 numpy arrays."""
        lay = self.layout
        n_td_p = arrays["n_td"].cpu().numpy()
        n_wt_p = arrays["n_wt"].cpu().numpy()
        n_td = np.zeros((lay.doc_assign.shape[0], lay.T), np.int64)
        m = lay.doc_of_worker >= 0
        n_td[lay.doc_of_worker[m]] = n_td_p[m]
        n_wt = np.zeros((lay.num_words, lay.T), np.int64)
        m = lay.word_of_block >= 0
        n_wt[lay.word_of_block[m]] = n_wt_p[m]
        return n_td, n_wt, arrays["n_t"].cpu().numpy().astype(np.int64)

    def export_phi_snapshot(self, arrays: dict, *, sweep: int | None = None):
        """Freeze the word-topic counts into a serving snapshot
        (:class:`repro_torch.serve.lda_engine.PhiSnapshot`), as the
        reference does."""
        from repro_torch.serve.lda_engine import snapshot_from_counts
        _, n_wt, n_t = self.global_counts(arrays)
        extra = {"source": "nomad", "T": self.layout.T,
                 "num_words": self.layout.num_words}
        if sweep is not None:
            extra["sweep"] = int(sweep)
        return snapshot_from_counts(n_wt, n_t, alpha=self.alpha,
                                    beta=self.beta, extra_meta=extra)

    # -- chain checkpoint and resume -----------------------------------------
    def _chain_meta(self, *, next_seed: int) -> dict:
        """Every chain-affecting knob, as the reference writes it."""
        lay = self.layout
        return {
            "next_seed": int(next_seed),    # the RNG counter: sweep seeds
            "ring_round": 0,                # checkpoints sit at sweep
            "half_pos": 0,                  # boundaries: queues are home
            "T": int(lay.T), "alpha": float(self.alpha),
            "beta": float(self.beta), "sync_mode": self.sync_mode,
            "r_mode": self.r_mode, "r_cap": int(self.r_cap),
            "rng_stride": int(lay.L),
            "n_tokens": int(lay.canon_idx.shape[0]),
            "W": int(lay.W), "B": int(lay.B), "layout_kind": lay.kind,
            "doc_tile": int(lay.doc_tile),
            "num_docs": int(lay.doc_assign.shape[0]),
            "num_words": int(lay.num_words),
        }

    def export_chain_state(self, arrays: dict, *, next_seed: int):
        """Snapshot the chain at a sweep boundary → ``(state, meta)``.

        ``z`` is stored in canonical token order and the count tables
        compact (global doc and word ids), all int32, so the snapshot is
        independent of the token geometry.  The sparse side tables are
        stored verbatim: a rebuild from ``n_td`` may list a document's
        topics in another order.  The F+tree is rebuilt inside every
        sweep, so only a digest of its basis (sha256 of the int32 ``n_wt``
        bytes, ``ftree_digest``) is kept, checked on restore."""
        lay = self.layout
        n_td, n_wt, n_t = self.global_counts(arrays)
        state = {
            "z_canon": lay.extract_canonical(
                arrays["z"].cpu().numpy()).astype(np.int32),
            "n_td": n_td.astype(np.int32),
            "n_wt": n_wt.astype(np.int32),
            "n_t": n_t.astype(np.int32),
        }
        if self.r_mode == "sparse":
            state["rb_topics"] = arrays["rb_topics"].cpu().numpy()
            state["rb_counts"] = arrays["rb_counts"].cpu().numpy()
        meta = self._chain_meta(next_seed=next_seed)
        meta["ftree_digest"] = hashlib.sha256(
            np.ascontiguousarray(state["n_wt"]).tobytes()).hexdigest()
        return state, meta

    def restore_chain_state(self, state: dict, meta: dict):
        """Rebuild the sweep arrays from a chain snapshot → ``(arrays,
        next_seed)``: the exact inverse of :meth:`export_chain_state` for
        this trainer's layout, with :meth:`init_arrays`' keys, dtypes,
        shapes and device.  Refuses (``ValueError``) a snapshot whose
        chain-affecting knobs differ from this trainer's, one not at a
        sweep boundary, and one whose ``n_wt`` fails its digest."""
        lay = self.layout
        want = self._chain_meta(next_seed=0)
        for k in _COMPARED_META:
            if meta.get(k) != want[k]:
                raise ValueError(
                    f"chain checkpoint mismatch on {k!r}: checkpoint has "
                    f"{meta.get(k)!r}, this trainer has {want[k]!r}; "
                    f"resuming would fork the chain")
        if meta.get("ring_round") or meta.get("half_pos"):
            raise ValueError(
                "chain checkpoint not at a sweep boundary "
                f"(ring_round={meta.get('ring_round')}, "
                f"half_pos={meta.get('half_pos')})")
        got = hashlib.sha256(np.ascontiguousarray(
            state["n_wt"], np.int32).tobytes()).hexdigest()
        if meta.get("ftree_digest") not in (None, got):
            raise ValueError("chain checkpoint n_wt digest mismatch: "
                             "corrupt or hand-edited snapshot")
        n_td = np.zeros((lay.W, lay.I_max, lay.T), np.int32)
        m = lay.doc_of_worker >= 0
        n_td[m] = state["n_td"][lay.doc_of_worker[m]]
        n_wt = np.zeros((lay.B, lay.J_max, lay.T), np.int32)
        m = lay.word_of_block >= 0
        n_wt[m] = state["n_wt"][lay.word_of_block[m]]
        arrays = self._device_arrays(state["z_canon"], n_td, n_wt,
                                     state["n_t"])
        if self.r_mode == "sparse":
            shape = (lay.W, lay.I_max, self.cap)
            for k in ("rb_topics", "rb_counts"):
                if state[k].shape != shape:
                    raise ValueError(f"checkpoint {k} shape "
                                     f"{state[k].shape} != {shape}")
                arrays[k] = torch.as_tensor(
                    np.ascontiguousarray(state[k], np.int32),
                    device=self.dev)
        return arrays, int(meta["next_seed"])

    def save_checkpoint(self, path: str, arrays: dict, *,
                        next_seed: int) -> str:
        """Checkpoint the chain to ``path`` → the written file.  A path
        ending ``.npz`` is one file; anything else is a
        :class:`~repro_torch.train.checkpoint.CheckpointRotation`
        directory (slot step = ``next_seed``, keeping ``checkpoint_keep``
        slots)."""
        state, meta = self.export_chain_state(arrays, next_seed=next_seed)
        if path.endswith(".npz"):
            return checkpoint.save_chain(path, state, meta)
        rot = checkpoint.CheckpointRotation(path, keep=self.checkpoint_keep)
        return rot.save(state, meta, step=next_seed)

    def load_checkpoint(self, path: str):
        """Inverse of :meth:`save_checkpoint` → ``(arrays, next_seed)``: a
        ``.npz`` path loads that file; a directory loads the newest valid
        rotation slot, damaged slots skipped."""
        if path.endswith(".npz"):
            state, meta = checkpoint.load_chain(path)
        else:
            rot = checkpoint.CheckpointRotation(
                path, keep=self.checkpoint_keep)
            state, meta, _ = rot.load_latest_valid()
        return self.restore_chain_state(state, meta)

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def run(self, n_sweeps: int, *, init_seed: int = 0, on_sweep=None,
            publish_every: int | None = None, on_publish=None,
            fault_plan=None) -> tuple[dict, int]:
        """Drive the chain to ``n_sweeps`` sweeps in all, checkpointing
        every ``checkpoint_every`` sweeps (resuming from ``resume_from``
        if set) → ``(arrays, n_sweeps)``.  Sweep ``s`` runs with
        ``seed=s`` whether reached straight or across a resume, so an
        interrupted run is bit-equal to a straight one.

        Every ``publish_every`` sweeps the counts are frozen into a φ
        snapshot (:meth:`export_phi_snapshot`, ``sweep`` = sweeps done)
        and handed to ``on_publish``, typically ``LdaEngine.publish``.
        Publishing reads the chain and never writes it.

        ``fault_plan`` (a :class:`repro_torch.fault.FaultPlan`) is
        installed for the loop.  Sites fired for sweep ``s``, in order:
        ``"trainer.publish"`` (index ``s``, before a scheduled publish;
        ``drop`` skips it), ``"chain.write"`` (inside the checkpoint
        write) and ``"trainer.sweep"`` (index ``s``, after the
        checkpoint)."""
        if publish_every is not None:
            if publish_every < 1:
                raise ValueError(
                    f"publish_every must be >= 1, got {publish_every}")
            if on_publish is None:
                raise ValueError("publish_every needs an on_publish "
                                 "callback to hand snapshots to")
        with fault.install(fault_plan) if fault_plan is not None \
                else contextlib.nullcontext():
            if self.resume_from:
                arrays, start = self.load_checkpoint(self.resume_from)
            else:
                arrays = self.init_arrays(seed=init_seed)
                start = 0
            for s in range(start, n_sweeps):
                arrays = self.sweep(arrays, seed=s)
                if on_sweep is not None:
                    on_sweep(s, arrays)
                if publish_every and (s + 1) % publish_every == 0:
                    self._sync()
                    if "drop" not in fault.fire("trainer.publish", index=s):
                        on_publish(
                            self.export_phi_snapshot(arrays, sweep=s + 1))
                if (self.checkpoint_every
                        and (s + 1) % self.checkpoint_every == 0):
                    self._sync()
                    self.save_checkpoint(self.checkpoint_path, arrays,
                                         next_seed=s + 1)
                fault.fire("trainer.sweep", index=s)
        return arrays, n_sweeps
