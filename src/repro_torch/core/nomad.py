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

Not ported yet (``ROADMAP.md``): the ``"vectorized"`` inner mode,
``collect_lag``, and the chain checkpoint, resume and the ``run`` loop;
they raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import rng
from repro_torch._device import resolve
from repro_torch.core.likelihood import lgamma_sum
from repro_torch.data.sharding import NomadLayout, half_queue_split
from repro_torch.kernels.fused_sweep import rbucket
from repro_torch.kernels.fused_sweep.ops import sweep_streams
from repro_torch.kernels.fused_sweep.ref import sweep_streams_ref

__all__ = ["NomadLDA"]

_TODO = "not ported yet; see ROADMAP.md, Queue 1"


@dataclass
class NomadLDA:
    """The F+Nomad LDA trainer on one device, with ``layout.W`` lock-step
    workers.  ``inner_mode``: ``"fused"`` (the CUDA kernel on the card,
    its plain version on the CPU) or ``"scan"`` (the plain version on any
    device, never paged).  ``doc_tile``: ``None``, or the layout's
    ``doc_tile`` to page ``n_td`` slabs.  ``r_cap=0`` means ``T``.
    ``device=None`` means CUDA."""
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

    def __post_init__(self):
        lay = self.layout
        if self.doc_tile is not None \
                and self.doc_tile != (lay.doc_tile or None):
            raise ValueError(
                f"doc_tile={self.doc_tile} but the layout was built with "
                f"doc_tile={lay.doc_tile or None}; the slab height is a "
                f"layout-build-time choice (it fixes the token order)")
        if self.collect_lag:
            raise NotImplementedError(f"collect_lag is {_TODO}")
        if self.inner_mode == "vectorized":
            raise NotImplementedError(f"the 'vectorized' inner mode is "
                                      f"{_TODO}")
        if self.inner_mode not in ("scan", "fused"):
            raise ValueError(self.inner_mode)
        if self.sync_mode not in ("stoken", "stale", "allreduce"):
            raise ValueError(self.sync_mode)
        if self.ring_mode not in ("barrier", "pipelined"):
            raise ValueError(self.ring_mode)
        if self.r_mode not in ("dense", "sparse"):
            raise ValueError(f"r_mode must be 'dense' or 'sparse', got "
                             f"{self.r_mode}")
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
        self._sweep_fn = (functools.partial(sweep_streams, kernel=name)
                          if fused else sweep_streams_ref)

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
        n_t = np.bincount(z_canon, minlength=lay.T).astype(np.int32)
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
        arrays = {k: torch.as_tensor(np.ascontiguousarray(v, np.int32),
                                     device=self.dev)
                  for k, v in host.items()}
        if self.r_mode == "sparse":
            tpc, cnt = rbucket.build_side_table(
                arrays["n_td"].reshape(-1, lay.T), self.cap)
            shape = (lay.W, lay.I_max, self.cap)
            arrays.update(rb_topics=tpc.reshape(shape).contiguous(),
                          rb_counts=cnt.reshape(shape).contiguous())
        return arrays

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
        ones are not changed)."""
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
        for r in range(W):
            c = (workers + r) % W
            cell_tok = cot[workers, c].long().repeat_interleave(tile, dim=1)
            uid = ((c * k)[:, None] + cell_tok) * lay.L + slot[workers, c]
            u = rng.token_uniforms(rng.fold_in(keys, r), uid)
            n_t_before = n_t_local.clone()
            for start, count in g["halves"]:
                self._sweep_fn(*toks, z_s, u, cot, n_td.view(-1, T),
                               n_wt.view(-1, T), n_t_local, r=r,
                               tile_start=start, num_tiles=count, **common)
            delta_mine += n_t_local - n_t_before
            if self.sync_mode == "allreduce":
                n_t_local[:] = n_t0 + delta_mine.sum(0, dtype=torch.int32)
            elif self.sync_mode == "stoken":
                w0 = (-r) % W                    # the worker on chunk 0
                s_tok = s_tok + (delta_mine[w0] - delta_folded[w0])
                n_t_local[w0] = s_tok
                delta_folded[w0] = delta_mine[w0]
        out.update(z=z, n_td=n_td, n_wt=n_wt,
                   n_t=n_t0 + delta_mine.sum(0, dtype=torch.int32))
        if sparse:
            out.update(rb_topics=tables["topics"],
                       rb_counts=tables["counts"])
        return out

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

    # -- not ported yet --------------------------------------------------------
    def export_chain_state(self, *args, **kw):
        raise NotImplementedError(f"chain checkpoints are {_TODO}")

    restore_chain_state = save_checkpoint = load_checkpoint = \
        export_chain_state

    def run(self, *args, **kw):
        raise NotImplementedError(f"NomadLDA.run (checkpoint, resume, "
                                  f"publish) is {_TODO}")
