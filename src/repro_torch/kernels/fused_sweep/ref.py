"""Plain PyTorch version of the fused F+LDA sweep: the chain oracle, the
port of ``repro/kernels/fused_sweep/ref.py``.

:func:`sweep_streams_ref` runs the exact Alg. 3 per-token chain over a
batch of W token streams in lock step (one per nomad worker, or W = 1 for
a single stream), each against its own doc rows, word-topic block and
``n_t`` copy.  The streams touch disjoint rows, so the count tables are
shared and updated in place; it is what the CUDA kernel
(``csrc/fused_sweep.cu``) computes, with the same arguments, and its
yardstick on the card.  :func:`fused_sweep_ref`,
:func:`fused_sweep_cells_ref` and :func:`fused_sweep_ragged_ref` keep the
reference's signatures.

Doc-tile paging (``dto``/``doc_rows``, the reference's ``doc_tile_of``):
each stream keeps one ``(doc_rows, T)`` slab of its ``n_td`` rows in a
buffer of its own, pulls it at the call's first tile, writes it back and
pulls the next where the map switches slabs, and writes it back after the
call's last tile (``repro/kernels/fused_sweep/fused_sweep.py:575-592,
:653``).  A slab is clamped to the shard's ``I_max`` rows, so the last,
partial one never reaches the next worker's rows.  The chain is the
unpaged one; what the paging adds is the order of the copies, which the
kernel repeats, and a check that every valid token addresses its tile's
slab.

Per valid token, in the reference's order (``ref.py:52-114``): rebuild the
F+tree at a word boundary, decrement, ``set_leaf``, compact the doc row
(or update the side table), r-cumsum, ``norm``, draw from the r bucket or
the q tree, increment, ``set_leaf``.  A masked token still rebuilds at a
boundary; everything else it does is a no-op, so steps where no stream
has a valid or boundary token are skipped.

Rounding: every op rounds to f32 where the reference does under ``jit``.
XLA CPU computes ``norm = α·q_total + r_mass`` twice, in two fusions, and
contracts it in one of them only:

* the r side, ``u_val = u01·fma(α, q_total, r_mass)``, which ``in_r`` and
  the r-bucket pick read;
* the q side, ``x = fma(u01, α·q_total + r_mass, −r_mass) / max(α·q_total,
  1e-30)``, with the norm and ``α·q_total`` rounded as written and the
  ``u01·norm − r_mass`` contracted.

The other products round first: ``counts·q`` before the cumsum and
``u01·F[1]`` in the tree walk.  ``tests/test_torch_fused_sweep.py`` pins
each of these four sites with a token whose draw flips with the rounding.
"""
from __future__ import annotations

import torch

from repro_torch.core import ftree
from repro_torch.kernels.fused_sweep import rbucket
from repro_torch.kernels.fused_sweep.fused_sweep import N_BLK, slab_of_tokens
from repro_torch.numerics import fma

__all__ = ["sweep_streams_ref", "fused_sweep_ref", "fused_sweep_cells_ref",
           "fused_sweep_ragged_ref", "Q_FLOOR", "U_MAX"]

F32 = torch.float32
#: ``jnp.maximum(α·q_total, 1e-30)`` and ``jnp.clip(…, 0, 1 - 1e-7)`` in f32.
Q_FLOOR = torch.tensor(1e-30, dtype=F32).item()
U_MAX = torch.tensor(1.0 - 1e-7, dtype=F32).item()


def _f32(x, dev):
    return torch.tensor(float(x), dtype=F32, device=dev)


def _q(nwt, nt, beta, beta_bar):
    """``q = (n_wt + β) / (n_t + β̄)`` in f32."""
    return (nwt.to(F32) + beta) / (nt.to(F32) + beta_bar)


def _slabs(n_td, W, I_max, doc_rows):
    """Pull/write-back of one stream's slab: rows ``[g·doc_rows,
    min((g+1)·doc_rows, I_max))`` of worker ``b``'s shard in ``n_td``
    ``(W·I_max, T)`` against its buffer ``slab[b]``."""
    T = n_td.shape[-1]
    slab = torch.zeros((W, doc_rows, T), dtype=n_td.dtype,
                       device=n_td.device)

    def rows(b, g):
        lo = b * I_max + g * doc_rows
        n = max(min(doc_rows, I_max - g * doc_rows), 0)
        return lo, n

    def pull(b, g):
        lo, n = rows(b, g)
        slab[b, :n] = n_td[lo:lo + n]

    def write_back(b, g):
        lo, n = rows(b, g)
        n_td[lo:lo + n] = slab[b, :n]

    return slab, pull, write_back


def sweep_streams_ref(tok_doc, tok_wrd, tok_valid, tok_bound, z, u, cot,
                      n_td, n_wt, n_t, *, r: int, k: int, tile: int,
                      tile_start: int, num_tiles: int, I_max: int,
                      J_max: int, alpha: float, beta: float,
                      beta_bar: float, cap: int, topics=None, counts=None,
                      dto=None, dtile: int = 0, doc_rows: int = 0
                      ) -> torch.Tensor:
    """One sweep of tiles ``[tile_start, tile_start + num_tiles)`` over W
    streams; updates ``z``, the tables, ``n_t`` and the side tables in
    place and returns the final F+trees ``(W, 2T)``.

    Stream ``b`` of round ``r`` is chunk ``c = (b + r) % C`` of the
    ``(W, C, S)`` token arrays (``C`` = 1 for a single stream).  Its token
    at stream position ``p`` addresses doc row ``b·I_max + tok_doc`` of
    ``n_td`` ``(W·I_max, T)`` and word row ``(c·k + cot[b, c, p // tile])
    ·J_max + tok_wrd`` of ``n_wt`` ``(B·J_max, T)``; ``n_t`` ``(W, T)``
    holds each stream's own copy, ``u`` ``(W, S)`` its uniforms.  The side
    tables (sparse r-mode) are ``(W·I_max, cap)``, indexed like ``n_td``.

    ``dto`` ``(W, C, n_dt)`` with ``dtile`` and ``doc_rows`` pages
    ``n_td``: position ``p`` of a stream lies in slab ``dto[b, c, p //
    dtile]``, rows ``[g·doc_rows, (g+1)·doc_rows)`` of its worker's shard
    (module docstring).  The side tables are never paged.  Raises
    ``ValueError`` where ``fused_sweep.slab_of_tokens`` does: a map entry
    outside the shard, or a valid token outside its slab.
    """
    W, C, S = tok_doc.shape
    T = n_t.shape[-1]
    dev = n_t.device
    sparse = topics is not None
    b = torch.arange(W, device=dev)
    c = (b + r) % C
    lo, hi = tile_start * tile, (tile_start + num_tiles) * tile
    take = lambda a: a[b, c, lo:hi]
    cells = cot[b, c, tile_start:tile_start + num_tiles].long()
    cell_tok = cells.repeat_interleave(tile, dim=1)
    doc = b[:, None] * I_max + take(tok_doc).long()
    wrd = ((c * k)[:, None] + cell_tok) * J_max + take(tok_wrd).long()
    valid = take(tok_valid) != 0
    bound = take(tok_bound) != 0
    zs = take(z).long()
    us = u[:, lo:hi]
    a32, b32, bb32 = (_f32(x, dev) for x in (alpha, beta, beta_bar))
    F = torch.zeros((W, 2 * T), dtype=F32, device=dev)
    paged = dto is not None and hi > lo
    table, rows, switches = n_td, doc, {}
    if paged:
        g, off = slab_of_tokens(tok_doc, tok_valid, dto, r=r, dtile=dtile,
                                doc_rows=doc_rows, I_max=I_max, lo=lo, hi=hi)
        slab, pull, write_back = _slabs(n_td, W, I_max, doc_rows)
        table = slab.view(W * doc_rows, T)
        rows = b[:, None] * doc_rows + torch.where(valid, off, 0)
        g_host = g.cpu()
        cur = g_host[:, 0].tolist()
        for s in range(W):
            pull(s, cur[s])
        flips = (g_host[:, 1:] != g_host[:, :-1]).nonzero().tolist()
        for s, p in flips:
            switches.setdefault(p + 1, []).append(s)
    active = (valid | bound).any(0)
    if switches:
        active[list(switches)] = True
    steps = torch.nonzero(active).flatten().tolist()
    for p in steps:
        for s in switches.get(p, ()):                      # slab switch
            write_back(s, cur[s])
            cur[s] = int(g_host[s, p])
            pull(s, cur[s])
        d, w, v, t_old = rows[:, p], wrd[:, p], valid[:, p], zs[:, p]
        if bound[:, p].any():
            rb = bound[:, p]
            F[rb] = ftree.build(_q(n_wt[w[rb]], n_t[rb], b32, bb32))
        if not v.any():
            continue
        one = v.to(torch.int32)

        table[d, t_old] -= one
        n_wt[w, t_old] -= one
        n_t[b, t_old] -= one
        leaf = _q(n_wt[w, t_old], n_t[b, t_old], b32, bb32)
        F = ftree.set_leaf(F, t_old, torch.where(v, leaf, F[b, T + t_old]))

        if sparse:
            dg = doc[:, p]
            tpc, cnt = rbucket.decrement(topics[dg], counts[dg], t_old, v)
        else:
            tpc, cnt = rbucket.compact_row(table[d], cap)
        cs = rbucket.r_cumsum(tpc, cnt, ftree.leaves(F))
        r_mass = cs[:, -1]
        q_total = ftree.total(F)
        aq = a32 * q_total
        u01 = us[:, p]
        u_val = u01 * fma(a32, q_total, r_mass)
        in_r = u_val < r_mass
        t_r = rbucket.pick(tpc, cnt, cs, u_val)
        x = fma(u01, aq + r_mass, -r_mass) / torch.clamp(aq, min=Q_FLOOR)
        t_q = ftree.sample(F, x.clamp(0.0, U_MAX))
        t_new = torch.where(v, torch.where(in_r, t_r, t_q), t_old)

        table[d, t_new] += one
        n_wt[w, t_new] += one
        n_t[b, t_new] += one
        leaf = _q(n_wt[w, t_new], n_t[b, t_new], b32, bb32)
        F = ftree.set_leaf(F, t_new, torch.where(v, leaf, F[b, T + t_new]))
        zs[:, p] = t_new
        if sparse:
            tpc, cnt = rbucket.increment(tpc, cnt, t_new, v)
            topics[dg], counts[dg] = tpc, cnt
    if paged:                                              # the flush
        for s in range(W):
            write_back(s, cur[s])
    z[b, c, lo:hi] = zs.to(z.dtype)
    return F


def _one_stream(tok_doc, tok_wrd, tok_valid, tok_bound, z, u, cot, n_td,
                n_wt, n_t, *, tile, k, alpha, beta, beta_bar, cap, topics,
                counts, sweep, dto=None, dtile=0, doc_rows=0):
    """A single stream through ``sweep`` (the plain version or the
    kernel): copies the inputs, returns ``(z', n_td', n_wt', n_t', F)``
    plus the side tables when given.  ``dto`` (one entry per ``dtile``
    tokens) pages ``n_td`` in slabs of ``doc_rows`` rows."""
    I, T = n_td.shape
    J = n_wt.shape[-2]
    S = tok_doc.shape[0]
    i32 = lambda a: a.to(torch.int32).reshape(1, 1, -1).contiguous()
    z_out = i32(z).clone()
    n_td, n_wt, n_t = (x.to(torch.int32).clone() for x in (n_td, n_wt, n_t))
    shape_wt = n_wt.shape
    tables = ()
    if topics is not None:
        topics = topics.to(torch.int32).clone()
        counts = counts.to(torch.int32).clone()
        tables = (topics, counts)
    paging = {}
    if dto is not None:
        paging = dict(dto=i32(dto), dtile=dtile, doc_rows=doc_rows)
    nt = n_t.reshape(1, T)
    F = sweep(i32(tok_doc), i32(tok_wrd), i32(tok_valid), i32(tok_bound),
              z_out, u.to(F32).reshape(1, S).contiguous(), i32(cot),
              n_td, n_wt.reshape(-1, T), nt, r=0, k=k, tile=tile,
              tile_start=0, num_tiles=cot.numel(), I_max=I, J_max=J,
              alpha=alpha, beta=beta, beta_bar=beta_bar, cap=cap,
              topics=topics, counts=counts, **paging)
    return (z_out.reshape(S), n_td, n_wt.reshape(shape_wt), nt.reshape(T),
            F[0]) + tables


def _rmode(r_mode, r_cap, T, topics, counts, n_td):
    """``(cap, topics, counts)``: the capacity and, in sparse r-mode, the
    side tables (built from ``n_td`` when not given)."""
    if r_mode not in ("dense", "sparse"):
        raise ValueError(f"r_mode must be 'dense' or 'sparse', got "
                         f"{r_mode!r}")
    cap = T if r_cap is None else int(r_cap)
    if not 1 <= cap <= T:
        raise ValueError(f"r_cap must be in [1, T={T}], got {cap}")
    if r_mode == "dense":
        if topics is not None or counts is not None:
            raise ValueError("topics/counts side tables passed with "
                             "r_mode='dense'")
        return cap, None, None
    if topics is None:
        return (cap, *rbucket.build_side_table(n_td.to(torch.int32), cap))
    return cap, topics, counts


def _check_doc_args(doc_tile_of, doc_rows: int, shape) -> None:
    """Doc tiling needs both the map and ``doc_rows > 0``, and the map
    must have the token-tile grid's ``shape`` (``ops.py:64``)."""
    if (doc_tile_of is None) != (doc_rows <= 0):
        raise ValueError(
            f"doc tiling needs both doc_tile_of and doc_rows > 0 (got "
            f"doc_rows={doc_rows}, doc_tile_of="
            f"{'set' if doc_tile_of is not None else None})")
    if doc_tile_of is not None and tuple(doc_tile_of.shape) != tuple(shape):
        raise ValueError(f"doc_tile_of shape {tuple(doc_tile_of.shape)} "
                         f"does not match the {tuple(shape)} token-tile "
                         f"grid")


def _whole_tiles(n: int, n_blk: int, what: str) -> None:
    if n % n_blk:
        raise ValueError(f"doc-tiled {what} of {n} tokens are not a whole "
                         f"number of {n_blk}-token tiles (the slab map is "
                         f"per tile)")


def fused_sweep_ref(tok_doc, tok_wrd, tok_valid, tok_bound, z, u, n_td,
                    n_wt, n_t, *, alpha, beta, beta_bar, doc_tile_of=None,
                    doc_rows=0, r_mode="dense", r_cap=None, topics=None,
                    counts=None, n_blk=N_BLK, sweep=sweep_streams_ref):
    """One sweep over one token stream (N,) against one ``(J, T)`` block:
    ``(z', n_td', n_wt', n_t', F)``, plus ``(topics, counts)`` in sparse
    r-mode.  The inputs are not changed.  ``doc_tile_of`` ``(N //
    n_blk,)`` and ``doc_rows`` page ``n_td`` in slabs (the stream must be
    whole ``n_blk`` tiles, each inside one slab).  ``sweep`` runs the
    streams: the plain version here, the device dispatch in ``ops``."""
    T = n_t.shape[-1]
    cap, topics, counts = _rmode(r_mode, r_cap, T, topics, counts, n_td)
    tables = (topics, counts) if topics is not None else ()
    n = tok_doc.shape[0]
    if n == 0:
        return (z, n_td, n_wt, n_t,
                torch.zeros(2 * T, dtype=F32, device=n_t.device)) + tables
    docs = doc_tile_of is not None
    if docs:
        _whole_tiles(n, n_blk, "streams")
    _check_doc_args(doc_tile_of, doc_rows, (n // n_blk,) if docs else None)
    cot = torch.zeros(1, dtype=torch.int32, device=n_t.device)
    return _one_stream(tok_doc, tok_wrd, tok_valid, tok_bound, z, u, cot,
                       n_td, n_wt, n_t, tile=n, k=1, alpha=alpha, beta=beta,
                       beta_bar=beta_bar, cap=cap, topics=topics,
                       counts=counts, sweep=sweep, dto=doc_tile_of,
                       dtile=n_blk, doc_rows=doc_rows)


def fused_sweep_cells_ref(tok_doc, tok_wrd, tok_valid, tok_bound, z, u,
                          n_td, n_wt, n_t, *, alpha, beta, beta_bar,
                          cell_start=0, num_cells=None, doc_tile_of=None,
                          doc_rows=0, r_mode="dense", r_cap=None,
                          topics=None, counts=None, n_blk=N_BLK,
                          sweep=sweep_streams_ref):
    """One sweep over a queue of ``k`` dense cells (a nomad block queue):
    tok_* ``(k, L)``, ``n_wt`` ``(k, J, T)``, one block per cell; the
    cells run in order with ``n_td``, ``n_t`` and the F+tree carried
    (``repro/kernels/fused_sweep/ref.py:118``).  The queue is one stream of
    ``k·L`` slots whose tile of ``L`` slots is a cell.  ``cell_start``/
    ``num_cells`` select a sub-queue (the pipelined ring's halves); the
    returned ``z'``/``n_wt'`` cover only it.  ``doc_tile_of`` ``(k, L //
    n_blk)`` and ``doc_rows`` page ``n_td``.  ``sweep`` as in
    :func:`fused_sweep_ref`."""
    k_total, J, T = n_wt.shape
    cap, topics, counts = _rmode(r_mode, r_cap, T, topics, counts, n_td)
    tables = (topics, counts) if topics is not None else ()
    if tok_doc.shape[0] != k_total:
        raise ValueError(f"queue length mismatch: tokens have "
                         f"{tok_doc.shape[0]} cells, n_wt has {k_total} "
                         f"blocks")
    L = tok_doc.shape[1]
    docs = doc_tile_of is not None
    if docs:
        _whole_tiles(L, n_blk, "cell rows")
    _check_doc_args(doc_tile_of, doc_rows,
                   (k_total, L // n_blk) if docs else None)
    nc = k_total - cell_start if num_cells is None else int(num_cells)
    if cell_start < 0 or nc < 0 or cell_start + nc > k_total:
        raise ValueError(f"cell range [{cell_start}, {cell_start + nc}) "
                         f"outside the {k_total}-cell queue")
    sub = lambda a: a[cell_start:cell_start + nc]
    if nc == 0 or L == 0:
        return (sub(z), n_td, sub(n_wt), n_t,
                torch.zeros(2 * T, dtype=F32, device=n_t.device)) + tables
    flat = lambda a: sub(a).reshape(-1)
    cot = torch.arange(nc, dtype=torch.int32, device=n_t.device)
    out = _one_stream(flat(tok_doc), flat(tok_wrd), flat(tok_valid),
                      flat(tok_bound), flat(z), flat(u), cot, n_td,
                      sub(n_wt), n_t, tile=L, k=nc, alpha=alpha, beta=beta,
                      beta_bar=beta_bar, cap=cap, topics=topics,
                      counts=counts, sweep=sweep,
                      dto=flat(doc_tile_of) if docs else None, dtile=n_blk,
                      doc_rows=doc_rows)
    return (out[0].reshape(nc, L),) + out[1:]


def fused_sweep_ragged_ref(tok_doc, tok_wrd, tok_valid, tok_bound, z, u,
                           cell_of_tile, n_td, n_wt, n_t, *, alpha, beta,
                           beta_bar, n_blk, tile_start=0, num_tiles=None,
                           cell_start=0, num_cells=None, doc_tile_of=None,
                           doc_rows=0, r_mode="dense", r_cap=None,
                           topics=None, counts=None,
                           sweep=sweep_streams_ref):
    """One sweep over one ragged cell stream (a nomad queue): tok_* (S,),
    ``cell_of_tile`` (S // n_blk,) non-decreasing, ``n_wt`` (k, J, T).
    Tiles ``[tile_start, +num_tiles)`` and cells ``[cell_start,
    +num_cells)`` select a sub-range (the pipelined ring's half-queues);
    the returned ``z'``/``n_wt'`` cover only it.  ``doc_tile_of`` (S //
    n_blk,), sliced with the tiles, and ``doc_rows`` page ``n_td``.
    ``sweep`` as in :func:`fused_sweep_ref`."""
    k_total, J, T = n_wt.shape
    cap, topics, counts = _rmode(r_mode, r_cap, T, topics, counts, n_td)
    tables = (topics, counts) if topics is not None else ()
    S = tok_doc.shape[0]
    n_tiles = cell_of_tile.shape[0]
    if S % n_blk != 0 or n_tiles != S // n_blk:
        raise ValueError(f"ragged stream length {S} does not tile into "
                         f"{n_tiles} tiles of {n_blk}")
    docs = doc_tile_of is not None
    _check_doc_args(doc_tile_of, doc_rows, (n_tiles,) if docs else None)
    nt_ = n_tiles - tile_start if num_tiles is None else int(num_tiles)
    nc = k_total - cell_start if num_cells is None else int(num_cells)
    if tile_start < 0 or nt_ < 0 or tile_start + nt_ > n_tiles:
        raise ValueError(f"tile range [{tile_start}, {tile_start + nt_}) "
                         f"outside the {n_tiles}-tile stream")
    if cell_start < 0 or nc < 0 or cell_start + nc > k_total:
        raise ValueError(f"cell range [{cell_start}, {cell_start + nc}) "
                         f"outside the {k_total}-cell queue")
    lo, hi = tile_start * n_blk, (tile_start + nt_) * n_blk
    nwt_sub = n_wt[cell_start:cell_start + nc]
    if nt_ == 0 or nc == 0:
        return (z[lo:hi], n_td, nwt_sub, n_t,
                torch.zeros(2 * T, dtype=F32, device=n_t.device)) + tables
    cot = cell_of_tile[tile_start:tile_start + nt_] - cell_start
    dto = doc_tile_of[tile_start:tile_start + nt_] if docs else None
    sub = lambda a: a[lo:hi]
    return _one_stream(sub(tok_doc), sub(tok_wrd), sub(tok_valid),
                       sub(tok_bound), sub(z), sub(u), cot, n_td, nwt_sub,
                       n_t, tile=n_blk, k=nc, alpha=alpha, beta=beta,
                       beta_bar=beta_bar, cap=cap, topics=topics,
                       counts=counts, sweep=sweep, dto=dto, dtile=n_blk,
                       doc_rows=doc_rows)
