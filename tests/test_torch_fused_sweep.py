"""The port's chain oracle (``repro_torch/kernels/fused_sweep/ref.py``) and
its ops, against the JAX oracle (``fused_sweep_ref`` under ``jit``) and
the JAX kernels (``fused_sweep_pallas``/``fused_sweep_ragged_pallas`` in
interpret mode): the same inputs, made with numpy from a seed, give the
same ``z``, tables, ``n_t``, F+tree and side tables, bit for bit.  On the
CPU the ops run the plain version, so these pin the arithmetic the CUDA
kernel repeats on the card (``tests/test_torch_gpu.py``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic
from repro.data.sharding import build_layout
from repro.kernels.fused_sweep import ops as jops
from repro.kernels.fused_sweep.ref import (fused_sweep_ragged_ref as
                                           j_ragged_ref)
from repro.kernels.fused_sweep.ref import fused_sweep_ref as j_ref
from repro_torch.kernels.fused_sweep import fused_sweep as fs_mod
from repro_torch.kernels.fused_sweep import ops
from repro_torch.kernels.fused_sweep.ref import (fused_sweep_ragged_ref,
                                                 fused_sweep_ref)
from torch_fold_in_cases import (BIG_FLIP_CASES, FLIP_CASES, big_flip_case,
                                 flip_draw, flip_inputs)


def _stream(T, I, J, N, seed, masked=0.1):
    """A word-sorted stream with consistent counts plus background mass,
    some masked tokens, and one masked word-boundary token."""
    r = np.random.default_rng(seed)
    doc = r.integers(0, I, N).astype(np.int32)
    wrd = np.sort(r.integers(0, J, N)).astype(np.int32)
    z = r.integers(0, T, N).astype(np.int32)
    valid = (r.random(N) > masked).astype(np.int32)
    bound = np.concatenate([[1], wrd[1:] != wrd[:-1]]).astype(np.int32)
    valid[np.nonzero(bound)[0][1]] = 0
    n_td = np.zeros((I, T), np.int32)
    np.add.at(n_td, (doc, z), valid)
    n_wt = r.integers(0, 3, (J, T)).astype(np.int32)
    np.add.at(n_wt, (wrd, z), valid)
    n_t = (n_wt.sum(0) + r.integers(0, 50, T)).astype(np.int32)
    u = r.random(N).astype(np.float32)
    return doc, wrd, valid, bound, z, u, n_td, n_wt, n_t


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@functools.lru_cache(maxsize=None)
def _jit_ref(**kw):
    return jax.jit(functools.partial(j_ref, **kw))


@pytest.mark.parametrize("T,r_mode,r_cap,seed", [
    (8, "dense", None, 0), (8, "sparse", None, 1), (16, "dense", 5, 2),
    (16, "sparse", 6, 3), (64, "dense", None, 4), (64, "sparse", 11, 5),
    (2048, "dense", None, 0), (2048, "sparse", 37, 1), (2048, "dense", 37, 2),
    (4096, "dense", None, 3), (4096, "sparse", None, 4),
    (4096, "sparse", 37, 5), (16384, "dense", None, 6),
    (65536, "dense", None, 7), (131072, "sparse", None, 8),
    (262144, "dense", None, 9)])
def test_oracle_matches_jax_oracle(T, r_mode, r_cap, seed):
    """Above 1024 topics the F+tree's root is summed over more than one
    level of runs; from 16,384 on (the card kernel's spilled layouts, up
    to its largest T, 262,144, where the root sums 8,192, 256 and 8 run
    totals) on a shorter stream."""
    n = 260 if T <= 4096 else 60
    args = _stream(T, I=15, J=25, N=n, seed=seed)
    kw = dict(alpha=50.0 / T, beta=0.01, beta_bar=0.01 * 25, r_mode=r_mode,
              r_cap=r_cap)
    want = _jit_ref(**kw)(*map(jnp.asarray, args))
    _same(fused_sweep_ref(*map(torch.as_tensor, args), **kw), want)
    _same(ops.fused_sweep_tokens(*map(torch.as_tensor, args), **kw), want)


@pytest.mark.parametrize("r_mode,r_cap", [("dense", None), ("sparse", 7)])
def test_ops_match_jax_kernel_in_interpret_mode(r_mode, r_cap):
    T = 16
    args = _stream(T, I=9, J=12, N=70, seed=7)
    kw = dict(alpha=50.0 / T, beta=0.01, beta_bar=0.12, r_mode=r_mode,
              r_cap=r_cap)
    want = jops.fused_sweep_tokens(*map(jnp.asarray, args), n_blk=32,
                                   interpret=True, **kw)
    _same(ops.fused_sweep_tokens(*map(torch.as_tensor, args), **kw), want)


@pytest.mark.parametrize("r_mode", ["dense", "sparse"])
def test_one_topic_matches_jax_kernel_in_interpret_mode(r_mode):
    """T = 1, a power of two the reference's guard takes: a two-entry
    F+tree whose leaf is its root, every token drawn to topic 0; the
    port's op against the JAX kernel in interpret mode, bit for bit."""
    args = _stream(1, I=5, J=6, N=40, seed=3)
    kw = dict(alpha=0.5, beta=0.01, beta_bar=0.06, r_mode=r_mode)
    want = jops.fused_sweep_tokens(*map(jnp.asarray, args), n_blk=32,
                                   interpret=True, **kw)
    got = ops.fused_sweep_tokens(*map(torch.as_tensor, args), **kw)
    _same(got, want)
    assert not got[0].any()


def test_card_kernel_takes_every_power_of_two_the_reference_takes():
    """``check_topics`` (the refusals of ``check_fits``, read without the
    built library): every power of two from 1 to MAX_TOPICS = 262,144,
    the largest the reference's ``fused_vmem_bytes`` admits in one cell;
    524,288, a T that is not a power of two and T = 0 are refused, by
    ``check_fits`` too, before it reads the library."""
    assert fs_mod.MAX_TOPICS == 262_144
    cell = dict(I=1, J=1, doc_rows=1)
    assert jops.fused_vmem_bytes(T=262_144, **cell) \
        <= jops.VMEM_BUDGET_BYTES < jops.fused_vmem_bytes(T=524_288, **cell)
    for k in range(19):
        fs_mod.check_topics(1 << k, 1 << k)
        fs_mod.check_topics(1 << k, 1, 3)
    for T in (0, 3, 48, 1 << 19, 1 << 20):
        for check in (fs_mod.check_topics, fs_mod.check_fits):
            with pytest.raises(ValueError, match="power-of-two T"):
                check(T, 1)
    with pytest.raises(ValueError, match="r_cap"):
        fs_mod.check_topics(1 << 18, (1 << 18) + 1)
    with pytest.raises(ValueError, match="doc_rows"):
        fs_mod.check_topics(64, 64, -1)


def _ragged_setup(T=16, B=4, seed=11, tile=None, doc_tile=None):
    corpus, _, _ = synthetic.make_corpus(
        num_docs=18, vocab_size=60, num_topics=8, mean_doc_len=12.0,
        seed=seed)
    rag = build_layout(corpus, n_workers=1, T=T, n_blocks=B,
                       layout="ragged", tile=tile, doc_tile=doc_tile)
    r = np.random.default_rng(seed)
    N = corpus.num_tokens
    z_c = r.integers(0, T, N).astype(np.int32)
    u_c = r.random(N).astype(np.float32)
    n_td = np.zeros((rag.I_max, T), np.int32)
    n_wt = np.zeros((B, rag.J_max, T), np.int32)
    _, b_i, d_i, j_i = rag.token_coords()
    np.add.at(n_td, (d_i, z_c), 1)
    np.add.at(n_wt, (b_i, j_i, z_c), 1)
    n_t = np.bincount(z_c, minlength=T).astype(np.int32)
    sel = lambda a: np.asarray(a[0, 0], np.int32)
    toks = (sel(rag.tok_doc), sel(rag.tok_wrd), sel(rag.tok_valid),
            sel(rag.tok_bound), sel(rag.place_canonical(z_c)),
            rag.place_canonical(u_c)[0, 0])
    return rag, toks, sel(rag.cell_of_tile), (n_td, n_wt, n_t)


@pytest.mark.parametrize("r_mode,r_cap,tile", [
    ("dense", None, None), ("sparse", None, None), ("dense", 6, 8),
    ("sparse", 6, 8)])
def test_ragged_matches_jax_oracle_and_kernel(r_mode, r_cap, tile):
    T = 16
    rag, toks, cot, counts = _ragged_setup(T=T, tile=tile)
    kw = dict(alpha=50.0 / T, beta=0.01, beta_bar=0.6, n_blk=rag.tile,
              r_mode=r_mode, r_cap=r_cap)
    j_args = (*map(jnp.asarray, toks), jnp.asarray(cot),
              *map(jnp.asarray, counts))
    p_args = (*map(torch.as_tensor, toks), torch.as_tensor(cot),
              *map(torch.as_tensor, counts))
    want = j_ragged_ref(*j_args, **kw)
    _same(fused_sweep_ragged_ref(*p_args, **kw), want)
    _same(ops.fused_sweep_ragged(*p_args, **kw), want)
    if tile is None:
        _same(ops.fused_sweep_ragged(*p_args, **kw),
              jops.fused_sweep_ragged(*j_args, interpret=True, **kw))


@pytest.mark.parametrize("r_mode", ["dense", "sparse"])
def test_ragged_tile_sub_ranges_match_jax(r_mode):
    """The pipelined ring's halves: tiles [0, tile_split) over cells
    [0, k0), then the rest, against the JAX kernel's same two calls."""
    T = 16
    rag, toks, cot, counts = _ragged_setup(T=T, B=4, seed=12)
    kw = dict(alpha=50.0 / T, beta=0.01, beta_bar=0.6, n_blk=rag.tile,
              r_mode=r_mode)
    r0, k0 = rag.tile_split, 2
    assert 0 < r0 < rag.n_tiles
    j_args = [*map(jnp.asarray, toks), jnp.asarray(cot),
              *map(jnp.asarray, counts)]
    p_args = [*map(torch.as_tensor, toks), torch.as_tensor(cot),
              *map(torch.as_tensor, counts)]
    halves = (dict(tile_start=0, num_tiles=r0, cell_start=0, num_cells=k0),
              dict(tile_start=r0, cell_start=k0))
    outs = {}
    for name, fn, args in (("jax", jops.fused_sweep_ragged, j_args),
                           ("port", ops.fused_sweep_ragged, p_args)):
        extra = dict(interpret=True) if name == "jax" else {}
        first = fn(*args, **halves[0], **kw, **extra)
        tables = (dict(topics=first[5], counts=first[6])
                  if r_mode == "sparse" else {})
        second = fn(*args[:7], first[1], args[8], first[3],
                    **halves[1], **kw, **tables, **extra)
        outs[name] = (first, second)
    for f_p, f_j in zip(outs["port"], outs["jax"]):
        _same(f_p, f_j)


@pytest.mark.parametrize("key", sorted(FLIP_CASES) + sorted(BIG_FLIP_CASES))
def test_contraction_site_flip(key):
    """One token whose draw depends on how one product is rounded: the
    port draws the reference's topic, the other rounding another one; at
    T = 8, and at T = 2048 and 4096 with the root's order as one more
    site."""
    site = key if isinstance(key, str) else key[1]
    case = FLIP_CASES[key] if isinstance(key, str) else big_flip_case(key)
    args, kw = flip_inputs(case)
    j_args = [jnp.asarray(a.numpy()) for a in args]
    ref_z = int(_jit_ref(**kw)(*j_args)[0][0])
    kernel_z = int(jops.fused_sweep_tokens(*j_args, interpret=True,
                                           **kw)[0][0])
    assert ref_z == kernel_z == case["want"]
    assert int(fused_sweep_ref(*args, **kw)[0][0]) == case["want"]
    assert flip_draw(case) == case["want"]
    assert flip_draw(case, site) != case["want"]


def test_masked_boundary_token_still_rebuilds_the_tree():
    """A masked token with ``tok_bound`` set rebuilds the F+tree from its
    own word's row; the valid token after it (same word, no boundary)
    draws against that tree.  Skipping the masked token would leave the
    tree of the previous word."""
    T = 8
    doc = np.zeros(3, np.int32)
    wrd = np.array([0, 1, 1], np.int32)
    valid = np.array([1, 0, 1], np.int32)
    bound = np.array([1, 1, 0], np.int32)
    z = np.array([2, 5, 3], np.int32)
    u = np.array([0.3, 0.9, 0.7], np.float32)
    n_td = np.zeros((1, T), np.int32)
    np.add.at(n_td[0], z[valid == 1], 1)
    n_wt = np.ones((2, T), np.int32)
    n_wt[1, 6] = 40                               # word 1 favours topic 6
    n_wt[0, 2] += 1
    n_wt[1, 3] += 1
    n_t = n_wt.sum(0).astype(np.int32)
    args = (doc, wrd, valid, bound, z, u, n_td, n_wt, n_t)
    kw = dict(alpha=2.0, beta=0.01, beta_bar=0.02)
    want = _jit_ref(**kw)(*map(jnp.asarray, args))
    got = fused_sweep_ref(*map(torch.as_tensor, args), **kw)
    _same(got, want)
    assert int(got[0][1]) == 5                    # the masked token kept z
    bound_off = bound.copy()
    bound_off[1] = 0
    skipped = fused_sweep_ref(*map(torch.as_tensor, (*args[:3], bound_off,
                                                     *args[4:])), **kw)
    assert not torch.equal(skipped[4], got[4])


def test_set_leaf_adds_the_difference_down_the_path():
    """``set_leaf`` adds ``value - leaf`` to the leaf and each ancestor; in
    f32 the leaf can end one rounding away from ``value``, and the port
    keeps that, as the reference does."""
    from repro.core import ftree as jft
    from repro_torch.core import ftree
    r = np.random.default_rng(0)
    for _ in range(200):
        p = (r.random(8) * 10.0 ** r.integers(-8, 4, 8)).astype(np.float32)
        t = int(r.integers(0, 8))
        v = np.float32(r.random() * 10.0 ** r.integers(-8, 4))
        got = ftree.set_leaf(ftree.build(torch.as_tensor(p)),
                             torch.tensor(t), torch.tensor(v))
        want = jax.jit(jft.set_leaf)(jax.jit(jft.build)(jnp.asarray(p)),
                                     t, v)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if got[8 + t] != v:
            break
    else:
        pytest.fail("no case where the leaf ends unequal to its value")
    assert got[8 + t] != v
    assert got[8 + t] == np.float32(p[t] + np.float32(v - p[t]))


# -- the dense cell grid and doc-tile paging ---------------------------------
def _grid_setup(T=16, B=4, seed=17, doc_tile=None, doc_blk=None):
    """Worker 0's dense ``(B, L)`` cell rows of a one-worker layout, the
    uniforms and consistent counts; with ``doc_tile`` the grouped grid."""
    corpus, _, _ = synthetic.make_corpus(
        num_docs=18, vocab_size=60, num_topics=8, mean_doc_len=12.0,
        seed=seed)
    kw = dict(doc_tile=doc_tile, doc_blk=doc_blk) if doc_tile else {}
    lay = build_layout(corpus, n_workers=1, T=T, n_blocks=B, **kw)
    r = np.random.default_rng(seed)
    N = corpus.num_tokens
    z_c = r.integers(0, T, N).astype(np.int32)
    u_c = r.random(N).astype(np.float32)
    n_td = np.zeros((lay.I_max, T), np.int32)
    n_wt = np.zeros((B, lay.J_max, T), np.int32)
    _, b_i, d_i, j_i = lay.token_coords()
    np.add.at(n_td, (d_i, z_c), 1)
    np.add.at(n_wt, (b_i, j_i, z_c), 1)
    n_t = np.bincount(z_c, minlength=T).astype(np.int32)
    sel = lambda a: np.asarray(a[0], np.int32)
    toks = (sel(lay.tok_doc), sel(lay.tok_wrd), sel(lay.tok_valid),
            sel(lay.tok_bound), sel(lay.place_canonical(z_c)),
            lay.place_canonical(u_c)[0])
    return lay, toks, (n_td, n_wt, n_t)


def _halves(fn, args, halves, r_mode, kw, table_at=8):
    """Two sub-range calls chained as the pipelined ring chains them: the
    second starts from the first's ``n_td``, ``n_t`` and side tables."""
    first = fn(*args, **halves[0], **kw)
    tables = (dict(topics=first[5], counts=first[6])
              if r_mode == "sparse" else {})
    rest = list(args)
    rest[table_at - 2], rest[table_at] = first[1], first[3]
    second = fn(*rest, **halves[1], **kw, **tables)
    return first, second


@pytest.mark.parametrize("r_mode,r_cap", [("dense", None), ("sparse", 5)])
def test_cells_match_jax_oracle_and_kernel(r_mode, r_cap):
    """``fused_sweep_cells`` over a four-cell queue, whole and as the
    pipelined ring's two sub-queues, against the JAX oracle
    ``fused_sweep_cells_ref`` and the JAX kernel in interpret mode."""
    from repro.kernels.fused_sweep.ref import fused_sweep_cells_ref as jcr
    from repro_torch.kernels.fused_sweep.ref import fused_sweep_cells_ref
    T = 16
    lay, toks, counts = _grid_setup(T=T)
    kw = dict(alpha=50.0 / T, beta=0.01, beta_bar=0.6, r_mode=r_mode,
              r_cap=r_cap)
    j_args = [*map(jnp.asarray, toks), *map(jnp.asarray, counts)]
    p_args = [*map(torch.as_tensor, toks), *map(torch.as_tensor, counts)]
    want = jops.fused_sweep_cells(*j_args, n_blk=32, interpret=True, **kw)
    _same(jcr(*j_args, **kw), want)
    _same(fused_sweep_cells_ref(*p_args, **kw), want)
    _same(ops.fused_sweep_cells(*p_args, **kw), want)
    halves = (dict(cell_start=0, num_cells=1), dict(cell_start=1))
    got = _halves(ops.fused_sweep_cells, p_args, halves, r_mode, kw)
    ref = _halves(jcr, j_args, halves, r_mode, kw)
    for g, w in zip(got, ref):
        _same(g, w)
    empty = ops.fused_sweep_cells(*p_args, cell_start=4, **kw)
    assert empty[0].shape == (0, toks[0].shape[1])
    with pytest.raises(ValueError, match="cell range"):
        ops.fused_sweep_cells(*p_args, cell_start=3, num_cells=2, **kw)


def _grouped_ragged(T=16, seed=13, doc_tile=4):
    rag, toks, cot, counts = _ragged_setup(T=T, B=4, seed=seed, tile=8,
                                           doc_tile=doc_tile)
    dto = np.asarray(rag.doc_tile_of[0, 0], np.int32)
    assert rag.I_max % doc_tile != 0            # a partial last slab
    assert (dto[1:] != dto[:-1]).sum() > len(np.unique(dto))  # revisits
    return rag, toks, cot, counts, dto


@pytest.mark.parametrize("r_mode", ["dense", "sparse"])
def test_paged_ragged_matches_jax_unpaged(r_mode):
    """The paged plain version on a grouped ragged stream, whole and in
    the pipelined ring's two halves (each pulls and flushes its own slab),
    against the JAX kernel unpaged on the same stream: the JAX doc-tiled
    kernels do not trace on the installed jax."""
    T = 16
    rag, toks, cot, counts, dto = _grouped_ragged(T=T)
    kw = dict(alpha=50.0 / T, beta=0.01, beta_bar=0.6, n_blk=rag.tile,
              r_mode=r_mode)
    paged = dict(doc_tile_of=torch.as_tensor(dto), doc_rows=rag.doc_tile)
    j_args = [*map(jnp.asarray, toks), jnp.asarray(cot),
              *map(jnp.asarray, counts)]
    p_args = [*map(torch.as_tensor, toks), torch.as_tensor(cot),
              *map(torch.as_tensor, counts)]
    want = jops.fused_sweep_ragged(*j_args, interpret=True, **kw)
    _same(ops.fused_sweep_ragged(*p_args, **kw, **paged), want)
    r0 = rag.tile_split
    halves = (dict(tile_start=0, num_tiles=r0, cell_start=0, num_cells=2),
              dict(tile_start=r0, cell_start=2))
    got = _halves(ops.fused_sweep_ragged, p_args, halves, r_mode,
                  dict(kw, **paged), table_at=9)
    ref = _halves(j_ragged_ref, j_args, halves, r_mode, kw, table_at=9)
    for g, w in zip(got, ref):
        _same(g, w)


@pytest.mark.parametrize("r_mode", ["dense", "sparse"])
def test_paged_cells_and_stream_match_jax_unpaged(r_mode):
    """The grouped dense grid through the paged ``fused_sweep_cells``
    (map per ``doc_blk`` tokens), whole and in halves, and one grouped
    row through the paged ``fused_sweep_tokens``, against the JAX oracles
    unpaged on the same tokens."""
    from repro.kernels.fused_sweep.ref import fused_sweep_cells_ref as jcr
    T = 16
    lay, toks, counts = _grid_setup(T=T, doc_tile=4, doc_blk=8)
    dto = np.asarray(lay.doc_tile_of[0], np.int32)
    assert lay.I_max % 4 != 0
    assert (dto[:, 1:] != dto[:, :-1]).any()
    kw = dict(alpha=50.0 / T, beta=0.01, beta_bar=0.6, r_mode=r_mode)
    paged = dict(doc_tile_of=torch.as_tensor(dto), doc_rows=4,
                 n_blk=lay.doc_blk)
    j_args = [*map(jnp.asarray, toks), *map(jnp.asarray, counts)]
    p_args = [*map(torch.as_tensor, toks), *map(torch.as_tensor, counts)]
    _same(ops.fused_sweep_cells(*p_args, **kw, **paged), jcr(*j_args, **kw))
    halves = (dict(cell_start=0, num_cells=2), dict(cell_start=2))
    got = _halves(ops.fused_sweep_cells, p_args, halves, r_mode,
                  dict(kw, **paged))
    ref = _halves(jcr, j_args, halves, r_mode, kw)
    for g, w in zip(got, ref):
        _same(g, w)
    c = int(np.argmax(toks[2].sum(1)))          # the fullest cell row
    row = lambda a: a[c]
    s_args = [*map(row, p_args[:6]), p_args[6], p_args[7][c], p_args[8]]
    want = _jit_ref(**kw)(*map(row, j_args[:6]), j_args[6], j_args[7][c],
                          j_args[8])
    got = ops.fused_sweep_tokens(*s_args, doc_tile_of=torch.as_tensor(
        dto[c]), doc_rows=4, n_blk=lay.doc_blk, **kw)
    _same(got, want)


def test_paged_plain_version_checks_its_arguments():
    """A map that sends a valid token outside its slab, a half-given
    doc-tiling pair, a map of the wrong shape and a stream that is not
    whole tiles are refused."""
    T = 16
    rag, toks, cot, counts, dto = _grouped_ragged(T=T)
    p_args = [*map(torch.as_tensor, toks), torch.as_tensor(cot),
              *map(torch.as_tensor, counts)]
    kw = dict(alpha=50.0 / T, beta=0.01, beta_bar=0.6, n_blk=rag.tile)
    wrong = torch.as_tensor((dto + 1) % rag.n_doc_tiles)
    with pytest.raises(ValueError, match="outside the slab"):
        ops.fused_sweep_ragged(*p_args, doc_tile_of=wrong,
                               doc_rows=rag.doc_tile, **kw)
    with pytest.raises(ValueError, match="doc tiling"):
        ops.fused_sweep_ragged(*p_args, doc_tile_of=torch.as_tensor(dto),
                               **kw)
    with pytest.raises(ValueError, match="doc tiling"):
        ops.fused_sweep_ragged(*p_args, doc_rows=3, **kw)
    with pytest.raises(ValueError, match="doc_tile_of shape"):
        ops.fused_sweep_ragged(*p_args, doc_tile_of=torch.as_tensor(
            dto[:-1]), doc_rows=3, **kw)
    one = [a[:rag.tile + 1] for a in p_args[:6]] + p_args[7:]
    one[7] = one[7][0]
    with pytest.raises(ValueError, match="whole number"):
        ops.fused_sweep_tokens(*one, doc_tile_of=torch.zeros(
            2, dtype=torch.int32), doc_rows=3, n_blk=rag.tile,
            alpha=1.0, beta=0.01, beta_bar=0.6)


@pytest.mark.parametrize("slab", ["past the last", "negative"])
def test_paged_plain_version_refuses_a_slab_outside_the_shard(slab):
    """A map entry that names no slab of the shard is refused, even on a
    tile without valid tokens: the slab copy would reach another worker's
    rows."""
    T = 16
    rag, toks, cot, counts, dto = _grouped_ragged(T=T)
    p_args = [*map(torch.as_tensor, toks), torch.as_tensor(cot),
              *map(torch.as_tensor, counts)]
    bad = dto.copy()
    bad[-1] = rag.n_doc_tiles if slab == "past the last" else -1
    with pytest.raises(ValueError, match="outside the shard"):
        ops.fused_sweep_ragged(*p_args, doc_tile_of=torch.as_tensor(bad),
                               doc_rows=rag.doc_tile, alpha=50.0 / T,
                               beta=0.01, beta_bar=0.6, n_blk=rag.tile)
