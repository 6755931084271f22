"""The CUDA kernels on the card, against their plain PyTorch versions on
the same inputs: the fold-in kernel, the fused-sweep kernel in its
single-stream, dense cell-grid and ragged nomad-round forms, each unpaged
and with ``n_td`` paged through a shared-memory slab, the ``lda_scores``
kernel in its rows and pass forms (and ``NomadLDA``'s vectorized mode on
it), and the batched F+tree sample and update kernels.  Needs an NVIDIA
GPU (``gpu`` marker; skips without one).  Imports neither ``jax`` nor ``repro``, so it
runs on a machine with PyTorch for CUDA alone:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.core.heldout import doc_fold_key
from repro_torch.core.nomad import NomadLDA
from repro_torch.data.sharding import build_layout, half_queue_split
from repro_torch.data.synthetic import make_corpus
from repro_torch.kernels.fold_in import (fold_in_draws, fold_in_fused,
                                         fold_in_kernel_ref)
from repro_torch.kernels.fold_in import fold_in as fold_in_mod
from repro_torch.kernels.fused_sweep import fused_sweep as fs_mod
from repro_torch.kernels.fused_sweep import ops as fs_ops
from repro_torch.kernels.fused_sweep.ref import (fused_sweep_ref,
                                                 sweep_streams_ref)
from repro_torch.core import ftree
from repro_torch.kernels.ftree_sample import ftree_sample, ftree_sample_ref
from repro_torch.kernels.ftree_sample import ops as sample_ops
from repro_torch.kernels.ftree_update import (ftree_update_batch,
                                              ftree_update_ref)
from repro_torch.kernels.ftree_update import ops as update_ops
from repro_torch.kernels.lda_scores import lda_scores as ls_mod
from repro_torch.kernels.lda_scores import ops as ls_ops
from repro_torch.kernels.lda_scores.ref import (lda_scores_draw_ref,
                                                lda_scores_pass_ref)
from torch_fold_in_cases import (FLIP_CASES, flip_inputs,
                                 total_rounding_case)

# The packages export the ops under their wrapper modules' names.
fs_sample = importlib.import_module(
    "repro_torch.kernels.ftree_sample.ftree_sample")
fs_update = importlib.import_module(
    "repro_torch.kernels.ftree_update.ftree_update")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(T, J, D, L, seed, dev):
    """Mixed-magnitude φ with zero rows 0..2; row 0 of the batch sits on
    them, row 1 is fully masked, padded slots carry garbage ids."""
    r = np.random.default_rng(seed)
    phi = (r.random((J, T)) * 10.0 ** r.integers(-4, 1, (J, T))).astype(
        np.float32)
    phi[:3] = 0.0
    w = r.integers(0, J, (D, L)).astype(np.int32)
    lens = r.integers(1, L + 1, D)
    lens[0], lens[1] = L, 0
    w[0] = np.arange(L) % 3
    v = np.arange(L)[None, :] < lens[:, None]
    w[~v] = r.integers(-3 * J, 3 * J, (~v).sum())
    keys = doc_fold_key(rng.key(seed, dev), torch.arange(D, device=dev))
    return (torch.as_tensor(w, device=dev),
            torch.as_tensor(v.astype(np.int32), device=dev),
            torch.as_tensor(phi, device=dev), keys)


@pytest.mark.parametrize("T,J,D,L,sweeps", [
    (16, 40, 4, 24, 2),      # one scan block
    (48, 97, 8, 64, 3),      # T not a power of two
    (300, 50, 3, 20, 2),     # ragged last block, two upper levels
    (1024, 200, 8, 64, 3),   # the paper's T
    (4100, 30, 2, 10, 1),    # three upper levels
])
def test_kernel_equals_plain_version(cuda, T, J, D, L, sweeps):
    w, v, phi, keys = _case(T, J, D, L, T, cuda)
    z0, u = fold_in_draws(keys, L, T, sweeps)
    before = fold_in_mod.launches
    got = fold_in_mod.fold_in_cuda(w, v, z0, u.reshape(D, sweeps * L), 0.3,
                                   phi)
    torch.cuda.synchronize()
    assert fold_in_mod.launches == before + 1
    plain = fold_in_kernel_ref(w, v, z0, u, 0.3, phi)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert not got[1].any()


def test_kernel_rounds_cdf_total_as_reference(cuda):
    """One token whose draw depends on how cdf[T-1] is rounded (see
    ``total_rounding_case``): the kernel must draw the reference's
    topic."""
    row, u, want = total_rounding_case(alpha=0.375)
    phi = torch.as_tensor(np.stack([row, row[::-1]]), device=cuda)
    one = torch.ones((1, 1), dtype=torch.int32, device=cuda)
    got = fold_in_mod.fold_in_cuda(
        0 * one, one, 5 * one,
        torch.full((1, 1), u, dtype=torch.float32, device=cuda), 0.375, phi)
    assert int(got[0, want]) == 1 and int(got.sum()) == 1


def test_fused_launches_kernel(cuda):
    w, v, phi, keys = _case(64, 80, 4, 32, 1, cuda)
    before = fold_in_mod.launches
    got = fold_in_fused(w, v, phi, 0.3, keys, 2)
    assert fold_in_mod.launches == before + 1
    z0, u = fold_in_draws(keys, 32, 64, 2)
    torch.testing.assert_close(got, fold_in_kernel_ref(w, v, z0, u, 0.3,
                                                       phi), rtol=0, atol=0)


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    w, v, phi, keys = _case(64, 80, 4, 32, 2, cuda)
    z0, u = fold_in_draws(keys, 32, 64, 2)
    u = u.reshape(4, 64)
    with pytest.raises(ValueError, match="int32"):
        fold_in_mod.fold_in_cuda(w.long(), v, z0, u, 0.3, phi)
    with pytest.raises(ValueError, match="contiguous"):
        fold_in_mod.fold_in_cuda(w, v, z0, u, 0.3, phi.t())
    with pytest.raises(ValueError, match="on cpu"):
        fold_in_mod.fold_in_cuda(w.cpu(), v, z0, u, 0.3, phi)
    with pytest.raises(ValueError, match="shared memory"):
        fold_in_fused(torch.zeros((1, 20000), dtype=torch.int32,
                                  device=cuda),
                      torch.ones((1, 20000), dtype=torch.bool, device=cuda),
                      phi, 0.3, keys[:1], 1)


def _stream(T, I, J, N, seed, dev, masked=0.1):
    """One word-sorted token stream with consistent counts (plus
    background mass in ``n_wt``/``n_t``), some tokens masked, and a
    masked boundary token at the start of a word run."""
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
    t = lambda a: torch.as_tensor(a, device=dev)
    return tuple(t(a) for a in (doc, wrd, valid, bound, z, u, n_td, n_wt,
                                n_t))


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("T,r_mode,r_cap", [
    (8, "dense", None), (64, "sparse", None), (64, "dense", 9),
    (64, "sparse", 9), (1024, "dense", None), (1024, "sparse", 300)])
def test_fused_sweep_tokens_equals_plain_version(cuda, T, r_mode, r_cap):
    args = _stream(T, I=30, J=40, N=600, seed=T, dev=cuda)
    kw = dict(alpha=50.0 / T, beta=0.01, beta_bar=0.01 * 40,
              r_mode=r_mode, r_cap=r_cap)
    before = dict(fs_mod.launches)
    got = fs_ops.fused_sweep_tokens(*args, **kw)
    torch.cuda.synchronize()
    assert fs_mod.launches["fused_sweep"] == before["fused_sweep"] + 1
    _assert_same(got, fused_sweep_ref(*args, **kw))


def _round_inputs(r_mode, dev, **kw):
    corpus, _, _ = make_corpus(num_docs=40, vocab_size=90, num_topics=8,
                               mean_doc_len=20.0, seed=5)
    lay = build_layout(corpus, n_workers=4, T=64, n_blocks=8,
                       layout="ragged")
    model = NomadLDA(layout=lay, alpha=0.5, beta=0.01, r_mode=r_mode,
                     r_cap=17 if r_mode == "sparse" else 0, device=dev,
                     **kw)
    return lay, model, model.init_arrays(3)


@pytest.mark.parametrize("r_mode", ["dense", "sparse"])
def test_ragged_round_equals_plain_version(cuda, r_mode):
    """Round 1 of a W = 4 ring, split at the pipelined tile split, through
    the kernel and the plain version; every output bit for bit."""
    lay, model, arrays = _round_inputs(r_mode, cuda)
    g = torch.Generator().manual_seed(0)
    u = torch.rand((lay.W, lay.stream_len), generator=g).to(cuda)
    results = []
    for sweep in (fs_mod.sweep_streams_cuda, sweep_streams_ref):
        a = {k: v.clone() for k, v in arrays.items()}
        T = lay.T
        n_t = a["n_t"].expand(lay.W, T).contiguous()
        tables = {}
        if r_mode == "sparse":
            tables = dict(topics=a["rb_topics"].view(-1, model.cap),
                          counts=a["rb_counts"].view(-1, model.cap))
        Fs = []
        for start, count in ((0, lay.tile_split),
                             (lay.tile_split, lay.n_tiles - lay.tile_split)):
            Fs.append(sweep(a["tok_doc"], a["tok_wrd"], a["tok_valid"],
                            a["tok_bound"], a["z"], u, a["cell_of_tile"],
                            a["n_td"].view(-1, T), a["n_wt"].view(-1, T),
                            n_t, r=1, k=lay.k, tile=lay.tile,
                            tile_start=start, num_tiles=count,
                            I_max=lay.I_max, J_max=lay.J_max, alpha=0.5,
                            beta=0.01, beta_bar=0.01 * lay.num_words,
                            cap=model.cap, **tables))
        results.append([a["z"], a["n_td"], a["n_wt"], n_t, *Fs]
                       + [v for v in tables.values()])
    torch.cuda.synchronize()
    assert lay.tile_split > 0
    _assert_same(results[0], results[1])


@pytest.mark.parametrize("name", sorted(FLIP_CASES))
def test_kernel_rounds_each_contraction_site_as_reference(cuda, name):
    case = FLIP_CASES[name]
    args, kw = flip_inputs(case, cuda)
    got = fs_ops.fused_sweep_tokens(*args, **kw)
    assert int(got[0][0]) == case["want"]


def test_nomad_fused_launches_two_kernels_per_round(cuda):
    lay, fused_model, arrays = _round_inputs(
        "dense", cuda, inner_mode="fused", ring_mode="pipelined")
    plain_model = NomadLDA(layout=lay, alpha=0.5, beta=0.01,
                           inner_mode="scan", ring_mode="pipelined",
                           device=cuda)
    before = fs_mod.launches["fused_sweep_ragged"]
    fused = fused_model.sweep(arrays, 0)
    assert fs_mod.launches["fused_sweep_ragged"] == before + 2 * lay.W
    plain = plain_model.sweep(arrays, 0)
    for key in ("z", "n_td", "n_wt", "n_t"):
        torch.testing.assert_close(fused[key], plain[key], rtol=0, atol=0)


def test_fused_sweep_wrapper_raises_on_what_it_does_not_take(cuda):
    args = list(_stream(64, I=10, J=12, N=100, seed=1, dev=cuda))
    kw = dict(alpha=0.5, beta=0.01, beta_bar=0.12)
    with pytest.raises(ValueError, match="power-of-two"):
        fs_ops.fused_sweep_tokens(*args[:6], args[6][:, :48],
                                  args[7][:, :48], args[8][:48], **kw)
    bad = list(args)
    bad[5] = bad[5].double()
    with pytest.raises(ValueError, match="float32"):
        fs_mod.sweep_streams_cuda(
            *(a.reshape(1, 1, -1) for a in bad[:5]), bad[5].reshape(1, -1),
            torch.zeros((1, 1, 1), dtype=torch.int32, device=cuda),
            bad[6], bad[7], bad[8].reshape(1, -1), r=0, k=1, tile=100,
            tile_start=0, num_tiles=1, I_max=10, J_max=12, cap=64, **kw)
    with pytest.raises(ValueError, match="on cpu"):
        fs_mod.sweep_streams_cuda(
            *(a.reshape(1, 1, -1) for a in args[:5]),
            args[5].reshape(1, -1),
            torch.zeros((1, 1, 1), dtype=torch.int32, device=cuda),
            args[6].cpu(), args[7], args[8].reshape(1, -1), r=0, k=1,
            tile=100, tile_start=0, num_tiles=1, I_max=10, J_max=12,
            cap=64, **kw)
    with pytest.raises(ValueError, match="T in"):
        big = [a for a in _stream(2048, I=4, J=4, N=8, seed=2, dev=cuda)]
        fs_ops.fused_sweep_tokens(*big, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fs_mod.sweep_streams_cuda(
            *(a.reshape(1, 1, -1) for a in args[:5]),
            args[5].reshape(1, -1),
            torch.zeros((1, 1, 1), dtype=torch.int32, device=cuda),
            args[6].t().contiguous().t(), args[7], args[8].reshape(1, -1),
            r=0, k=1, tile=100, tile_start=0, num_tiles=1, I_max=10,
            J_max=12, cap=64, **kw)


def _grid_inputs(kind, dt, r_mode, dev, ring="pipelined"):
    """A W = 4 model on the dense or ragged layout, grouped by ``dt`` when
    it is not 0 (``I_max % dt != 0``: the last slab is partial), paged
    when grouped."""
    corpus, _, _ = make_corpus(num_docs=40, vocab_size=90, num_topics=8,
                               mean_doc_len=20.0, seed=5)
    kw = dict(doc_tile=dt, doc_blk=16 if kind == "dense" else None) \
        if dt else {}
    lay = build_layout(corpus, n_workers=4, T=64, n_blocks=8, layout=kind,
                       **kw)
    assert not dt or lay.I_max % dt
    model = NomadLDA(layout=lay, alpha=0.5, beta=0.01, r_mode=r_mode,
                     r_cap=17 if r_mode == "sparse" else 0,
                     inner_mode="fused", ring_mode=ring,
                     doc_tile=dt or None, device=dev)
    return lay, model, model.init_arrays(3)


@pytest.mark.parametrize("kind,dt,r_mode", [
    ("dense", 0, "dense"), ("dense", 0, "sparse"), ("ragged", 3, "dense"),
    ("ragged", 3, "sparse"), ("dense", 3, "dense"), ("dense", 3, "sparse")])
def test_round_forms_equal_plain_version(cuda, kind, dt, r_mode):
    """Round 1 of the dense cell grid, and of the grouped ragged and dense
    layouts paged, in the pipelined ring's two launches, through the
    kernel and the plain version.  ``n_td`` is the head of a buffer whose
    tail holds a sentinel: the last worker's partial slab must not reach
    past its shard, nor any slab into the next worker's rows."""
    lay, model, arrays = _grid_inputs(kind, dt, r_mode, cuda)
    base = {"dense": "fused_sweep_cells",
            "ragged": "fused_sweep_ragged"}[kind]
    name = base + ("_docs" if dt else "")
    g = model._geometry(arrays, half_queue_split(lay.k))
    T, W = lay.T, lay.W
    torch.manual_seed(0)
    S = g["cot"].shape[-1] * g["tile"]
    u = torch.rand((W, S), device=cuda)
    results = []
    for sweep in (fs_mod.sweep_streams_cuda, sweep_streams_ref):
        a = {k: v.clone() for k, v in arrays.items()}
        buf = torch.full((W * lay.I_max + 8, T), -7, dtype=torch.int32,
                         device=cuda)
        n_td = buf[:W * lay.I_max]
        n_td.copy_(a["n_td"].view(-1, T))
        n_t = a["n_t"].expand(W, T).contiguous()
        tables = {}
        if r_mode == "sparse":
            tables = dict(topics=a["rb_topics"].view(-1, model.cap),
                          counts=a["rb_counts"].view(-1, model.cap))
        extra = dict(kernel=base) if sweep is fs_mod.sweep_streams_cuda \
            else {}
        before = fs_mod.launches[name]
        Fs = []
        for start, count in g["halves"]:
            Fs.append(sweep(*(g["view"](a[k]) for k in (
                "tok_doc", "tok_wrd", "tok_valid", "tok_bound", "z")), u,
                g["cot"], n_td, a["n_wt"].view(-1, T), n_t, r=1, k=lay.k,
                tile=g["tile"], tile_start=start, num_tiles=count,
                I_max=lay.I_max, J_max=lay.J_max, alpha=0.5, beta=0.01,
                beta_bar=0.01 * lay.num_words, cap=model.cap,
                **g["paging"], **tables, **extra))
        if extra:
            assert fs_mod.launches[name] == before + len(g["halves"])
        assert (buf[W * lay.I_max:] == -7).all()
        results.append([a["z"], n_td, a["n_wt"], n_t, *Fs]
                       + list(tables.values()))
    torch.cuda.synchronize()
    assert len(g["halves"]) == 2
    _assert_same(results[0], results[1])


@pytest.mark.parametrize("T,r_mode", [(64, "dense"), (64, "sparse"),
                                      (1024, "dense"), (1024, "sparse")])
def test_paged_stream_equals_plain_version(cuda, T, r_mode):
    """``fused_sweep_tokens(doc_tile_of=…)``: tiles of 32 tokens, each on
    one slab of 5 rows of a 23-row table, the slabs in order twice over,
    the last one partial."""
    I, J, n_blk, rows = 23, 40, 32, 5
    r = np.random.default_rng(T + 1)
    slabs = np.tile(np.arange(-(-I // rows)), 2)
    doc = np.concatenate([r.integers(g * rows, min(g * rows + rows, I),
                                     n_blk) for g in slabs]).astype(np.int32)
    N = doc.size
    wrd = r.integers(0, J, N).astype(np.int32)
    z = r.integers(0, T, N).astype(np.int32)
    valid = (r.random(N) > 0.1).astype(np.int32)
    bound = np.concatenate([[1], wrd[1:] != wrd[:-1]]).astype(np.int32)
    n_td = np.zeros((I, T), np.int32)
    np.add.at(n_td, (doc, z), valid)
    n_wt = r.integers(0, 3, (J, T)).astype(np.int32)
    np.add.at(n_wt, (wrd, z), valid)
    n_t = (n_wt.sum(0) + r.integers(0, 50, T)).astype(np.int32)
    u = r.random(N).astype(np.float32)
    args = [torch.as_tensor(a, device=cuda) for a in (
        doc, wrd, valid, bound, z, u, n_td, n_wt, n_t)]
    kw = dict(alpha=50.0 / T, beta=0.01, beta_bar=0.4, r_mode=r_mode,
              doc_tile_of=torch.as_tensor(slabs.astype(np.int32),
                                          device=cuda),
              doc_rows=rows, n_blk=n_blk)
    before = fs_mod.launches["fused_sweep_docs"]
    got = fs_ops.fused_sweep_tokens(*args, **kw)
    torch.cuda.synchronize()
    assert fs_mod.launches["fused_sweep_docs"] == before + 1
    _assert_same(got, fused_sweep_ref(*args, **kw))


@pytest.mark.parametrize("kind,dt", [("dense", 0), ("ragged", 3),
                                     ("dense", 3)])
def test_nomad_new_forms_launch_two_kernels_per_round(cuda, kind, dt):
    lay, model, arrays = _grid_inputs(kind, dt, "dense", cuda)
    name = model._sweep_fn.keywords["kernel"] + ("_docs" if dt else "")
    plain = NomadLDA(layout=lay, alpha=0.5, beta=0.01, inner_mode="scan",
                     ring_mode="pipelined", device=cuda)
    before = fs_mod.launches[name]
    fused = model.sweep(arrays, 0)
    assert fs_mod.launches[name] == before + 2 * lay.W
    want = plain.sweep(arrays, 0)
    for key in ("z", "n_td", "n_wt", "n_t"):
        torch.testing.assert_close(fused[key], want[key], rtol=0, atol=0)


@pytest.mark.parametrize("fault", ["doc outside its slab",
                                   "slab past the shard", "negative slab"])
def test_paged_wrapper_refuses_a_map_that_misses_the_tokens(cuda, fault):
    """A map the tokens do not follow is refused before the launch, as
    the plain version refuses it, and nothing is written: the kernel
    would index its slab out of bounds."""
    lay, model, arrays = _grid_inputs("ragged", 3, "dense", cuda)
    g = model._geometry(arrays, 0)
    dto = g["paging"]["dto"].clone()
    valid = arrays["tok_valid"][1, 1].bool()
    tile = torch.nonzero(valid)[0, 0] // g["tile"]
    slabs = -(-lay.I_max // lay.doc_tile)
    dto[1, 1, tile] = {"doc outside its slab": (dto[1, 1, tile] + 1) % slabs,
                       "slab past the shard": slabs,
                       "negative slab": -1}[fault]
    paging = dict(g["paging"], dto=dto)
    T, W = lay.T, lay.W
    u = torch.rand((W, g["cot"].shape[-1] * g["tile"]), device=cuda)
    for sweep, kernel in ((fs_mod.sweep_streams_cuda,
                           dict(kernel="fused_sweep_ragged")),
                          (sweep_streams_ref, {})):
        a = {k: v.clone() for k, v in arrays.items()}
        before = dict(fs_mod.launches)
        with pytest.raises(ValueError, match="outside"):
            sweep(*(a[k] for k in ("tok_doc", "tok_wrd", "tok_valid",
                                   "tok_bound", "z")), u, g["cot"],
                  a["n_td"].view(-1, T), a["n_wt"].view(-1, T),
                  a["n_t"].expand(W, T).contiguous(), r=0, k=lay.k,
                  tile=g["tile"], tile_start=0, num_tiles=lay.n_tiles,
                  I_max=lay.I_max, J_max=lay.J_max, alpha=0.5, beta=0.01,
                  beta_bar=0.01 * lay.num_words, cap=model.cap, **paging,
                  **kernel)
        assert fs_mod.launches == before
        for key in ("z", "n_td", "n_wt"):
            assert torch.equal(a[key], arrays[key])
    with pytest.raises(ValueError, match="outside"):
        model.sweep(dict(arrays, doc_tile_of=dto.view_as(
            arrays["doc_tile_of"])), 0)


def test_check_fits_refuses_a_slab_past_shared_memory(cuda):
    fs_mod.check_fits(1024, 1024, 51)
    with pytest.raises(ValueError, match="shared memory"):
        fs_mod.check_fits(1024, 1024, 52)
    args = list(_stream(1024, I=60, J=8, N=64, seed=3, dev=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        fs_ops.fused_sweep_tokens(
            *args, alpha=0.05, beta=0.01, beta_bar=0.08, n_blk=64,
            doc_tile_of=torch.zeros(1, dtype=torch.int32, device=cuda),
            doc_rows=60)


def _score_rows(T, n, seed, dev):
    r = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    ntd = r.integers(0, 8, (n, T)).astype(np.int32)
    ntd[0] = 0
    return (t(ntd), t(r.integers(0, 20, (n, T)).astype(np.int32)),
            t(r.integers(20, 500, T).astype(np.int32)),
            t(r.random(n).astype(np.float32)))


@pytest.mark.parametrize("T,n", [(16, 1), (33, 70), (100, 300),
                                 (1024, 5000), (4096, 257)])
def test_lda_scores_rows_equal_plain_version(cuda, T, n):
    """One scan block a warp, ragged last blocks, one to three upper scan
    levels, rows past the 48 KiB default of shared memory (T = 4096): z
    and norm bit for bit."""
    args = _score_rows(T, n, T + n, cuda)
    kw = dict(alpha=0.05, beta=0.01, beta_bar=51.2)
    before = ls_mod.launches["lda_scores"]
    got = ls_ops.lda_scores_draw(*args, **kw)
    torch.cuda.synchronize()
    assert ls_mod.launches["lda_scores"] == before + 1
    _assert_same(got, lda_scores_draw_ref(*args, **kw))


def _pass_inputs(T, dev, N=4096, I=50, J=60, W=3):
    r = np.random.default_rng(T)
    t = lambda a: torch.as_tensor(a, device=dev)
    i32 = lambda a: t(np.asarray(a, np.int32))
    return dict(
        doc_row=i32(r.integers(0, I, N)), wrd_row=i32(r.integers(0, J, N)),
        nt_row=i32(r.integers(0, W, N)), z=i32(r.integers(0, T, N)), u=t(r.random(N).astype(np.float32)),
        n_td=i32(r.integers(1, 9, (I, T))),
        n_wt=i32(r.integers(1, 30, (J, T))),
        n_t=i32(r.integers(2000, 3000, (W, T))))


@pytest.mark.parametrize("T", [16, 1024])
def test_lda_scores_pass_equals_plain_version(cuda, T):
    """The pass form and the whole vectorized pass (deltas applied with
    ``index_add_``): z and all three tables bit for bit."""
    a = _pass_inputs(T, cuda)
    kw = dict(alpha=0.3, beta=0.01, beta_bar=0.6)
    before = ls_mod.launches["lda_scores_pass"]
    got = ls_mod.lda_scores_pass_cuda(*a.values(), **kw)
    torch.cuda.synchronize()
    assert ls_mod.launches["lda_scores_pass"] == before + 1
    want = lda_scores_pass_ref(*a.values(), **kw)
    _assert_same([got], [want])
    assert int((got != a["z"]).sum()) > 0
    results = []
    for draw in (ls_mod.lda_scores_pass_cuda, lda_scores_pass_ref):
        b = {k: v.clone() for k, v in a.items()}
        tabs = (b["n_td"], b["n_wt"], b["n_t"])
        z = draw(*b.values(), **kw)
        ls_ops.apply_deltas(b["z"], z, (b["doc_row"], b["wrd_row"],
                                        b["nt_row"]), tabs)
        results.append([z, *tabs])
    _assert_same(*results)


@pytest.mark.parametrize("kind", ["ragged", "dense"])
def test_nomad_vectorized_equals_plain_run(cuda, kind):
    """``NomadLDA(inner_mode="vectorized")`` on the card launches the pass
    form once a cell and runs the plain version's chain on the CPU bit for
    bit, two sweeps, both ring modes."""
    corpus, _, _ = make_corpus(num_docs=40, vocab_size=90, num_topics=8,
                               mean_doc_len=20.0, seed=5)
    lay = build_layout(corpus, n_workers=4, T=64, n_blocks=8, layout=kind)
    runs = []
    for dev, ring in ((cuda, "pipelined"), ("cpu", "barrier")):
        m = NomadLDA(layout=lay, alpha=0.5, beta=0.01, device=dev,
                     inner_mode="vectorized", ring_mode=ring)
        a = m.init_arrays(3)
        before = ls_mod.launches["lda_scores_pass"]
        for s in range(2):
            a = m.sweep(a, s)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert ls_mod.launches["lda_scores_pass"] == (
                before + 2 * lay.W * lay.k)
        runs.append([a[k].cpu() for k in ("z", "n_td", "n_wt", "n_t")])
    _assert_same(*runs)


def _pair_tree(p):
    levels = [p]
    while levels[-1].numel() > 1:
        levels.append(levels[-1][0::2] + levels[-1][1::2])
    return torch.cat([torch.zeros(1, device=p.device)] + levels[::-1])


@pytest.mark.parametrize("T,N", [(8, 1), (1024, 5000), (16384, 1 << 20)])
def test_ftree_sample_equals_plain_version(cuda, T, N):
    g = torch.Generator(device=cuda).manual_seed(T)
    p = torch.rand(T, generator=g, device=cuda)
    p[torch.rand(T, generator=g, device=cuda) < 0.3] = 0.0
    F = _pair_tree(p)
    u = torch.rand(N, generator=g, device=cuda)
    u[:1] = 1.0 - 2**-24
    before = fs_sample.launches
    got = ftree_sample(F, u)
    torch.cuda.synchronize()
    assert fs_sample.launches == before + 1
    _assert_same([got], [ftree_sample_ref(F, u)])
    assert (p[got.long()] > 0).all()


@pytest.mark.parametrize("T", [8, 1024, 16384])
@pytest.mark.parametrize("kind", ["real", "integer"])
def test_ftree_update_equals_plain_version(cuda, T, kind):
    """Duplicates: the kernel adds each node's deltas in update order, so
    it equals the plain version on the CPU bit for bit; integer-valued
    deltas on an integer tree also equal the plain version on the card,
    whose ``index_add_`` adds in another order."""
    g = torch.Generator(device=cuda).manual_seed(T)
    K = 70_000
    ts = torch.randint(T, (K,), generator=g, device=cuda, dtype=torch.int32)
    ts[:K // 4] = T // 2
    if kind == "integer":
        F = _pair_tree(torch.randint(0, 50, (T,), generator=g,
                                     device=cuda).float())
        d = torch.randint(-3, 4, (K,), generator=g, device=cuda).float()
    else:
        F = _pair_tree(torch.rand(T, generator=g, device=cuda))
        d = torch.randn(K, generator=g, device=cuda)
    F_in = F.clone()
    before = fs_update.launches
    got = ftree_update_batch(F, ts, d)
    torch.cuda.synchronize()
    assert fs_update.launches == before + 1
    assert torch.equal(F, F_in)
    _assert_same([got.cpu()], [ftree_update_ref(F.cpu(), ts.cpu(),
                                                d.cpu())])
    if kind == "integer":
        _assert_same([got], [ftree_update_ref(F, ts, d)])


def test_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch):
    """With every plain version of the three kernels made to fail, their
    ops still answer on CUDA tensors: through the kernels, counted."""
    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in ((ls_ops, "lda_scores_draw_ref"),
                      (ls_ops, "lda_scores_pass_ref"),
                      (sample_ops, "ftree_sample_ref"),
                      (update_ops, "ftree_update_ref")):
        monkeypatch.setattr(mod, name, boom)
    before = (dict(ls_mod.launches), fs_sample.launches, fs_update.launches)
    ls_ops.lda_scores_draw(*_score_rows(64, 10, 0, cuda), alpha=0.1,
                           beta=0.01, beta_bar=1.0)
    ls_ops.vectorized_pass(*_pass_inputs(64, cuda).values(), alpha=0.1,
                           beta=0.01, beta_bar=1.0)
    F = _pair_tree(torch.rand(64, device=cuda))
    z = ftree_sample(F, torch.rand(100, device=cuda))
    ftree_update_batch(F, z, torch.ones(100, device=cuda))
    torch.cuda.synchronize()
    assert ls_mod.launches["lda_scores"] == before[0]["lda_scores"] + 1
    assert ls_mod.launches["lda_scores_pass"] == (
        before[0]["lda_scores_pass"] + 1)
    assert (fs_sample.launches, fs_update.launches) == (before[1] + 1,
                                                        before[2] + 1)


def test_batched_wrappers_raise_on_what_they_do_not_take(cuda):
    F = _pair_tree(torch.rand(64, device=cuda))
    u = torch.rand(8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fs_sample.ftree_sample_cuda(F.double(), u)
    with pytest.raises(ValueError, match="shared memory"):
        fs_sample.ftree_sample_cuda(torch.zeros(1 << 16, device=cuda), u)
    with pytest.raises(ValueError, match="int32"):
        fs_update.ftree_update_cuda(F, torch.zeros(8, dtype=torch.int64,
                                                   device=cuda), u)
    with pytest.raises(ValueError, match="on cpu"):
        fs_update.ftree_update_cuda(F, torch.zeros(8, dtype=torch.int32),
                                    u)
    rows = _score_rows(8192, 4, 0, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ls_mod.lda_scores_cuda(*rows, alpha=0.1, beta=0.01, beta_bar=1.0)
    a = _pass_inputs(64, cuda)
    a["u"] = a["u"][1:]
    with pytest.raises(ValueError, match="must match"):
        ls_mod.lda_scores_pass_cuda(*a.values(), alpha=0.1, beta=0.01,
                                    beta_bar=1.0)
    z = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="u01 is on cpu"):
        ftree_sample(F, u.cpu())
    with pytest.raises(ValueError, match="F on cpu"):
        ftree_sample(F.cpu(), u)
    with pytest.raises(ValueError, match="ts is on cpu"):
        ftree_update_batch(F, z.cpu(), u)
    with pytest.raises(ValueError, match="deltas is on cuda"):
        ftree_update_batch(F.cpu(), z.cpu(), u)
