"""The CUDA kernels on the card, against their plain PyTorch versions on
the same inputs: the fold-in kernel, and the fused-sweep kernel in its
single-stream and nomad-round forms.  Needs an NVIDIA GPU (``gpu``
marker; skips without one).  Imports neither ``jax`` nor ``repro``, so it
runs on a machine with PyTorch for CUDA alone:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.core.heldout import doc_fold_key
from repro_torch.core.nomad import NomadLDA
from repro_torch.data.sharding import build_layout
from repro_torch.data.synthetic import make_corpus
from repro_torch.kernels.fold_in import (fold_in_draws, fold_in_fused,
                                         fold_in_kernel_ref)
from repro_torch.kernels.fold_in import fold_in as fold_in_mod
from repro_torch.kernels.fused_sweep import fused_sweep as fs_mod
from repro_torch.kernels.fused_sweep import ops as fs_ops
from repro_torch.kernels.fused_sweep.ref import (fused_sweep_ref,
                                                 sweep_streams_ref)
from torch_fold_in_cases import (FLIP_CASES, flip_inputs,
                                 total_rounding_case)

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
