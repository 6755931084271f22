"""The CUDA kernels on the card, against their plain PyTorch versions on
the same inputs: the fold-in kernel, the fused-sweep kernel in its
single-stream, dense cell-grid and ragged nomad-round forms, each unpaged
and with ``n_td`` paged through a shared-memory slab, the ``lda_scores``
kernel in its rows and pass forms (and ``NomadLDA``'s vectorized mode on
it), and the batched F+tree sample and update kernels; ``NomadLDA``'s
fused chain against the plain scan at T = 1024, and its resume and
``collect_lag`` trace on the card against straight runs and the CPU;
the full exactness matrix (``lda_matrix_check 8 2 full``), the
perplexity's batched fold-in against the serial one, a chain carried
across a store update, and ``LdaEngine``'s answers against the plain
and serial fold-in; the model zoo's ten archs at smoke size on the card
against the CPU (logits, decode against the forward, ``generate``) and
an MoE layer whose experts overflow their capacity; their training path
(loss, gradients and one AdamW step on the card against the CPU, the
loss under per-layer remat equal to the forward's) and expert
parallelism in lock step (``ep_check``).
Needs an NVIDIA
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
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import ep_check, zoo_serve_check, zoo_train_check
from repro_torch.models import moe as moe_mod
from torch_fold_in_cases import (BIG_FLIP_CASES, FLIP_CASES, big_flip_case,
                                 flip_inputs, total_rounding_case)

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
    (37, 61, 3, 40, 2),      # T not a multiple of 4: 4-byte row copies
    (48, 97, 8, 64, 3),      # T not a power of two
    (300, 50, 3, 20, 2),     # ragged last block, two upper levels
    (512, 120, 4, 64, 2),    # half the lanes hold a line
    (1024, 200, 8, 64, 3),   # the paper's T: a line a lane
    (2048, 60, 4, 48, 2),    # two chunks: the first one's lines stored
    (4100, 30, 2, 10, 1),    # three upper levels, a ragged last chunk
    (16384, 20, 2, 16, 1),   # 16 chunks, the ring at 2 slots
    (20000, 12, 2, 16, 1),   # deep: n_td in device memory, 2 lines a thread
    (32768, 20, 2, 16, 1),   # deep, 128 group totals
    (40001, 8, 2, 12, 1),    # deep, T not a multiple of 4: 4-byte φ reads
    (65536, 10, 2, 16, 1),   # deep, 4 lines a thread, 256 group totals
    (131072, 8, 2, 12, 1),   # huge: 8 lines a thread, a fifth scan level
    (262144, 6, 2, 12, 1),   # huge, 1,024 group totals
    (1000003, 4, 2, 8, 1),   # huge, a ragged last chunk: 4-byte φ reads
    (1048574, 4, 2, 8, 1),   # the largest T, 64 lines a thread
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


def test_kernel_reads_phi_rows_past_2_31_entries(cuda):
    """T = 1,048,574 over a φ of 2,050 rows (2,149,576,700 entries, 8.6
    GB): tokens on the last rows, whose offsets pass 2^31; counts equal to
    the plain version's."""
    T, J, D, L, sweeps = 1_048_574, 2_050, 2, 8, 2
    gen = torch.Generator(device=cuda).manual_seed(7)
    phi = torch.rand((J, T), generator=gen, device=cuda)
    assert phi.numel() > 2**31
    w = torch.randint(J - 4, J, (D, L), generator=gen, device=cuda,
                      dtype=torch.int32)
    w[0, 0] = J - 1
    v = torch.ones((D, L), dtype=torch.int32, device=cuda)
    v[1, 5:] = 0
    keys = doc_fold_key(rng.key(11, cuda), torch.arange(D, device=cuda))
    z0, u = fold_in_draws(keys, L, T, sweeps)
    got = fold_in_mod.fold_in_cuda(w, v, z0, u.reshape(D, sweeps * L), 0.05,
                                   phi)
    torch.cuda.synchronize()
    want = fold_in_kernel_ref(w, v, z0, u, 0.05, phi)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.sum(1).tolist() == [L, 5]


def test_kernel_takes_a_full_document_of_the_longest_bucket(cuda):
    """One document of L = 4096 valid tokens (the serving path's bucket of
    its 4,000-token outlier), T = 1024, and a φ not 16-byte aligned (rows
    copied 4 bytes at a time): counts equal to the plain version's."""
    T, L, sweeps = 1024, 4096, 2
    r = np.random.default_rng(4096)
    flat = torch.as_tensor(r.random(300 * T + 1).astype(np.float32),
                           device=cuda)
    phi = flat[1:].view(300, T)
    assert phi.data_ptr() % 16 and phi.is_contiguous()
    w = torch.as_tensor(r.integers(0, 300, (1, L)).astype(np.int32),
                        device=cuda)
    v = torch.ones((1, L), dtype=torch.int32, device=cuda)
    keys = doc_fold_key(rng.key(7, cuda), torch.arange(1, device=cuda))
    z0, u = fold_in_draws(keys, L, T, sweeps)
    got = fold_in_mod.fold_in_cuda(w, v, z0, u.reshape(1, sweeps * L), 0.05,
                                   phi)
    torch.cuda.synchronize()
    want = fold_in_kernel_ref(w, v, z0, u, 0.05, phi)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(got.sum()) == L


@pytest.mark.parametrize("T", [64, 2048])
def test_kernel_keeps_counts_of_heavy_weights_exact(cuda, T):
    """Weights past the 0/1 mask: a document whose weights sum past 2^24
    (its counts then stay ints, converted at each step) and one of small
    weights above 1 (its counts kept as floats, exact): counts equal to
    the plain version's, one warp and a warp a chunk."""
    D, L, J, sweeps = 2, 16, 30, 2
    r = np.random.default_rng(T)
    phi = torch.as_tensor(r.random((J, T)).astype(np.float32), device=cuda)
    w = torch.as_tensor(r.integers(0, J, (D, L)).astype(np.int32),
                        device=cuda)
    v = np.zeros((D, L), np.int32)
    v[0, :3] = 1 << 23
    v[1, :10] = r.integers(1, 4, 10)
    v = torch.as_tensor(v, device=cuda)
    keys = doc_fold_key(rng.key(3, cuda), torch.arange(D, device=cuda))
    z0, u = fold_in_draws(keys, L, T, sweeps)
    got = fold_in_mod.fold_in_cuda(w, v, z0, u.reshape(D, sweeps * L), 0.2,
                                   phi)
    torch.cuda.synchronize()
    want = fold_in_kernel_ref(w, v, z0, u, 0.2, phi)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("T,aligned", [(1024, True), (2048, True),
                                       (4096, True), (4096, False)])
def test_kernel_takes_documents_of_one_to_three_tokens(cuda, T, aligned):
    """Many documents of 1, 2 and 3 valid tokens over several sweeps: with
    two tokens each step's next topic is the one the last step drew (a
    warp a chunk reads it after the step's first barrier).  One warp and a
    warp a chunk, φ rows by TMA and, unaligned, by 4-byte cp.async: counts
    equal to the plain version's."""
    D, L, J, sweeps = 96, 8, 50, 6
    r = np.random.default_rng(T + aligned)
    flat = torch.as_tensor(r.random(J * T + 1).astype(np.float32),
                           device=cuda)
    phi = flat[:-1].view(J, T) if aligned else flat[1:].view(J, T)
    assert (phi.data_ptr() % 16 == 0) == aligned
    w = torch.as_tensor(r.integers(0, J, (D, L)).astype(np.int32),
                        device=cuda)
    v = np.zeros((D, L), np.int32)
    for d in range(D):                  # two of three documents: 2 tokens
        n = (1, 2, 2, 3)[d % 4]
        v[d, r.choice(L, n, replace=False)] = 1
    v = torch.as_tensor(v, device=cuda)
    keys = doc_fold_key(rng.key(T, cuda), torch.arange(D, device=cuda))
    z0, u = fold_in_draws(keys, L, T, sweeps)
    got = fold_in_mod.fold_in_cuda(w, v, z0, u.reshape(D, sweeps * L), 0.05,
                                   phi)
    torch.cuda.synchronize()
    want = fold_in_kernel_ref(w, v, z0, u, 0.05, phi)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_takes_the_longest_bucket_with_one_ring_slot(cuda):
    """L so long that one φ row slot is all that fits beside the chain
    arrays (each row copied at its own step), at T = 1024: counts equal to
    the plain version's, and the library's shared memory is the least that
    check_fits compares."""
    T, D, J, sweeps = 1024, 2, 40, 1
    L = (fold_in_mod.SMEM_LIMIT_BYTES // 4 - 2 * T - 68) // 4
    fold_in_mod.check_fits(L, T)
    assert fold_in_mod.fold_in_smem_bytes(L, T) == \
        fold_in_mod.least_smem_bytes(L, T)
    r = np.random.default_rng(L)
    phi = torch.as_tensor(r.random((J, T)).astype(np.float32), device=cuda)
    w = torch.as_tensor(r.integers(0, J, (D, L)).astype(np.int32),
                        device=cuda)
    v = np.zeros((D, L), np.int32)
    v[0, r.choice(L, 200, replace=False)] = 1
    v[1, -150:] = 1
    v = torch.as_tensor(v, device=cuda)
    keys = doc_fold_key(rng.key(5, cuda), torch.arange(D, device=cuda))
    z0, u = fold_in_draws(keys, L, T, sweeps)
    got = fold_in_mod.fold_in_cuda(w, v, z0, u.reshape(D, sweeps * L), 0.05,
                                   phi)
    torch.cuda.synchronize()
    want = fold_in_kernel_ref(w, v, z0, u, 0.05, phi)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _long_case(T, L, seed, dev, J=64):
    """The rows of a long bucket: row 0 with valid tokens spread over the
    whole row (past position 14,511, where at small T the per-token
    arrays leave shared memory) and its last position valid, row 1 empty,
    row 2 with 20 valid tokens (fewer than a window of 32 steps: each
    step reads the next topic from memory), row 3 with 33 (the fewest
    whose topics come a window at a time); φ of J rows, rows 0..2 zero,
    row 0's even positions on them."""
    r = np.random.default_rng(seed)
    phi = torch.rand((J, T), generator=torch.Generator(dev).manual_seed(
        seed), device=dev)
    phi[:3] = 0.0
    w = r.integers(0, J, (4, L)).astype(np.int32)
    w[0, ::2] = np.arange(0, L, 2) % 3
    v = np.zeros((4, L), np.int32)
    v[0] = r.random(L) < 0.75
    v[0, -1] = 1
    v[2, r.choice(L, 20, replace=False)] = 1
    v[3, r.choice(L, 33, replace=False)] = 1
    return (torch.as_tensor(w, device=dev), torch.as_tensor(v, device=dev),
            phi, v.sum(1))


@pytest.mark.parametrize("L,T,sweeps", [
    (16384, 1024, 2),        # one warp, the smallest long bucket at 1024
    (65536, 1024, 1),        # the engine's bucket of a 60,000-token doc
    (130944, 1024, 1),       # the reference's longest at T = 1024, 20 sweeps
    (16384, 4096, 2),        # a warp a chunk
    (16384, 65536, 1),       # deep: n_td and the arrays in one scratch row
    (16384, 262144, 1),      # huge
])
def test_kernel_equals_plain_version_at_long_lengths(cuda, L, T, sweeps):
    """The long placement (the per-token arrays in device memory, where
    beside the state they would pass shared memory): counts equal to the
    plain version's bit for bit, in each of the four builds, and the
    library's shared memory and scratch as ``fold_in.py`` computes
    them."""
    assert fold_in_mod.long_placement(L, T)
    fold_in_mod.check_fits(L, T, sweeps)
    lib = fold_in_mod.fold_in_smem_bytes(L, T)
    assert fold_in_mod.least_smem_bytes(L, T) <= lib \
        <= fold_in_mod.SMEM_LIMIT_BYTES
    if T <= 4096:                        # the ring's eight slots are back
        assert lib == fold_in_mod.least_smem_bytes(L, T) + 7 * 4 * T \
            + 1024 + 8 * 8
    assert fold_in_mod._build.library().fold_in_scratch_bytes(L, T) == \
        4 * fold_in_mod.scratch_words(L, T)
    w, v, phi, lens = _long_case(T, L, L + T, cuda)
    keys = doc_fold_key(rng.key(T, cuda), torch.arange(4, device=cuda))
    z0, u = fold_in_draws(keys, L, T, sweeps)
    before = fold_in_mod.launches
    got = fold_in_mod.fold_in_cuda(w, v, z0, u.reshape(4, sweeps * L), 0.05,
                                   phi)
    torch.cuda.synchronize()
    assert fold_in_mod.launches == before + 1
    want = fold_in_kernel_ref(w, v, z0, u, 0.05, phi)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.sum(1).tolist() == lens.tolist()


@pytest.mark.parametrize("L,T", [(2048, 1024), (512, 1000), (64, 37),
                                 (512, 16384), (4096, 4100)])
def test_kernel_shared_memory_holds_a_ring_where_it_fits(cuda, L, T):
    """The library's shared memory for (L, T): at least what check_fits
    compares and within the limit; at T = 1024, L = 2048 a ring of 8 φ
    rows (with 1024 bytes of alignment and an mbarrier a slot)."""
    lib = fold_in_mod.fold_in_smem_bytes(L, T)
    least = fold_in_mod.least_smem_bytes(L, T)
    assert least <= lib <= fold_in_mod.SMEM_LIMIT_BYTES
    if (L, T) == (2048, 1024):
        assert lib == least + 7 * 4 * T + 1024 + 8 * 8


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
    # what the kernel still refuses: T past MAX_TOPICS, and a chain past
    # its int32 indices (2^26 positions, 32 sweeps)
    with pytest.raises(ValueError, match="topics"):
        fold_in_fused(w[:1], v[:1], torch.ones(
            (2, fold_in_mod.MAX_TOPICS + 1), device=cuda), 0.3, keys[:1], 1)
    L = 2**26
    with pytest.raises(ValueError, match="int32"):
        fold_in_fused(torch.zeros((1, L), dtype=torch.int32, device=cuda),
                      torch.ones((1, L), dtype=torch.bool, device=cuda),
                      phi, 0.3, keys[:1], 32)


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
    (64, "sparse", 9), (1024, "dense", None), (1024, "sparse", 300),
    (2048, "dense", None), (2048, "sparse", None), (4096, "dense", None),
    (4096, "sparse", 700), (8192, "dense", None), (8192, "sparse", None),
    (16384, "sparse", 3844), (16384, "sparse", 17), (16384, "dense", None),
    (16384, "sparse", None), (32768, "dense", None), (32768, "sparse", None),
    (65536, "dense", None), (65536, "sparse", 300), (1, "dense", None),
    (1, "sparse", None), (131072, "dense", None), (131072, "sparse", None),
    (262144, "dense", None), (262144, "sparse", 300)])
def test_fused_sweep_tokens_equals_plain_version(cuda, T, r_mode, r_cap):
    """Up to T = 8192 with ``cap = T`` in shared memory; T = 16384 with
    the largest sparse cap that fits and a small one; above, the spilled
    layout up to T = 262,144 with ``cap = T``; T = 1, a two-entry tree."""
    args = _stream(T, I=30, J=40, N=600, seed=T, dev=cuda)
    kw = dict(alpha=50.0 / T, beta=0.01, beta_bar=0.01 * 40,
              r_mode=r_mode, r_cap=r_cap)
    before = dict(fs_mod.launches)
    got = fs_ops.fused_sweep_tokens(*args, **kw)
    torch.cuda.synchronize()
    assert fs_mod.launches["fused_sweep"] == before["fused_sweep"] + 1
    _assert_same(got, fused_sweep_ref(*args, **kw))


@pytest.mark.parametrize("T,r_mode", [(1024, "dense"), (16384, "dense"),
                                      (16384, "sparse"), (65536, "dense")])
def test_fused_sweep_takes_n_td_not_16_byte_aligned(cuda, T, r_mode):
    """``n_td`` a contiguous view 4 bytes past a 16-byte boundary: rows
    move 4 bytes at a time, in the fitting layout's row copy and where the
    spilled layout reads them in place; equal to the plain version."""
    args = list(_stream(T, I=12, J=20, N=200, seed=T + 5, dev=cuda))
    flat = torch.zeros(args[6].numel() + 1, dtype=torch.int32, device=cuda)
    args[6] = flat[1:].view_as(args[6]).copy_(args[6])
    assert args[6].is_contiguous() and args[6].data_ptr() % 16
    kw = dict(alpha=50.0 / T, beta=0.01, beta_bar=0.01 * 20, r_mode=r_mode)
    want = fused_sweep_ref(*[a.clone() for a in args], **kw)
    _assert_same(fs_ops.fused_sweep_tokens(*args, **kw), want)


def test_fused_sweep_reaches_word_rows_past_2_31_entries(cuda):
    """T = 262,144 against an ``n_wt`` of 8,200 word rows (2,149,580,800
    entries, 8.6 GB), the stream's tokens on its last rows, whose offsets
    pass 2^31; both r-modes, every output equal to the plain version's."""
    T, I, J, N = 262_144, 6, 8_200, 40
    gen = torch.Generator(device=cuda).manual_seed(5)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=cuda,
                             dtype=torch.int32)

    doc = ints(0, I, (N,))
    wrd = ints(J - 8, J, (N,)).sort().values
    z = ints(0, T, (N,))
    one = torch.ones(N, dtype=torch.int32, device=cuda)
    bound = torch.ones(N, dtype=torch.int32, device=cuda)
    bound[1:] = (wrd[1:] != wrd[:-1]).int()
    n_td = torch.zeros((I, T), dtype=torch.int32, device=cuda)
    n_td.index_put_((doc.long(), z.long()), one, accumulate=True)
    n_wt = ints(0, 3, (J, T))
    assert n_wt.numel() > 2**31
    n_wt.index_put_((wrd.long(), z.long()), one, accumulate=True)
    n_t = n_wt[J - 8:].sum(0, dtype=torch.int32) + ints(0, 50, (T,))
    u = torch.rand(N, generator=gen, device=cuda)
    args = (doc, wrd, one, bound, z, u, n_td, n_wt, n_t)
    for r_mode in ("dense", "sparse"):
        kw = dict(alpha=50.0 / T, beta=0.01, beta_bar=0.01 * J,
                  r_mode=r_mode)
        got = fs_ops.fused_sweep_tokens(*args, **kw)
        torch.cuda.synchronize()
        want = fused_sweep_ref(*args, **kw)
        _assert_same(got, want)
        del got, want
        torch.cuda.empty_cache()


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


@pytest.mark.parametrize("key", sorted(BIG_FLIP_CASES))
def test_kernel_rounds_each_site_above_1024_topics(cuda, key):
    """The same at T = 2048 and 4096, and the root's order (``root``)."""
    case = big_flip_case(key)
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
    big = _stream(fs_mod.MAX_TOPICS, I=4, J=4, N=8, seed=2, dev=cuda)
    _assert_same(fs_ops.fused_sweep_tokens(*big, **kw),
                 fused_sweep_ref(*big, **kw))
    with pytest.raises(ValueError, match="power-of-two T"):
        past = _stream(2 * fs_mod.MAX_TOPICS, I=4, J=4, N=8, seed=2,
                       dev=cuda)
        fs_ops.fused_sweep_tokens(*past, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fs_mod.sweep_streams_cuda(
            *(a.reshape(1, 1, -1) for a in args[:5]),
            args[5].reshape(1, -1),
            torch.zeros((1, 1, 1), dtype=torch.int32, device=cuda),
            args[6].t().contiguous().t(), args[7], args[8].reshape(1, -1),
            r=0, k=1, tile=100, tile_start=0, num_tiles=1, I_max=10,
            J_max=12, cap=64, **kw)


def _grid_inputs(kind, dt, r_mode, dev, ring="pipelined", T=64):
    """A W = 4 model on the dense or ragged layout, grouped by ``dt`` when
    it is not 0 (``I_max % dt != 0``: the last slab is partial), paged
    when grouped."""
    corpus, _, _ = make_corpus(num_docs=40, vocab_size=90, num_topics=8,
                               mean_doc_len=20.0, seed=5)
    kw = dict(doc_tile=dt, doc_blk=16 if kind == "dense" else None) \
        if dt else {}
    lay = build_layout(corpus, n_workers=4, T=T, n_blocks=8, layout=kind,
                       **kw)
    assert not dt or lay.I_max % dt
    model = NomadLDA(layout=lay, alpha=0.5, beta=0.01, r_mode=r_mode,
                     r_cap=17 if r_mode == "sparse" else 0,
                     inner_mode="fused", ring_mode=ring,
                     doc_tile=dt or None, device=dev)
    return lay, model, model.init_arrays(3)


@pytest.mark.parametrize("kind,dt,r_mode,T", [
    ("dense", 0, "dense", 64), ("dense", 0, "sparse", 64),
    ("ragged", 3, "dense", 64), ("ragged", 3, "sparse", 64),
    ("dense", 3, "dense", 64), ("dense", 3, "sparse", 64),
    ("ragged", 0, "dense", 2048), ("dense", 0, "sparse", 2048),
    ("ragged", 3, "dense", 4096), ("dense", 3, "sparse", 4096),
    ("dense", 0, "dense", 8192), ("ragged", 0, "dense", 8192),
    ("ragged", 3, "sparse", 8192), ("dense", 3, "sparse", 8192),
    ("ragged", 0, "sparse", 16384)] + [
        (kind, dt, r_mode, T)
        for T, r_mode in ((16384, "dense"), (32768, "dense"),
                          (32768, "sparse"), (65536, "dense"),
                          (131072, "dense"), (131072, "sparse"),
                          (262144, "dense"))
        for kind in ("dense", "ragged") for dt in (0, 3)])
def test_round_forms_equal_plain_version(cuda, kind, dt, r_mode, T):
    """Round 1 of the dense cell grid, and of the grouped ragged and dense
    layouts paged, in the pipelined ring's two launches, through the
    kernel and the plain version, at T up to 262,144 (the sparse cap of
    17; spilled from T = 16,384 dense, the paged forms reading their rows
    in place).  ``n_td`` is the head of a buffer whose tail holds
    a sentinel: the last worker's partial slab must not reach past its
    shard, nor any slab into the next worker's rows."""
    lay, model, arrays = _grid_inputs(kind, dt, r_mode, cuda, T=T)
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
                                      (1024, "dense"), (1024, "sparse"),
                                      (2048, "sparse"), (4096, "dense"),
                                      (16384, "dense"), (32768, "dense"),
                                      (32768, "sparse"), (65536, "dense")])
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
    """A slab of 51 rows of T = 1024 fits a block beside the rest of the
    state; one of 52 does not, and the kernel then reads the doc rows
    where they lie (the launch still counts as paged) and keeps the rest
    in shared memory.  Only T past MAX_TOPICS is refused."""
    assert fs_mod.check_fits(1024, 1024, 51)["rows"] == "slab"
    where = fs_mod.check_fits(1024, 1024, 52)
    assert where["spill"] and where["rows"] == "in place"
    assert where["device"] == [] and where["scratch_bytes"] == 0
    args = list(_stream(1024, I=60, J=8, N=64, seed=3, dev=cuda))
    kw = dict(alpha=0.05, beta=0.01, beta_bar=0.08, n_blk=64,
              doc_tile_of=torch.zeros(1, dtype=torch.int32, device=cuda),
              doc_rows=60)
    before = fs_mod.launches["fused_sweep_docs"]
    _assert_same(fs_ops.fused_sweep_tokens(*args, **kw),
                 fused_sweep_ref(*args, **kw))
    assert fs_mod.launches["fused_sweep_docs"] == before + 1
    with pytest.raises(ValueError, match="power-of-two T"):
        fs_mod.check_fits(2 * fs_mod.MAX_TOPICS, 1024, 52)


def _score_rows(T, n, seed, dev):
    r = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    ntd = r.integers(0, 8, (n, T)).astype(np.int32)
    ntd[0] = 0
    return (t(ntd), t(r.integers(0, 20, (n, T)).astype(np.int32)),
            t(r.integers(20, 500, T).astype(np.int32)),
            t(r.random(n).astype(np.float32)))


@pytest.mark.parametrize("T,n", [(16, 1), (33, 70), (48, 90), (100, 300),
                                 (512, 1000), (1024, 5000), (1100, 200),
                                 (2048, 129), (3001, 150), (4096, 257),
                                 (7168, 60), (7169, 100), (8192, 300),
                                 (16384, 129), (40001, 70), (65536, 33),
                                 (131072, 3000)])
def test_lda_scores_rows_equal_plain_version(cuda, T, n):
    """One scan block a warp, ragged last blocks, T not a multiple of 4
    (4-byte loads), half the lanes holding a line (T = 512), one to three
    upper scan levels, two to seven chunks (the earlier chunks' lines in
    shared memory), a ragged last chunk (T = 1100, 3001; 4-byte loads
    above 1024 at 3001), the largest stored T (7,168), then the deep
    layout (each line formed twice): its upper levels in shared memory
    from 7,169 (a one-topic last chunk) to 65,536 (a ragged last chunk
    and 4-byte loads at 40,001), in the device scratch at 131,072 (3,000
    tokens, so that warps loop over runs): z and norm bit for bit."""
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


@pytest.mark.parametrize("T", [16, 48, 512, 1024, 1100, 2048, 3001, 4096,
                               7168, 7169, 8192, 16384, 40001, 65536,
                               131072])
def test_lda_scores_pass_equals_plain_version(cuda, T):
    """The pass form and the whole vectorized pass (deltas applied with
    ``index_add_``): z and all three tables bit for bit, in every layout
    (the deep one's levels in the device scratch at 131,072)."""
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


@pytest.mark.parametrize("case", ["one token", "one document"])
def test_lda_scores_pass_at_the_edges_of_a_launch(cuda, case):
    """A launch of one token, and one whose 4,096 tokens all read one
    document's row (so every warp's run shares it): z bit for bit."""
    a = _pass_inputs(1024, cuda)
    if case == "one token":
        a = {k: v[:1] if k in ("doc_row", "wrd_row", "nt_row", "z", "u")
             else v for k, v in a.items()}
    else:
        a["doc_row"] = torch.full_like(a["doc_row"], 7)
    kw = dict(alpha=0.3, beta=0.01, beta_bar=0.6)
    got = ls_mod.lda_scores_pass_cuda(*a.values(), **kw)
    torch.cuda.synchronize()
    _assert_same([got], [lda_scores_pass_ref(*a.values(), **kw)])


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


def _sample_once(F, u):
    """``ftree_sample`` on the card, launched once."""
    before = fs_sample.launches
    got = ftree_sample(F, u)
    torch.cuda.synchronize()
    assert fs_sample.launches == before + 1
    return got


@pytest.mark.parametrize("T,N", [
    (8, 1), (1024, 5000), (16384, 1 << 20), (2, 1 << 20), (32768, 1 << 20),
    (65536, 1 << 20), (1024, 1), (1024, 3), (1024, 4097), (65536, 4097)])
def test_ftree_sample_equals_plain_version(cuda, T, N):
    """Any power-of-two T (above 32,768 the deepest levels are read from
    device memory) and any N, a multiple of a thread's 8 draws or not."""
    g = torch.Generator(device=cuda).manual_seed(T)
    p = torch.rand(T, generator=g, device=cuda)
    p[torch.rand(T, generator=g, device=cuda) < 0.3] = 0.0
    F = _pair_tree(p)
    u = torch.rand(N, generator=g, device=cuda)
    u[:1] = 1.0 - 2**-24
    got = _sample_once(F, u)
    _assert_same([got], [ftree_sample_ref(F, u)])
    assert (p[got.long()] > 0).all()


@pytest.mark.parametrize("T", [1024, 65536])
@pytest.mark.parametrize("N", [1, 3, 4097])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_ftree_sample_takes_views_at_any_offset(cuda, T, N, offset):
    """``u01`` as ``u[offset:]`` (4-byte aligned, not 16) and a tree that
    starts ``offset`` floats into its buffer: the head before the first
    16-byte boundary, the whole groups and the tail all equal the plain
    version's draws."""
    g = torch.Generator(device=cuda).manual_seed(T + N)
    p = torch.rand(T, generator=g, device=cuda)
    u = torch.rand(N + offset, generator=g, device=cuda)[offset:]
    F = torch.cat([torch.zeros(offset, device=cuda), _pair_tree(p)])[offset:]
    assert u.is_contiguous() and u.data_ptr() % 16 and F.data_ptr() % 16
    got = _sample_once(F, u)
    _assert_same([got], [ftree_sample_ref(F, u)])


@pytest.mark.parametrize("T", [64, 1024, 65536])
def test_ftree_sample_never_enters_a_zero_mass_subtree(cuda, T):
    """Right subtrees of zero mass at several levels (the root's, and
    deeper ones on the left side), large leaves so that ``u01 = 1 - 2^-24``
    scales to the root's total: the kernel, like the plain version, keeps
    every such draw off a zero-mass leaf."""
    g = torch.Generator(device=cuda).manual_seed(T)
    p = torch.rand(T, generator=g, device=cuda) * 1e8 + 1.0
    for lo, hi in ((T // 2, T), (T // 8, T // 4), (T // 32 + T // 64, T // 16),
                   (T // 32 - 1, T // 32)):
        p[lo:hi] = 0.0
    F = _pair_tree(p)
    u = torch.full((1 << 16,), 1.0 - 2**-24, device=cuda)
    u[::3] = torch.rand(u[::3].shape, generator=g, device=cuda)
    got = _sample_once(F, u)
    _assert_same([got], [ftree_sample_ref(F, u)])
    assert (p[got.long()] > 0).all()


@pytest.mark.parametrize("T", [8, 1024, 16384, 32768, 65536, 1 << 20])
@pytest.mark.parametrize("kind", ["real", "integer"])
def test_ftree_update_equals_plain_version(cuda, T, kind):
    """Duplicates: the kernel adds each node's deltas in update order, so
    it equals the plain version on the CPU bit for bit; integer-valued
    deltas on an integer tree also equal the plain version on the card,
    whose ``index_add_`` adds in another order (the integer tree's
    leaves below 2**24 / T, so that every sum, the root's too, stays an
    exact f32 integer in any order).  Above 32,768 the levels toward the
    leaves are split over CTAs by node range."""
    g = torch.Generator(device=cuda).manual_seed(T)
    K = 70_000
    ts = torch.randint(T, (K,), generator=g, device=cuda, dtype=torch.int32)
    ts[:K // 4] = T // 2
    if kind == "integer":
        F = _pair_tree(torch.randint(0, min(50, 2**24 // T), (T,),
                                     generator=g, device=cuda).float())
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


@pytest.mark.parametrize("T", [1024, 16384, 32768, 65536, 1 << 20])
def test_ftree_update_keeps_the_order_of_the_adds(cuda, T):
    """Deltas 1e8, 1, -1e8 on one leaf first and on another leaf last,
    2**20 random real updates between them: swapping the 1 and the -1e8
    gives other bits at both leaves and the root, and the kernel gives
    the plain version's on the CPU, in k order, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(T)
    K = 1 << 20
    ts = torch.randint(T, (K,), generator=g, device=cuda, dtype=torch.int32)
    d = torch.randn(K, generator=g, device=cuda)
    triple = torch.tensor([1e8, 1.0, -1e8], device=cuda)
    for at, leaf in ((0, 3), (K - 3, T - 5)):
        ts[at:at + 3] = leaf
        d[at:at + 3] = triple
    F = _pair_tree(torch.rand(T, generator=g, device=cuda))
    got = ftree_update_batch(F, ts, d)
    want = ftree_update_ref(F.cpu(), ts.cpu(), d.cpu())
    _assert_same([got.cpu()], [want])
    swapped = d.clone()
    for at in (1, K - 2):
        swapped[[at, at + 1]] = swapped[[at + 1, at]]
    other = ftree_update_ref(F.cpu(), ts.cpu(), swapped.cpu())
    for node in (T + 3, 2 * T - 5, 1):
        assert other[node] != want[node]


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
    with pytest.raises(ValueError, match="power of two"):
        fs_sample.ftree_sample_cuda(torch.zeros(24, device=cuda), u)
    with pytest.raises(ValueError, match="int32"):
        fs_update.ftree_update_cuda(F, torch.zeros(8, dtype=torch.int64,
                                                   device=cuda), u)
    with pytest.raises(ValueError, match="on cpu"):
        fs_update.ftree_update_cuda(F, torch.zeros(8, dtype=torch.int32),
                                    u)
    kw = dict(alpha=0.1, beta=0.01, beta_bar=1.0)
    rows = _score_rows(8192, 4, 0, cuda)      # refused before the deep layout
    _assert_same(ls_mod.lda_scores_cuda(*rows, **kw),
                 lda_scores_draw_ref(*rows, **kw))
    with pytest.raises(ValueError, match="1 to 2"):
        ls_mod.lda_scores_cuda(rows[0][:0], rows[1][:0], rows[2],
                               rows[3][:0], **kw)
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


@pytest.mark.parametrize("r_mode", ["dense", "sparse"])
def test_nomad_fused_equals_scan_at_1024_topics(cuda, r_mode):
    """The fused kernel's nomad chain equals the plain scan's on the card
    at the smoke's T = 1024, two sweeps, both layouts and ring modes
    (``chip_smoke.py``'s small cross-check leaves the scan to this
    test)."""
    corpus, _, _ = make_corpus(num_docs=16, vocab_size=60, num_topics=8,
                               mean_doc_len=8.0, seed=4)
    runs = []
    for kind, ring, inner in (("ragged", "pipelined", "scan"),
                              ("ragged", "barrier", "fused"),
                              ("dense", "pipelined", "fused")):
        lay = build_layout(corpus, n_workers=4, T=1024, n_blocks=8,
                           layout=kind)
        m = NomadLDA(layout=lay, alpha=50.0 / 1024, beta=0.01, device=cuda,
                     inner_mode=inner, ring_mode=ring, r_mode=r_mode)
        a = m.init_arrays(2)
        for s in range(2):
            a = m.sweep(a, s)
        runs.append([lay.extract_canonical(a["z"].cpu().numpy()),
                     *m.global_counts(a)])
    for run in runs[1:]:
        for got, want in zip(run, runs[0]):
            np.testing.assert_array_equal(got, want)


def _lifecycle_model(dev, inner, **kw):
    corpus, _, _ = make_corpus(num_docs=40, vocab_size=90, num_topics=8,
                               mean_doc_len=20.0, seed=5)
    lay = build_layout(corpus, n_workers=4, T=64, n_blocks=8,
                       layout="ragged")
    return NomadLDA(layout=lay, alpha=0.5, beta=0.01, device=dev,
                    inner_mode=inner, ring_mode="pipelined", **kw)


@pytest.mark.parametrize("inner", ["fused", "vectorized"])
def test_resume_on_the_card_equals_straight_and_the_cpu(cuda, inner,
                                                        tmp_path):
    """On the card a run to 3 sweeps equals a run to 1, a rotation
    checkpoint and a resume, and both equal the plain chain on the
    CPU."""
    straight, _ = _lifecycle_model(cuda, inner).run(3, init_seed=1)
    rot = str(tmp_path / "rot")
    _lifecycle_model(cuda, inner, checkpoint_every=1,
                     checkpoint_path=rot).run(1, init_seed=1)
    resumed, _ = _lifecycle_model(cuda, inner, resume_from=rot).run(3)
    plain, _ = _lifecycle_model("cpu", inner).run(3, init_seed=1)
    for key in ("z", "n_td", "n_wt", "n_t"):
        assert resumed[key].is_cuda
        torch.testing.assert_close(resumed[key], straight[key], rtol=0,
                                   atol=0)
        torch.testing.assert_close(resumed[key].cpu(), plain[key], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("inner", ["fused", "vectorized"])
def test_collect_lag_on_the_card_equals_the_cpu(cuda, inner):
    lags = []
    for dev in (cuda, "cpu"):
        m = _lifecycle_model(dev, inner, collect_lag=True)
        lags.append(m.sweep(m.init_arrays(3), 0)["lag"].cpu())
    assert lags[0].shape == (4, 4, 2, 64) and lags[0].dtype == torch.int32
    torch.testing.assert_close(lags[0], lags[1], rtol=0, atol=0)


def test_full_exactness_matrix_on_the_card(cuda):
    """``lda_matrix_check 8 2 full``: the reference's 420 combinations,
    every one exact on the card."""
    from repro_torch.launch import lda_matrix_check
    rep = lda_matrix_check.run_matrix(8, 2, "full", device=cuda)
    assert len(rep["combos"]) == 420
    assert rep["all_exact"], [c for c in rep["combos"]
                              if not lda_matrix_check._exact(c)][:5]
    assert all(s["fused_smem_bytes"] > s["ntd_slab_bytes"]
               for s in rep["slab_smem"])


def test_perplexity_fold_in_equals_the_serial_fold_in(cuda):
    """The perplexity's fold-in, batched through the kernel, equals the
    serial ``fold_in`` on the card; the score is finite and launches the
    kernel."""
    from repro_torch.core import heldout
    held, _, _ = make_corpus(num_docs=24, vocab_size=300, num_topics=8,
                             mean_doc_len=20.0, seed=6)
    r = np.random.default_rng(6)
    n_wt = r.integers(0, 30, (300, 64)).astype(np.int32)
    n_t = n_wt.sum(0)
    phi = heldout._phi_hat(torch.as_tensor(n_wt, device=cuda),
                           torch.as_tensor(n_t, device=cuda), 0.01)
    order = held.doc_order()
    est = order[heldout._positions_in_doc(held.doc_ids[order]) % 2 == 0]
    key = rng.key(4, cuda)
    fold_in_mod.launches = 0
    batched = heldout._fold_in_halves(held.word_ids[est], held.doc_ids[est],
                                      held.num_docs, phi, 0.5, key, 5)
    assert fold_in_mod.launches > 0
    serial = heldout.fold_in(held.word_ids[est], held.doc_ids[est],
                             held.num_docs, phi, 0.5, key, 5)
    torch.testing.assert_close(batched, serial, rtol=0, atol=0)
    ppl = heldout.document_completion_perplexity(
        held, n_wt, n_t, alpha=0.5, beta=0.01, key=key, fold_sweeps=5,
        device=cuda)
    cpu = heldout.document_completion_perplexity(
        held, n_wt, n_t, alpha=0.5, beta=0.01, key=key.cpu(),
        fold_sweeps=5, device="cpu")
    assert np.isfinite(ppl) and ppl == pytest.approx(cpu, rel=1e-6)


def test_store_update_and_carry_on_the_card(cuda, tmp_path):
    """The store phase at a reduced size: the streamed layout equals
    ``build_layout``; a chain carried across a retire-and-add update and
    swept paged and unpaged on the card launches 2·W kernels a sweep,
    keeps the counts equal to ``z`` and equals the same chain on the
    CPU."""
    from repro_torch.data import (CorpusStore, build_layout_from_store,
                                  carry_assignments, update_layout)
    from repro_torch.data.sharding import counts_from_layout
    corpus, _, _ = make_corpus(num_docs=200, vocab_size=400, num_topics=8,
                               mean_doc_len=30.0, seed=7)
    store = CorpusStore.from_corpus(corpus, str(tmp_path / "s"),
                                    tokens_per_shard=1000)
    kw = dict(n_workers=8, T=64, n_blocks=16, layout="ragged", doc_tile=8)
    lay = build_layout_from_store(store, **kw)
    want = build_layout(corpus, **kw)
    for name in ("tok_doc", "tok_wrd", "tok_slot", "doc_tile_of",
                 "canon_idx", "cell_sizes"):
        a, b = getattr(lay, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    r = np.random.default_rng(7)
    ad = np.repeat(np.arange(200, 210, dtype=np.int32), 25)
    aw = r.integers(0, 400, ad.size).astype(np.int32)
    new_lay, o2n = update_layout(lay, add_doc_ids=ad, add_word_ids=aw,
                                 retire=[3, 50, 120], num_new_docs=10)
    runs = []
    for dev, page in ((cuda, 8), (cuda, None), ("cpu", 8)):
        m0 = NomadLDA(layout=lay, alpha=0.5, beta=0.01, device=dev,
                      inner_mode="fused", ring_mode="pipelined",
                      doc_tile=page)
        a = m0.sweep(m0.init_arrays(1), 0)
        z = carry_assignments(lay.extract_canonical(a["z"].cpu().numpy()),
                              o2n, new_lay, seed=1)
        n_td, n_wt, n_t = counts_from_layout(new_lay,
                                             new_lay.place_canonical(z), 64)
        m = NomadLDA(layout=new_lay, alpha=0.5, beta=0.01, device=dev,
                     inner_mode="fused", ring_mode="pipelined",
                     doc_tile=page)
        state = {"z_canon": z, "n_td": n_td.astype(np.int32),
                 "n_wt": n_wt.astype(np.int32), "n_t": n_t.astype(np.int32)}
        a, seed = m.restore_chain_state(state, m._chain_meta(next_seed=1))
        for k in fs_mod.launches:
            fs_mod.launches[k] = 0
        a = m.sweep(a, seed)
        if dev == cuda:
            kernel = "fused_sweep_ragged" + ("_docs" if page else "")
            assert fs_mod.launches[kernel] == 2 * 8
        got = m.global_counts(a)
        want_counts = counts_from_layout(new_lay, a["z"].cpu().numpy(), 64)
        for g, w in zip(got, want_counts):
            np.testing.assert_array_equal(g, w)
        runs.append((f"{dev} doc_tile={page}",
                     [a["z"].cpu().numpy(), *got]))
    for key, run in runs[1:]:
        for g, w in zip(run, runs[0][1]):
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_engine_answers_equal_the_plain_and_serial_fold_in(cuda):
    """``LdaEngine``'s fused answers to 8 Zipf documents (one empty) at
    T = 1024 equal the plain ``fold_in_batch`` engine's, and the two
    shortest documents equal the serial ``fold_in``: the checks that
    ``chip_smoke.py``'s serving phase leaves to this test, at shorter
    documents."""
    from repro_torch.core.heldout import fold_in
    from repro_torch.serve.lda_engine import (LdaEngine, TopicQuery,
                                              snapshot_from_counts)
    r = np.random.default_rng(8)
    J, T = 5000, 1024
    n_wt = r.integers(0, 5, (J, T)).astype(np.int32)
    snap = snapshot_from_counts(n_wt, n_wt.sum(0), alpha=50.0 / T,
                                beta=0.01)
    zipf = np.cumsum(1.0 / np.arange(1, J + 1))
    zipf /= zipf[-1]
    docs = [np.searchsorted(zipf, r.random(n)).astype(np.int32)
            for n in (17, 128, 3, 0, 64, 90, 1, 40)]
    fused = LdaEngine(snap, device=cuda).query(TopicQuery(docs=tuple(docs)))
    scan = LdaEngine(snap, inner_mode="scan", device=cuda).query(
        TopicQuery(docs=tuple(docs)))
    np.testing.assert_array_equal(fused.n_td, scan.n_td)
    np.testing.assert_array_equal(fused.theta, scan.theta)
    pick = sorted((i for i, d in enumerate(docs) if d.size),
                  key=lambda i: docs[i].size)[:2]
    phi = torch.as_tensor(snap.phi, device=cuda)
    serial = fold_in(np.concatenate([docs[i] for i in pick]),
                     np.repeat(pick, [docs[i].size for i in pick]),
                     max(pick) + 1, phi, snap.alpha, rng.key(0, cuda),
                     20).cpu().numpy()
    np.testing.assert_array_equal(serial[pick], fused.n_td[pick])


# --------------------------------------------------------------------------
# The baseline samplers (core/samplers.py, sparse_lda.py, alias_lda.py):
# plain PyTorch on the card, held to the same code on the CPU bit for bit;
# the F+tree draw of a 1-D batch goes through the ftree_sample kernel.
# --------------------------------------------------------------------------
def _to(state, dev):
    return type(state)(*(x.to(dev) for x in state))


def _same_tuple(got, want):
    for k, g, w in zip(want._fields, got, want):
        assert torch.equal(g.cpu(), w.cpu()), k


@pytest.mark.parametrize("name", ["lsearch", "bsearch", "alias", "ftree"])
def test_samplers_on_the_card_equal_the_cpu(cuda, name):
    """At T = 16,384: ``init``, 4,003 draws in one batch, a scalar draw,
    a 40 × 100 batch and 40 updates in sequence (one rebuild for Alias)
    on the card equal the same calls on the CPU; the F+tree's draws launch
    the kernel once a call and equal ``ftree_sample_ref``."""
    from repro_torch.core import samplers
    from torch_baseline_cases import sampler_row, u_grid, update_seq
    T = 16_384
    init, draw, update = samplers.SAMPLERS[name]
    p = torch.as_tensor(sampler_row(1, T))
    u = torch.as_tensor(u_grid(n=2000, seed=3))        # 4,003 uniforms
    states = {dev: init(p.to(dev)) for dev in ("cpu", cuda)}
    _same_tuple(states[cuda], states["cpu"])
    before = fs_sample.launches
    z = draw(states[cuda], u.to(cuda))
    assert torch.equal(z.cpu(), draw(states["cpu"], u))
    if name == "ftree":
        assert fs_sample.launches == before + 1
        assert torch.equal(z, ftree_sample_ref(states[cuda].F, u.to(cuda)))
    # A scalar and a 2-D batch: the same draws, each one launch on a tree.
    for shaped in (u[-1], u[:4000].reshape(40, 100)):
        before = fs_sample.launches
        z = draw(states[cuda], shaped.to(cuda))
        assert z.shape == shaped.shape and z.dtype == torch.int32
        assert torch.equal(z.cpu(), draw(states["cpu"], shaped))
        if name == "ftree":
            assert fs_sample.launches == before + 1
    ts, ds = update_seq(1, T, n=1 if name == "alias" else 40)
    for dev in ("cpu", cuda):
        for t, d in zip(ts.tolist(), ds.tolist()):
            if name == "alias":
                states[dev] = samplers.alias_update(states[dev], t, d,
                                                    p=p.to(dev))
            else:
                states[dev] = update(states[dev], t, d)
    _same_tuple(states[cuda], states["cpu"])
    assert torch.equal(draw(states[cuda], u.to(cuda)).cpu(),
                       draw(states["cpu"], u))


@pytest.mark.parametrize("kind,T", [("sparse", 64), ("sparse", 1024),
                                    ("alias", 64), ("alias", 1024)])
def test_baseline_sweeps_on_the_card_equal_the_cpu(cuda, kind, T):
    """Two sweeps of SparseLDA (bucket stats) or AliasLDA (``num_mh=2``,
    MH stats) on the card equal the same sweeps on the CPU: ``z``, the
    counts and the key, the stats, the invariants clean."""
    from repro_torch.core import cgs
    from repro_torch.core.alias_lda import sweep_alias_lda
    from repro_torch.core.sparse_lda import sweep_sparse_lda
    corpus, _, _ = make_corpus(num_docs=30, vocab_size=200, num_topics=8,
                               mean_doc_len=20.0, seed=4)
    order = corpus.doc_order()
    out = {}
    for dev in ("cpu", cuda):
        state = cgs.init_state(corpus, T, rng.key(2, dev))
        for _ in range(2):
            if kind == "sparse":
                state, stats = sweep_sparse_lda(
                    state, corpus.doc_ids, corpus.word_ids, order, 50.0 / T,
                    0.01, return_bucket_stats=True)
            else:
                state, stats = sweep_alias_lda(
                    state, corpus.doc_ids, corpus.word_ids, order, 50.0 / T,
                    0.01, num_mh=2, return_mh_stats=True)
        out[dev] = (state, stats)
        assert not any(cgs.check_invariants(state, corpus).values())
    _same_tuple(out[cuda][0], out["cpu"][0])
    assert torch.equal(out[cuda][1].cpu(), out["cpu"][1])


def test_baseline_contraction_sites_on_the_card(cuda):
    """The one-token flip cases, each pinned to the reference on the
    CPU, draw the reference's topic on the card."""
    from repro_torch.core.alias_lda import sweep_alias_lda
    from repro_torch.core.sparse_lda import sweep_sparse_lda
    from torch_baseline_cases import (ALIAS_FLIP_CASES, BETA,
                                      SPARSE_FLIP_CASES, forced_uniforms,
                                      one_token_state)
    for case in SPARSE_FLIP_CASES.values():
        with forced_uniforms(case["u01"]):
            s, b = sweep_sparse_lda(one_token_state(case, cuda), [0], [0],
                                    [0], case["alpha"], BETA,
                                    return_bucket_stats=True)
        assert (int(s.z[0]), int(b[0])) == (case["want"], case["bucket"])
    for case in ALIAS_FLIP_CASES.values():
        with forced_uniforms(case["u01"], case["u_acc"], case["u_prop"]):
            s = sweep_alias_lda(one_token_state(case, cuda), [0], [0], [0],
                                case["alpha"], BETA, num_mh=1)
        assert int(s.z[0]) == case["want"]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_zoo_smoke_arch_on_the_card_equals_the_cpu(cuda, name):
    """Logits within 1e-4 of the CPU's (of the largest |logit|); for the
    causal archs prefill plus decode within 2e-3 of the forward on the
    card, and ``generate`` the same tokens on both devices (up to a
    margin the logit difference explains).  Raises on a failed check."""
    rep = zoo_serve_check.smoke_arch(name, cuda)
    assert rep["forward_rel"] <= zoo_serve_check.TOL


def test_zoo_moe_overflow_on_the_card_equals_the_cpu(cuda):
    """64 tokens so alike that each picks the same two of 4 experts: 24
    choices of each dropped at capacity 40.  Experts and dispatch equal
    to the CPU's, the output within 1e-4."""
    cfg = get_config("deepseek-moe-16b-smoke")
    card = moe_mod.MoE(torch.Generator(device=cuda).manual_seed(0), cfg,
                       torch.float32, cuda)
    cpu = moe_mod.MoE(torch.Generator(), cfg, torch.float32, "cpu")
    cpu.load_state_dict(card.state_dict())
    r = np.random.default_rng(11)
    x = (r.standard_normal((1, 1, cfg.d_model)) + 1e-3 *
         r.standard_normal((4, 16, cfg.d_model))).astype(np.float32)
    xc = torch.as_tensor(x)
    xf = xc.reshape(-1, cfg.d_model)
    cap = moe_mod.capacity(xf.shape[0], cfg)
    e_cpu = moe_mod.route(cpu, cfg, xf)[1]
    e_card = moe_mod.route(card, cfg, xf.to(cuda))[1]
    assert torch.equal(e_card.cpu(), e_cpu)
    d_cpu = moe_mod.dispatch_indices(e_cpu, cfg.num_experts, cap)
    d_card = moe_mod.dispatch_indices(e_card, cfg.num_experts, cap)
    for g, w in zip(d_card, d_cpu):
        assert torch.equal(g.cpu(), w)
    assert int((~d_cpu[2]).sum()) == 48
    y_card, aux_card = card(xc.to(cuda))
    y_cpu, aux_cpu = cpu(xc)
    scale = float(y_cpu.abs().max())
    assert float((y_card.cpu() - y_cpu).abs().max()) <= 1e-4 * scale
    assert abs(float(aux_card) - float(aux_cpu)) <= 1e-4 * abs(
        float(aux_cpu))


# --------------------------------------------------------------------------
# The zoo's training path: plain PyTorch, no kernel of ours.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_zoo_train_step_on_the_card_equals_the_cpu(cuda, name):
    """At smoke size: the loss within 1e-5 relative, each gradient within
    1e-4 of its largest |value|, and one AdamW step's grad norm within
    1e-5, on the card against the same weights on the CPU.  Raises on a
    failed check."""
    rep = zoo_train_check.smoke_arch(name, cuda)
    assert rep["grad_rel"] <= zoo_train_check.GRAD_TOL


def test_zoo_ep_check_in_lock_step_on_the_card(cuda):
    """``ep_check`` at smoke size: M = 4 ranks in lock step on the card
    against ``moe_forward``, both at capacity factor 8.0."""
    rep = ep_check.run(4, cuda)
    assert rep["form"] == "lockstep" and rep["agree"], rep


@pytest.mark.parametrize("name", ["qwen3-8b", "mamba2-1.3b",
                                  "zamba2-2.7b"])
def test_zoo_layer_remat_loss_equals_the_forward_on_the_card(cuda, name):
    """The loss of a step under per-layer remat equals ``loss_fn`` under
    ``no_grad`` bit for bit: recomputation leaves the forward alone."""
    from repro_torch.train import train_step as ts
    cfg = get_config(name + "-smoke")
    state = ts.init_train_state(cfg, torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    tok = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32), device=cuda)
    with torch.no_grad():
        want = ts.loss_fn(state.params, cfg, {"tokens": tok},
                          chunked_ce=True)[0]
    (got, _), _ = ts.value_and_grad(state.params, cfg, {"tokens": tok},
                                    layer_remat=True, chunked_ce=True)
    assert float(got) == float(want)
