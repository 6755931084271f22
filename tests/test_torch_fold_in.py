"""The port's fold-in chain and its kernel module against the JAX
reference: draws, the plain kernel version, the padded batch and the
serial path, bit for bit.  The CUDA kernel itself runs only on a card:
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heldout as ref_heldout
from repro.kernels.fold_in import fold_in_draws as ref_draws
from repro.kernels.fold_in import fold_in_kernel_ref as ref_kernel_ref
from repro_torch import rng
from repro_torch.convert import key_from_reference
from repro_torch.core.heldout import doc_fold_key, fold_in, fold_in_batch
from repro_torch.kernels.fold_in import (fold_in_draws, fold_in_fused,
                                         fold_in_kernel_ref)
from repro_torch.kernels.fold_in import fold_in as fold_in_mod
from torch_fold_in_cases import total_rounding_case

J = 97
ALPHA = 0.375


def _phi(T, seed=11, zero_rows=(3, 8)):
    """A mixed-magnitude φ with some all-zero rows."""
    r = np.random.default_rng(seed)
    phi = (r.random((J, T)) * 10.0 ** r.integers(-4, 1, (J, T))).astype(
        np.float32)
    phi[list(zero_rows)] = 0.0
    return phi


def _batch(lengths, L, seed=0, zero_word=3):
    """(D, L) word ids and mask; row 0's tokens hit an all-zero φ row."""
    r = np.random.default_rng(seed)
    D = len(lengths)
    w = r.integers(0, J, (D, L)).astype(np.int32)
    w[0, ::2] = zero_word
    v = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
    return w, v


def _ref_keys(seed, D):
    return jax.vmap(ref_heldout.doc_fold_key, in_axes=(None, 0))(
        jax.random.key(seed), jnp.arange(D, dtype=jnp.int32))


def _port_keys(ref_keys):
    return key_from_reference(np.asarray(jax.random.key_data(ref_keys)),
                              "cpu")


def _t(a):
    return torch.as_tensor(np.array(a))


SHAPES = [  # T, lengths, L, sweeps
    (16, [0, 1, 5, 12], 16, 3),
    (48, [7, 0, 30, 2], 32, 2),        # T not a power of two
    (64, [64, 17, 0, 63, 1, 40, 64, 9], 64, 3),
]


@pytest.mark.parametrize("T,lengths,L,sweeps", SHAPES)
def test_draws_match_reference(T, lengths, L, sweeps):
    keys = _ref_keys(1, len(lengths))
    z0_ref, u_ref = ref_draws(keys, L, T, sweeps)
    z0, u = fold_in_draws(_port_keys(keys), L, T, sweeps)
    assert z0.dtype == torch.int32 and u.dtype == torch.float32
    np.testing.assert_array_equal(z0.numpy(), np.asarray(z0_ref))
    np.testing.assert_array_equal(u.numpy().view(np.uint32),
                                  np.asarray(u_ref).view(np.uint32))


@pytest.mark.parametrize("T,lengths,L,sweeps", SHAPES)
def test_kernel_ref_matches_reference(T, lengths, L, sweeps):
    """Same draws in, same counts out: padded and empty rows, and tokens
    on all-zero φ rows."""
    phi = _phi(T)
    w, v = _batch(lengths, L)
    z0, u = ref_draws(_ref_keys(2, len(lengths)), L, T, sweeps)
    want = np.asarray(ref_kernel_ref(jnp.asarray(w), jnp.asarray(v), z0, u,
                                     ALPHA, jnp.asarray(phi)))
    got = fold_in_kernel_ref(_t(w), _t(v), _t(z0), _t(u), ALPHA, _t(phi))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.sum(1).numpy(), np.asarray(lengths))


@pytest.mark.parametrize("T,lengths,L,sweeps", SHAPES)
def test_fold_in_batch_matches_reference(T, lengths, L, sweeps):
    phi = _phi(T)
    w, v = _batch(lengths, L, seed=3)
    keys = _ref_keys(3, len(lengths))
    want = np.asarray(ref_heldout.fold_in_batch(
        jnp.asarray(w), jnp.asarray(v), jnp.asarray(phi), ALPHA, keys,
        sweeps))
    got = fold_in_batch(_t(w), _t(v), _t(phi), ALPHA, _port_keys(keys),
                        sweeps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("T", [16, 48])
def test_serial_fold_in_matches_reference(T):
    """Interleaved tokens of three documents, one of them on a zero φ
    row, through the serial path of both packages."""
    phi = _phi(T)
    r = np.random.default_rng(5)
    doc_ids = r.integers(0, 3, 40).astype(np.int32)
    word_ids = r.integers(0, J, 40).astype(np.int32)
    word_ids[doc_ids == 2] = 8
    want = np.asarray(ref_heldout.fold_in(
        jnp.asarray(word_ids), jnp.asarray(doc_ids), 4, jnp.asarray(phi),
        ALPHA, jax.random.key(6), 2))
    got = fold_in(word_ids, doc_ids, 4, _t(phi), ALPHA,
                  rng.key(6, "cpu"), 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[3].sum() == 0


def test_cdf_total_rounding_matches_reference():
    """One token whose draw depends on how cdf[T-1] is rounded: end
    counts of longer chains hardly ever expose a scan in the wrong order,
    this one does."""
    row, u, want = total_rounding_case(alpha=ALPHA)
    phi = np.stack([row, row[::-1]])
    w = np.zeros((1, 1), np.int32)
    v = np.ones((1, 1), bool)
    z0 = np.full((1, 1), 5, np.int32)
    u = np.full((1, 1, 1), u, np.float32)
    ref = np.asarray(ref_kernel_ref(*map(jnp.asarray, (w, v, z0, u)),
                                    ALPHA, jnp.asarray(phi)))
    got = fold_in_kernel_ref(_t(w), _t(v), _t(z0), _t(u), ALPHA, _t(phi))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[0, want] == 1 and ref.sum() == 1


def test_batched_equals_serial_in_port():
    T, L, sweeps = 48, 16, 3
    phi = _t(_phi(T))
    docs = [np.random.default_rng(i).integers(0, J, n).astype(np.int32)
            for i, n in enumerate([5, 1, 16, 9])]
    key = rng.key(4, "cpu")
    w = np.zeros((len(docs), L), np.int32)
    v = np.zeros((len(docs), L), bool)
    for i, d in enumerate(docs):
        w[i, :d.size], v[i, :d.size] = d, True
    batched = fold_in_batch(_t(w), _t(v), phi, ALPHA,
                            doc_fold_key(key, torch.arange(len(docs))),
                            sweeps)
    serial = fold_in(np.concatenate(docs),
                     np.repeat(np.arange(len(docs)), [d.size for d in docs]),
                     len(docs), phi, ALPHA, key, sweeps)
    np.testing.assert_array_equal(batched.numpy(), serial.numpy())


def test_padding_garbage_is_inert():
    """Out-of-range and negative ids in padded slots change nothing."""
    T, L = 16, 16
    phi = _t(_phi(T))
    w, v = _batch([4, 9, 0], L, seed=7)
    keys = doc_fold_key(rng.key(1, "cpu"), torch.arange(3))
    clean = fold_in_fused(_t(w), _t(v), phi, ALPHA, keys, 2)
    w[~v] = np.random.default_rng(8).integers(-3 * J, 3 * J, (~v).sum())
    dirty = fold_in_fused(_t(w), _t(v), phi, ALPHA, keys, 2)
    np.testing.assert_array_equal(clean.numpy(), dirty.numpy())


def test_fused_on_cpu_runs_plain_version():
    T, L, sweeps = 64, 32, 2
    phi = _t(_phi(T))
    w, v = _batch([32, 3, 0, 20], L, seed=9)
    keys = doc_fold_key(rng.key(2, "cpu"), torch.arange(4))
    before = fold_in_mod.launches
    got = fold_in_fused(_t(w), _t(v), phi, ALPHA, keys, sweeps)
    assert fold_in_mod.launches == before
    z0, u = fold_in_draws(keys, L, T, sweeps)
    plain = fold_in_kernel_ref(_t(w), _t(v), z0, u, ALPHA, phi)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(
        got.numpy(), fold_in_batch(_t(w), _t(v), phi, ALPHA, keys,
                                   sweeps).numpy())


def test_fused_validates_shapes():
    phi = _t(_phi(16))
    w, v = _batch([3, 4], 8)
    keys = doc_fold_key(rng.key(0, "cpu"), torch.arange(2))
    with pytest.raises(ValueError, match="matching"):
        fold_in_fused(_t(w), _t(v[:, :4]), phi, ALPHA, keys)
    with pytest.raises(ValueError, match="keys"):
        fold_in_fused(_t(w), _t(v), phi, ALPHA, keys[:1])
    with pytest.raises(ValueError, match="sweeps"):
        fold_in_fused(_t(w), _t(v), phi, ALPHA, keys, 0)


def test_cuda_wrapper_refuses_cpu_tensors():
    w = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fold_in_mod.fold_in_cuda(w, w, w, torch.zeros((2, 8)), ALPHA,
                                 torch.ones((4, 16)))


def test_shared_memory_bound():
    """The bound that replaces the TPU VMEM guard: the paper's T=1024
    fits the longest clipped document (L=2048), far longer rows do not,
    and neither does T past one thread per 16-topic block."""
    fold_in_mod.check_fits(2048, 1024)
    assert fold_in_mod.fold_in_smem_bytes(2048, 1024) == 4 * (
        2 * (1024 + 64) + 4 * 2048 + 66 + 64 + 4)
    with pytest.raises(ValueError, match="shared memory"):
        fold_in_mod.check_fits(16384, 1024)
    with pytest.raises(ValueError, match="topics"):
        fold_in_mod.check_fits(8, 16 * 1024 + 1)
