"""The port's batched F+tree kernel modules (``repro_torch/kernels/
ftree_sample`` and ``ftree_update``) against the JAX reference, on the
CPU where the ops run the plain version: draws and updated trees bit-equal
to ``ftree_sample_pallas`` / ``ftree_update_pallas`` in interpret mode and
to ``ftree.sample_batch`` / ``ftree.update_batch``.  The update is bit-equal
with real deltas too: every node adds its deltas in the order of the
updates in all four, and so does the CUDA kernel."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ftree as jft
from repro.kernels.ftree_sample import ftree_sample as j_sample
from repro.kernels.ftree_sample.ftree_sample import ftree_sample_pallas
from repro.kernels.ftree_update.ftree_update import ftree_update_pallas
from repro_torch.core import ftree
from repro_torch.kernels.ftree_sample import ftree_sample
from repro_torch.kernels.ftree_update import ftree_update_batch

# The packages export the ops under their wrapper modules' names.
fs_mod = importlib.import_module(
    "repro_torch.kernels.ftree_sample.ftree_sample")
fu_mod = importlib.import_module(
    "repro_torch.kernels.ftree_update.ftree_update")


def _tree(T, seed, zero=0.3, pad=0, scale=1.0):
    """A reference-built tree over ``T - pad`` random leaves, a share of
    them zero, zero-padded to ``T``."""
    r = np.random.default_rng(seed)
    p = ((r.random(T - pad) + 0.01) * scale).astype(np.float32)
    p[r.random(T - pad) < zero] = 0.0
    return np.asarray(jft.build(jft.pad_pow2(jnp.asarray(p)))), p


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("T", [8, 1024])
@pytest.mark.parametrize("pad", [0, 3])
def test_sample_matches_reference(T, pad):
    F, p = _tree(T, T + pad, pad=pad)
    u = np.random.default_rng(pad).random(2048).astype(np.float32)
    u[:3] = [0.0, 1.0 - 1e-7, np.nextafter(np.float32(1), np.float32(0))]
    got = ftree_sample(torch.tensor(F), torch.as_tensor(u))
    assert got.dtype == torch.int32
    kernel = ftree_sample_pallas(jnp.asarray(F), jnp.asarray(u),
                                 interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kernel))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jft.sample_batch(jnp.asarray(F),
                                                 jnp.asarray(u))))
    assert (p[got.numpy()] > 0).all()


def test_sample_u01_edge_on_padded_tree():
    """``tests/test_kernels.py``'s edge: ``u01 → 1`` on a zero-padded tree
    with a large total lands on a positive leaf, as the reference does;
    any N, through the reference's padding op."""
    F, p = _tree(512, 5, zero=0.0, pad=212, scale=1e8)
    u = np.array([1.0 - 1e-7, np.nextafter(np.float32(1), np.float32(0)),
                  1.0], np.float32)
    got = ftree_sample(torch.as_tensor(F), torch.as_tensor(u)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_sample(
        jnp.asarray(F), jnp.asarray(u))))
    assert (got < 300).all()


@pytest.mark.parametrize("T", [8, 1024])
@pytest.mark.parametrize("kind", ["real", "integer"])
def test_update_matches_reference(T, kind):
    """Duplicate leaves (and so shared ancestors), real or integer-valued
    deltas: bit-equal; the given tree is not changed."""
    r = np.random.default_rng(T)
    if kind == "integer":
        F = np.asarray(jft.build(jnp.asarray(
            r.integers(0, 50, T).astype(np.float32))))
        d = r.integers(-3, 4, 3000).astype(np.float32)
    else:
        F, _ = _tree(T, 1)
        d = (r.standard_normal(3000) * 10.0 ** r.integers(-3, 2, 3000)
             ).astype(np.float32)
    ts = r.integers(0, T, 3000).astype(np.int32)
    ts[:40] = 3 % T
    F_t = torch.as_tensor(F.copy())
    got = ftree_update_batch(F_t, torch.as_tensor(ts), torch.as_tensor(d))
    assert torch.equal(F_t, torch.as_tensor(F))
    kernel = ftree_update_pallas(jnp.asarray(F), jnp.asarray(ts),
                                 jnp.asarray(d), interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(kernel))
    np.testing.assert_array_equal(
        _bits(got), _bits(jft.update_batch(jnp.asarray(F), jnp.asarray(ts),
                                           jnp.asarray(d))))
    np.testing.assert_array_equal(
        _bits(got), _bits(ftree.update_batch(torch.as_tensor(F),
                                             torch.as_tensor(ts),
                                             torch.as_tensor(d))))


def test_cuda_wrappers_refuse_cpu_tensors_and_large_trees():
    F = torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA"):
        fs_mod.ftree_sample_cuda(F, torch.zeros(4))
    with pytest.raises(ValueError, match="CUDA"):
        fu_mod.ftree_update_cuda(F, torch.zeros(4, dtype=torch.int32),
                                 torch.zeros(4))
    fs_mod.check_fits(16384)
    with pytest.raises(ValueError, match="shared memory"):
        fs_mod.check_fits(32768)
    fu_mod.check_fits(32768)
    with pytest.raises(ValueError, match="shared memory"):
        fu_mod.check_fits(65536)
    with pytest.raises(ValueError, match="power of two"):
        fs_mod.check_fits(12)
    assert fs_mod.launches == 0 and fu_mod.launches == 0


def test_ops_refuse_inputs_on_another_device():
    """A batch on another device than the tree is refused, not copied
    over to the tree's device (``meta`` stands in for the card here)."""
    F = torch.tensor(_tree(8, 0)[0])
    other = lambda dtype: torch.zeros(4, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="u01 is on meta"):
        ftree_sample(F, other(torch.float32))
    with pytest.raises(ValueError, match="ts is on meta"):
        ftree_update_batch(F, other(torch.int32), torch.zeros(4))
    with pytest.raises(ValueError, match="deltas is on meta"):
        ftree_update_batch(F, torch.zeros(4, dtype=torch.int32),
                           other(torch.float32))
