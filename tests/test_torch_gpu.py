"""The CUDA fold-in kernel on the card, against its plain PyTorch version
on the same draws.  Needs an NVIDIA GPU (``gpu`` marker; skips without
one).  Imports neither ``jax`` nor ``repro``, so it runs on a machine
with PyTorch for CUDA alone:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.core.heldout import doc_fold_key
from repro_torch.kernels.fold_in import (fold_in_draws, fold_in_fused,
                                         fold_in_kernel_ref)
from repro_torch.kernels.fold_in import fold_in as fold_in_mod
from torch_fold_in_cases import total_rounding_case

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
