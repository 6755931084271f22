"""Float order and the guarded draw: ``repro_torch.numerics.
blocked_cumsum`` and ``repro_torch.core.samplers.lsearch_guarded`` against
the JAX reference, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.samplers import lsearch_guarded as lsearch_ref
from repro_torch.core.samplers import lsearch_guarded
from repro_torch.numerics import blocked_cumsum

_jcumsum = jax.jit(lambda x: jnp.cumsum(x, axis=-1))


def _mixed_rows(n, rows=8, seed=0):
    """f32 rows whose entries span ten orders of magnitude, where the
    order of the adds shows in the last bits."""
    r = np.random.default_rng(seed + n)
    mag = 10.0 ** r.integers(-6, 4, (rows, n))
    return (r.random((rows, n)) * mag).astype(np.float32)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 33, 64, 1000, 1024, 4096])
def test_blocked_cumsum_matches_jnp_cumsum(n):
    x = _mixed_rows(n)
    want = np.asarray(_jcumsum(x))
    got = blocked_cumsum(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_blocked_cumsum_along_leading_dim():
    x = _mixed_rows(300, rows=3)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=0))(x.T))
    got = blocked_cumsum(torch.as_tensor(x.T), dim=0).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_torch_cumsum_does_not_match_at_1024():
    """The pin on the order: were torch.cumsum's order the reference's,
    the port would not need blocked_cumsum.  A change to either side
    that makes them agree must be looked at, not taken as a gain."""
    x = _mixed_rows(1024)
    want = np.asarray(_jcumsum(x))
    got = torch.cumsum(torch.as_tensor(x), dim=-1).numpy()
    assert not np.array_equal(got.view(np.uint32), want.view(np.uint32))


U_BOUNDARY = [0.0, 0.5, 1.0 - 2.0**-24, 1.0 - 2.0**-22]


@pytest.mark.parametrize("u01", U_BOUNDARY)
def test_lsearch_guarded_matches_reference(u01):
    """Rows with zero-mass runs, a leading zero block, a single positive
    entry and all zeros, at the boundary uniforms the reference pins."""
    r = np.random.default_rng(4)
    p = r.random((6, 64)).astype(np.float32)
    p[0, 40:] = 0.0
    p[1, :50] = 0.0
    p[2] = 0.0
    p[2, 17] = 3.0
    p[3] = 0.0
    p[4, ::2] = 0.0
    c = np.array(_jcumsum(p))
    u = (np.float32(u01) * c[:, -1]).astype(np.float32)
    want = np.asarray(jax.vmap(lsearch_ref)(jnp.asarray(c), jnp.asarray(u)))
    got = lsearch_guarded(torch.as_tensor(c), torch.as_tensor(u)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[3] == 0 and got[2] == 17          # zero row; lone topic
