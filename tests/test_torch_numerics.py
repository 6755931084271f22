"""Float order and the guarded draw: ``repro_torch.numerics.
blocked_cumsum`` and ``repro_torch.core.samplers.lsearch_guarded`` against
the JAX reference, bit for bit; ``numerics.fma`` against exact rational
arithmetic."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.samplers import lsearch_guarded as lsearch_ref
from repro_torch.core.samplers import lsearch_guarded
from repro_torch.numerics import blocked_cumsum, fma

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


def _fma_exact(a, b, c):
    """a*b + c rounded once to f32, from exact rationals: the nearest f32
    to the exact value, ties to even."""
    from fractions import Fraction
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    g = np.float32(float(x))
    best = None
    for cand in (np.nextafter(g, np.float32(-np.inf)), g,
                 np.nextafter(g, np.float32(np.inf))):
        key = (abs(Fraction(float(cand)) - x),
               int(np.array(cand).view(np.uint32)) & 1)
        if best is None or key < best[0]:
            best = (key, cand)
    return np.float32(best[1])


def test_fma_where_double_rounding_bites():
    """a*b + c = 1 + 2^-24 + 2^-54: the f64 sum rounds to the midpoint
    1 + 2^-24, and its cast to f32 rounds to even (1.0); the single
    rounding gives 1 + 2^-23."""
    a = np.float32(1 + 2.0**-15)
    b = np.float32(-(2.0**-24) * (1 - 2.0**-15))
    c = np.float32(1 + 2.0**-23)
    twice = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    once = _fma_exact(a, b, c)
    assert twice != once and once == np.float32(1 + 2.0**-23)
    assert float(fma(a, b, c)) == once


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_fma_is_correctly_rounded(seed):
    """Random mixed-magnitude f32 triples, and triples built near f32
    midpoints, against exact rational arithmetic."""
    r = np.random.default_rng(seed)
    a, b, c = (r.standard_normal((3, 64)) * 10.0 ** r.integers(-8, 8, (3, 64))
               ).astype(np.float32)
    # c = -(a*b) + a small offset: the sum cancels to its low bits
    c[::4] = (-(a[::4].astype(np.float64) * b[::4])).astype(np.float32)
    got = fma(torch.as_tensor(a), torch.as_tensor(b),
              torch.as_tensor(c)).numpy()
    want = np.array([_fma_exact(x, y, z) for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
