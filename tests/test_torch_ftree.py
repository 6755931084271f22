"""The port's F+tree (``repro_torch/core/ftree.py``) against
``repro/core/ftree.py`` under ``jit`` (the rounding the chain runs with),
bit for bit, on hypothesis-drawn trees and the boundary uniforms of
``tests/test_sampler_boundaries.py``: 1 − 2⁻²², 1 − 2⁻²⁴, and trees with
zero-mass leaves and subtrees."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import ftree as jft
from repro_torch.core import ftree

U_BOUNDARY = [0.0, 0.5, 1.0 - 2.0**-22, 1.0 - 2.0**-24]
_jbuild = jax.jit(jft.build)
_jsample = jax.jit(jax.vmap(jft.sample))
_jset_leaf = jax.jit(jax.vmap(jft.set_leaf))
_jupdate = jax.jit(jax.vmap(jft.update))


def _leaves(seed, T, rows=6, zero_frac=0.3):
    """Mixed-magnitude f32 parameters with zero runs: one row zero from
    the middle on, one all zero but one leaf, one with a zero right half."""
    r = np.random.default_rng(seed)
    p = (r.random((rows, T)) * 10.0 ** r.integers(-6, 4, (rows, T))
         ).astype(np.float32)
    p[r.random((rows, T)) < zero_frac] = 0.0
    p[0, T // 2:] = 0.0
    p[1] = 0.0
    p[1, T // 3] = 2.5
    p[2, T // 2:] = 0.0
    return p


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), logT=st.integers(0, 10))
def test_build_matches_jit_build(seed, logT):
    p = _leaves(seed, 1 << logT)
    _eq(ftree.build(torch.as_tensor(p)), jax.vmap(_jbuild)(p))


def test_build_root_is_not_the_sum_of_its_children():
    """Under ``jit`` the reference's root is one reduction over the leaves
    (runs of 32, then the run totals), not ``F[2] + F[3]``; a row where
    the two differ pins the port to the first."""
    r = np.random.default_rng(1)
    for _ in range(100):
        p = (r.random(64) * 10.0 ** r.integers(-3, 3, 64)).astype(
            np.float32)
        F = ftree.build(torch.as_tensor(p))
        if F[1] != F[2] + F[3]:
            _eq(F, _jbuild(p))
            return
    pytest.fail("no row where the root differs from F[2] + F[3]")


def test_build_refuses_what_is_not_pinned():
    with pytest.raises(ValueError, match="power of two"):
        ftree.build(torch.ones(6))
    with pytest.raises(ValueError, match="1024"):
        ftree.build(torch.ones(2048))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), logT=st.integers(1, 10),
       u_pick=st.integers(0, 3))
def test_sample_matches_reference(seed, logT, u_pick):
    T = 1 << logT
    p = _leaves(seed, T)
    F = jax.vmap(_jbuild)(p)
    r = np.random.default_rng(seed)
    u = r.random(p.shape[0]).astype(np.float32)
    u[::2] = U_BOUNDARY[u_pick]
    want = np.asarray(_jsample(F, jnp.asarray(u)))
    got = ftree.sample(torch.as_tensor(np.asarray(F)), torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(), want)
    nz = p.sum(1) > 0
    assert (p[nz, got.numpy()[nz]] > 0).all()     # never a zero leaf


@pytest.mark.parametrize("u01", U_BOUNDARY)
def test_sample_batch_at_the_boundary_uniforms(u01):
    p = _leaves(3, 64)[0]
    F = _jbuild(p)
    u = np.full(5, u01, np.float32)
    want = np.asarray(jft.sample_batch(F, jnp.asarray(u)))
    got = ftree.sample_batch(torch.as_tensor(np.asarray(F)),
                             torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(), want)
    assert p[got.numpy()].min() > 0


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), logT=st.integers(1, 8))
def test_update_and_set_leaf_match_reference(seed, logT):
    T = 1 << logT
    r = np.random.default_rng(seed)
    p = _leaves(seed, T)
    F = np.asarray(jax.vmap(_jbuild)(p))
    t = r.integers(0, T, p.shape[0])
    v = (r.random(p.shape[0]) * 10.0 ** r.integers(-6, 4, p.shape[0])
         ).astype(np.float32)
    Ft = torch.as_tensor(F)
    _eq(ftree.set_leaf(Ft, torch.as_tensor(t), torch.as_tensor(v)),
        _jset_leaf(F, t, v))
    _eq(ftree.update(Ft, torch.as_tensor(t), torch.as_tensor(-v)),
        _jupdate(F, t, -v))


def test_update_batch_accumulates_duplicates_in_order():
    r = np.random.default_rng(2)
    F = np.asarray(_jbuild(_leaves(2, 64)[3]))
    ts = np.concatenate([r.integers(0, 64, 30), [5, 5, 5, 9, 9]])
    d = r.standard_normal(ts.shape[0]).astype(np.float32)
    want = np.asarray(jax.jit(jft.update_batch)(F, ts, d))
    _eq(ftree.update_batch(torch.as_tensor(F), torch.as_tensor(ts),
                           torch.as_tensor(d)), want)


def test_small_helpers():
    assert ftree.depth(1024) == jft.depth(1024) == 10
    p = np.arange(1, 6, dtype=np.float32)
    _eq(ftree.pad_pow2(torch.as_tensor(p)), jft.pad_pow2(jnp.asarray(p)))
    F = ftree.build(torch.as_tensor(_leaves(0, 16)))
    assert torch.equal(ftree.total(F), F[:, 1])
    assert torch.equal(ftree.leaves(F), F[:, 16:])
    with pytest.raises(ValueError, match="one"):
        ftree.sample_batch(F, torch.zeros(3))
