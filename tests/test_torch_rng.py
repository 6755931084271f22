"""The port's threefry twin (``repro_torch/rng.py``) against
``jax.random``: key data and drawn values are compared bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng


def _jkeys(words):
    return jax.random.wrap_key_data(jnp.asarray(words, jnp.uint32))


def _pairs(n=200, seed=0):
    """``n`` (key words, data) pairs: random words and data, plus the
    edge data 0, 1, 2**31-1, 2**31 and 2**32-1."""
    r = np.random.default_rng(seed)
    words = r.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    words[0] = 0
    words[1] = 2**32 - 1
    data = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    data[:5] = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]
    return words, data


def test_fold_in_check_value():
    got = rng.key_data(rng.fold_in(rng.key(0, "cpu"), 3))
    np.testing.assert_array_equal(got, [2467461003, 3840466878])


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**31, 2**32 - 1,
                                  -1, -2**31])
def test_key_matches_jax(seed):
    np.testing.assert_array_equal(rng.key_data(rng.key(seed, "cpu")),
                                  jax.random.key_data(jax.random.key(seed)))


def test_key_rejects_seed_jax_would_truncate():
    with pytest.raises(ValueError, match="seed"):
        rng.key(2**32, "cpu")


def test_key_data_round_trip():
    words, _ = _pairs(8)
    np.testing.assert_array_equal(
        rng.key_data(rng.wrap_key_data(words, "cpu")), words)


def test_fold_in_pairs_match_jax():
    words, data = _pairs()
    want = jax.vmap(jax.random.fold_in)(_jkeys(words), jnp.asarray(data))
    got = rng.fold_in(rng.wrap_key_data(words, "cpu"),
                      torch.as_tensor(data.astype(np.int64)))
    np.testing.assert_array_equal(rng.key_data(got),
                                  jax.random.key_data(want))


def test_fold_in_broadcasts_one_key_over_data():
    _, data = _pairs(64, seed=1)
    k = jax.random.key(123)
    want = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        k, jnp.asarray(data))
    got = rng.fold_in(rng.key(123, "cpu"),
                      torch.as_tensor(data.astype(np.int64)))
    np.testing.assert_array_equal(rng.key_data(got),
                                  jax.random.key_data(want))


def test_fold_in_negative_data_wraps_like_uint32():
    want = jax.random.fold_in(jax.random.key(5), jnp.int32(-7))
    got = rng.fold_in(rng.key(5, "cpu"), -7)
    np.testing.assert_array_equal(rng.key_data(got),
                                  jax.random.key_data(want))


def test_uniform_matches_jax():
    words, _ = _pairs(seed=2)
    want = np.asarray(jax.vmap(jax.random.uniform)(_jkeys(words)))
    got = rng.uniform(rng.wrap_key_data(words, "cpu")).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got >= 0).all() and (got < 1).all()


@pytest.mark.parametrize("maxval", [1, 7, 16, 48, 64, 1024, 65537,
                                    102660, 2**31 - 1])
def test_randint_matches_jax(maxval):
    words, _ = _pairs(seed=3)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (), 0, maxval, jnp.int32))(
            _jkeys(words)))
    got = rng.randint(rng.wrap_key_data(words, "cpu"), maxval).numpy()
    np.testing.assert_array_equal(got, want)


def test_randint_rejects_empty_range():
    with pytest.raises(ValueError, match="maxval"):
        rng.randint(rng.key(0, "cpu"), 0)


def test_nested_fold_in_chain_matches_jax():
    """The fold-in chains' shape: fold_in(fold_in(fold_in(k, d), role),
    p) over a (D, L) grid, then uniform and randint per entry."""
    D, L, T = 3, 5, 48
    jk = jax.random.key(9)
    dk = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(jk, jnp.arange(D))
    rk = jax.vmap(jax.random.fold_in, in_axes=(0, None))(dk, 1)
    pk = jax.vmap(lambda k: jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        k, jnp.arange(L)))(rk)
    flat = pk.reshape(-1)
    want_u = np.asarray(jax.vmap(jax.random.uniform)(flat)).reshape(D, L)
    want_z = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (), 0, T, jnp.int32))(
            flat)).reshape(D, L)
    k = rng.fold_in(rng.fold_in(rng.key(9, "cpu"), torch.arange(D)), 1)
    pk_t = rng.fold_in(k[:, None], torch.arange(L))
    np.testing.assert_array_equal(rng.uniform(pk_t).numpy(), want_u)
    np.testing.assert_array_equal(rng.randint(pk_t, T).numpy(), want_z)


@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_matches_jax(num):
    words, _ = _pairs(16, seed=5)
    want = jax.vmap(lambda k: jax.random.split(k, num))(_jkeys(words))
    got = rng.split(rng.wrap_key_data(words, "cpu"), num)
    np.testing.assert_array_equal(rng.key_data(got),
                                  jax.random.key_data(want))


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 4), (1000,), (2, 3, 5)])
def test_shaped_uniform_and_randint_match_jax(shape):
    """The calls of ``cgs.py``: ``uniform(k, (n,))`` for a sweep's draws,
    ``randint(k, (N,), 0, T)`` for the initial topics."""
    words, _ = _pairs(8, seed=6)
    words = words[:4]
    keys = rng.wrap_key_data(words, "cpu")
    for i, k in enumerate(_jkeys(words)):
        u = np.asarray(jax.random.uniform(k, shape))
        np.testing.assert_array_equal(rng.uniform(keys[i], shape).numpy(),
                                      u)
        z = np.asarray(jax.random.randint(k, shape, 0, 48, jnp.int32))
        np.testing.assert_array_equal(rng.randint(keys[i], 48,
                                                  shape).numpy(), z)


def test_cgs_key_chain_matches_jax():
    """``key, sub = split(key)`` then the shaped draws, three times over."""
    jk, pk = jax.random.key(11), rng.key(11, "cpu")
    for _ in range(3):
        jk, js = jax.random.split(jk)
        pk, ps = rng.split(pk).unbind(-2)
        np.testing.assert_array_equal(rng.key_data(pk),
                                      jax.random.key_data(jk))
        np.testing.assert_array_equal(
            rng.uniform(ps, (17,)).numpy(),
            np.asarray(jax.random.uniform(js, (17,))))


def test_token_uniforms_match_nomad_draws():
    """``repro/core/nomad.py:_token_uniforms`` for W workers: keys
    ``fold_in(fold_in(key(seed), w), r)``, one uniform per token id."""
    from repro.core.nomad import _token_uniforms
    W, S, seed, r = 3, 40, 7, 2
    uids = np.random.default_rng(0).integers(0, 2**31 - 1, (W, S))
    base = jax.random.key(seed)
    want = np.stack([np.asarray(_token_uniforms(
        jax.random.fold_in(jax.random.fold_in(base, w), r),
        jnp.asarray(uids[w], jnp.int32))) for w in range(W)])
    keys = rng.fold_in(rng.fold_in(rng.key(seed, "cpu"), torch.arange(W)),
                       r)
    got = rng.token_uniforms(keys, torch.as_tensor(uids))
    np.testing.assert_array_equal(got.numpy(), want)


def test_xla_log_matches_jitted_log():
    """``numerics.xla_log`` is XLA CPU's f32 log bit for bit: uniforms,
    a spread of magnitudes, and the edges (0, ±inf, negatives, NaN,
    denormals, 1)."""
    from repro_torch.numerics import xla_log
    r = np.random.default_rng(0)
    x = np.concatenate([
        r.random(200_000).astype(np.float32),
        np.exp(r.uniform(-87, 88, 200_000)).astype(np.float32),
        np.array([0, -0.0, np.inf, -np.inf, -1, np.nan, 1e-45, -1e-45,
                  1e-39, 1.0, 3.4e38], np.float32)])
    want = np.asarray(jax.jit(jnp.log)(x))
    got = xla_log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(torch.log(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("shape", [(), (7,), (3, 513), (8, 151)])
def test_gumbel_matches_jax(shape):
    for seed in (0, 1, 2**31 + 5):
        want = np.asarray(jax.random.gumbel(jax.random.key(seed), shape))
        got = rng.gumbel(rng.key(seed, "cpu"), shape).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(5,), (4, 512), (8, 151), (2, 3, 64)])
def test_categorical_matches_jax(shape):
    """Several keys, logits with ties (a block of equal maxima in every
    row, and an all-equal row), and the decode step's ``logits / T``
    under ``jit``."""
    r = np.random.default_rng(len(shape))
    for seed in (0, 3, 1234):
        logits = r.standard_normal(shape).astype(np.float32)
        logits[..., :3] = 2.5
        logits.reshape(-1, shape[-1])[0] = 0.0
        jk, tk = jax.random.key(seed), rng.key(seed, "cpu")
        want = np.asarray(jax.random.categorical(jk, logits))
        got = rng.categorical(tk, torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(got, want)
        want_t = np.asarray(jax.jit(lambda k, x: jax.random.categorical(
            k, x / 0.7))(jk, logits))
        got_t = rng.categorical(tk, torch.from_numpy(logits) / 0.7)
        np.testing.assert_array_equal(got_t.numpy(), want_t)
