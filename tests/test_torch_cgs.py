"""The port's serial slice against the JAX reference: ``data/corpus.py``,
``data/synthetic.py``, ``core/cgs.py`` (state, counts, invariants and the
word-by-word F+LDA sweep with backend ``scan`` or ``fused``),
``core/likelihood.py`` and the state carried by ``convert.py``.  The chain
is compared bit for bit after every sweep; the log-likelihood to a
relative 1e-5, because the reference sums its f32 ``gammaln`` terms in
f32 in XLA's order and the port sums the same f32 terms in f64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cgs as jcgs
from repro.core import likelihood as jll
from repro.data import synthetic as jsyn
from repro_torch import convert, rng
from repro_torch.core import cgs, likelihood
from repro_torch.data import synthetic
from repro_torch.data.corpus import Corpus

LL_RTOL = 1e-5


def _corpora(seed=1, docs=36, vocab=70, mean_len=12.0):
    kw = dict(num_docs=docs, vocab_size=vocab, num_topics=8,
              mean_doc_len=mean_len, seed=seed)
    return jsyn.make_corpus(**kw), synthetic.make_corpus(**kw)


def test_synthetic_corpus_and_orders_match():
    (cj, thj, phj), (cp, thp, php) = _corpora(seed=4)
    np.testing.assert_array_equal(cj.doc_ids, cp.doc_ids)
    np.testing.assert_array_equal(cj.word_ids, cp.word_ids)
    np.testing.assert_array_equal(thj, thp)
    np.testing.assert_array_equal(phj, php)
    np.testing.assert_array_equal(cj.word_order(), cp.word_order())
    np.testing.assert_array_equal(cj.word_boundary(), cp.word_boundary())
    np.testing.assert_array_equal(cj.doc_lengths(), cp.doc_lengths())
    sub = np.arange(cp.num_docs) % 2 == 0
    np.testing.assert_array_equal(cj.subset(sub).word_ids,
                                  cp.subset(sub).word_ids)
    dense = np.random.default_rng(0).integers(0, 3, (5, 9))
    a, b = type(cj).from_dense(dense), Corpus.from_dense(dense)
    np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
    with pytest.raises(ValueError, match="out of range"):
        Corpus(doc_ids=np.array([5], np.int32),
               word_ids=np.array([0], np.int32), num_docs=2, num_words=3)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_state(sj, sp):
    for name in ("z", "n_td", "n_wt", "n_t"):
        np.testing.assert_array_equal(_np(getattr(sp, name)),
                                      _np(getattr(sj, name)))
    np.testing.assert_array_equal(rng.key_data(sp.key),
                                  np.asarray(jax.random.key_data(sj.key)))


@pytest.mark.parametrize("backend,r_mode,r_cap", [
    ("scan", "dense", None), ("fused", "dense", None),
    ("scan", "sparse", None), ("fused", "sparse", 6)])
def test_serial_chain_matches_after_every_sweep(backend, r_mode, r_cap):
    (cj, _, _), (cp, _, _) = _corpora()
    T, alpha, beta = 16, 50.0 / 16, 0.01
    sj = jcgs.init_state(cj, T, jax.random.key(3))
    sp = cgs.init_state(cp, T, rng.key(3, "cpu"))
    _same_state(sj, sp)
    order, bound = cp.word_order(), cp.word_boundary()
    jargs = (jnp.asarray(cj.doc_ids), jnp.asarray(cj.word_ids),
             jnp.asarray(order), jnp.asarray(bound))
    for _ in range(5):
        sj = jcgs.sweep_fplda_word(sj, *jargs, alpha, beta, backend=backend,
                                   r_mode=r_mode, r_cap=r_cap)
        sp = cgs.sweep_fplda_word(sp, cp.doc_ids, cp.word_ids, order, bound,
                                  alpha, beta, backend=backend,
                                  r_mode=r_mode, r_cap=r_cap)
        _same_state(sj, sp)
    assert cgs.check_invariants(sp, cp) == jcgs.check_invariants(sj, cj)
    assert not any(cgs.check_invariants(sp, cp).values())
    np.testing.assert_allclose(likelihood.log_likelihood(sp, alpha, beta),
                               jll.log_likelihood(sj, alpha, beta),
                               rtol=LL_RTOL)
    np.testing.assert_allclose(likelihood.per_token_ll(sp, alpha, beta),
                               jll.per_token_ll(sj, alpha, beta),
                               rtol=LL_RTOL)


@pytest.mark.parametrize("T,r_mode", [(2048, "dense"), (4096, "sparse")])
def test_serial_fused_chain_matches_above_1024_topics(T, r_mode):
    """The fused serial sweep at T = 2048 and 4096, bit for bit after
    every sweep."""
    (cj, _, _), (cp, _, _) = _corpora(seed=7, docs=20)
    alpha, beta = 50.0 / T, 0.01
    sj = jcgs.init_state(cj, T, jax.random.key(4))
    sp = cgs.init_state(cp, T, rng.key(4, "cpu"))
    order, bound = cp.word_order(), cp.word_boundary()
    jargs = (jnp.asarray(cj.doc_ids), jnp.asarray(cj.word_ids),
             jnp.asarray(order), jnp.asarray(bound))
    for _ in range(2):
        sj = jcgs.sweep_fplda_word(sj, *jargs, alpha, beta, backend="fused",
                                   r_mode=r_mode)
        sp = cgs.sweep_fplda_word(sp, cp.doc_ids, cp.word_ids, order, bound,
                                  alpha, beta, backend="fused",
                                  r_mode=r_mode)
        _same_state(sj, sp)
    assert not any(cgs.check_invariants(sp, cp).values())


def test_counts_and_invariants_match():
    (cj, _, _), (cp, _, _) = _corpora(seed=2)
    z = np.random.default_rng(0).integers(0, 8, cp.num_tokens)
    want = jcgs.counts_from_assignments(
        jnp.asarray(cj.doc_ids), jnp.asarray(cj.word_ids), jnp.asarray(z),
        cj.num_docs, cj.num_words, 8)
    got = cgs.counts_from_assignments(
        torch.as_tensor(cp.doc_ids), torch.as_tensor(cp.word_ids),
        torch.as_tensor(z), cp.num_docs, cp.num_words, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    state = cgs.LDAState(torch.as_tensor(z, dtype=torch.int32), *got,
                         rng.key(0, "cpu"))
    broken = state._replace(n_t=state.n_t + 1)
    assert cgs.check_invariants(broken, cp)["n_t_mismatch"] == 8


def test_state_crosses_between_packages():
    """A reference state carried into the port (``convert``) runs the
    same next sweep, and carries back."""
    (cj, _, _), (cp, _, _) = _corpora(seed=5)
    sj = jcgs.init_state(cj, 8, jax.random.key(9))
    sp = convert.state_from_reference(
        np.asarray(sj.z), np.asarray(sj.n_td), np.asarray(sj.n_wt),
        np.asarray(sj.n_t), np.asarray(jax.random.key_data(sj.key)),
        device="cpu")
    order, bound = cp.word_order(), cp.word_boundary()
    sj = jcgs.sweep_fplda_word(sj, jnp.asarray(cj.doc_ids),
                               jnp.asarray(cj.word_ids), jnp.asarray(order),
                               jnp.asarray(bound), 0.5, 0.01)
    sp = cgs.sweep_fplda_word(sp, cp.doc_ids, cp.word_ids, order, bound,
                              0.5, 0.01)
    _same_state(sj, sp)
    back = convert.state_to_reference(sp)
    assert np.array_equal(back["key_data"],
                          np.asarray(jax.random.key_data(sj.key)))
    assert back["z"].dtype == np.int32


def test_sweep_rejects_what_it_does_not_take():
    (_, _, _), (cp, _, _) = _corpora(seed=6)
    sp = cgs.init_state(cp, 12, rng.key(0, "cpu"))
    with pytest.raises(ValueError, match="power of two"):
        cgs.sweep_fplda_word(sp, cp.doc_ids, cp.word_ids, cp.word_order(),
                             cp.word_boundary(), 0.5, 0.01)
    sp = cgs.init_state(cp, 8, rng.key(0, "cpu"))
    with pytest.raises(ValueError, match="backend"):
        cgs.sweep_fplda_word(sp, cp.doc_ids, cp.word_ids, cp.word_order(),
                             cp.word_boundary(), 0.5, 0.01,
                             backend="vectorized")


@pytest.mark.parametrize("T,order", [(16, "word"), (512, "shuffled")])
def test_sweep_reference_matches_after_every_sweep(T, order):
    """The dense oracle, two sweeps from the same state: at T = 512 the
    cumsum has two upper levels of the blocked-16 scan."""
    (cj, _, _), (cp, _, _) = _corpora(seed=3)
    alpha, beta = 50.0 / T, 0.01
    sj = jcgs.init_state(cj, T, jax.random.key(4))
    sp = cgs.init_state(cp, T, rng.key(4, "cpu"))
    perm = (cp.word_order() if order == "word" else
            np.random.default_rng(T).permutation(cp.num_tokens))
    for _ in range(2):
        sj = jcgs.sweep_reference(sj, jnp.asarray(cj.doc_ids),
                                  jnp.asarray(cj.word_ids),
                                  jnp.asarray(perm), alpha, beta)
        sp = cgs.sweep_reference(sp, cp.doc_ids, cp.word_ids, perm, alpha,
                                 beta)
        _same_state(sj, sp)
    assert not any(cgs.check_invariants(sp, cp).values())
