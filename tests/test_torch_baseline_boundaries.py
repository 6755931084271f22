"""Twins of the SparseLDA and AliasLDA cases of
``tests/test_sampler_boundaries.py``: a word bucket whose summed mass
overruns its cumsum onto a zero-mass topic, every uniform forced to 0 or
1 − 2^-24, a single-topic document, the word bucket's dominance on a Zipf
corpus, and the MH invariant.  Each holds the port's chain to the
reference's bit for bit, as well as the reference's own property."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import cgs as jcgs
from repro.core.alias_lda import sweep_alias_lda as jalias
from repro.core.sparse_lda import sweep_sparse_lda as jsparse
from repro.data import synthetic as jsyn
from repro_torch import rng
from repro_torch.core import cgs
from repro_torch.core.alias_lda import sweep_alias_lda
from repro_torch.core.sparse_lda import sweep_sparse_lda
from repro_torch.data import synthetic
from test_torch_baselines import (_corpora, _jax_forced, _jax_state,
                                  _jit_sweep, _port_from, _same_chain)
from torch_baseline_cases import BETA, ROW, U_TOP, forced_uniforms

U_22 = float(np.float32(1.0 - 2.0**-22))


def _pinned_sparse_tables():
    T, J = 64, 8
    n_wt = np.zeros((J, T), np.int32)
    n_wt[0] = ROW
    n_wt[0, 0] += 1
    n_td = np.zeros((1, T), np.int32)
    n_td[0, 0] = 1
    n_t = np.full(T, 7, np.int32)
    n_t[0] += 1
    return dict(z=np.zeros(1, np.int32), n_td=n_td, n_wt=n_wt, n_t=n_t)


def _port_state(tab, key=0):
    return cgs.LDAState(*(torch.as_tensor(np.array(tab[k]))
                          for k in ("z", "n_td", "n_wt", "n_t")),
                        key=rng.key(key, "cpu"))


def test_sparse_zero_mass_word_bucket_guarded():
    """u01 = 1 − 2^-22 lands in the word bucket by the summed mass but at
    its cumsum's end: both packages draw the same positive-mass topic."""
    tab = _pinned_sparse_tables()
    zero = jnp.zeros(1, jnp.int32)
    with _jax_forced(U_22):
        sj, bj = jsparse(_jax_state(tab), zero, zero, zero, 0.5, BETA,
                         return_bucket_stats=True)
    with forced_uniforms(U_22):
        sp, bp = sweep_sparse_lda(_port_state(tab), [0], [0], [0], 0.5,
                                  BETA, return_bucket_stats=True)
    assert int(bp[0]) == int(bj[0]) == 2
    t = int(sp.z[0])
    assert t == int(sj.z[0]) and ROW[t] > 0


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(min_value=0, max_value=1000),
       u01=st.sampled_from([0.0, U_TOP]))
def test_sparse_boundary_uniforms_match(seed, u01):
    """Every uniform forced to a boundary on a toy corpus (single-token
    documents included): the same chain, counts consistent."""
    cj, cp = _corpora(seed=seed, docs=12, vocab=24, mean_len=3.0,
                      topics=4)
    sj = jcgs.init_state(cj, 8, jax.random.key(seed))
    sp = _port_from(sj)
    order = cp.doc_order()
    with _jax_forced(u01):
        sj = jsparse(sj, jnp.asarray(cj.doc_ids), jnp.asarray(cj.word_ids),
                     jnp.asarray(order), 0.5, BETA)
    with forced_uniforms(u01):
        sp = sweep_sparse_lda(sp, cp.doc_ids, cp.word_ids, order, 0.5, BETA)
    _same_chain(sp, sj)
    assert all(v == 0 for v in cgs.check_invariants(sp, cp).values())


def test_sparse_single_topic_doc():
    """A document whose every token holds one topic, every uniform at
    1 − 2^-24: the same chain as the reference's, in range."""
    T = 16
    doc_ids = np.zeros(5, np.int32)
    word_ids = np.array([0, 1, 2, 3, 0], np.int32)
    z = np.full(5, 3, np.int32)
    n_td, n_wt, n_t = jcgs.counts_from_assignments(
        jnp.asarray(doc_ids), jnp.asarray(word_ids), jnp.asarray(z), 1, 4,
        T)
    tab = dict(z=z, n_td=np.asarray(n_td), n_wt=np.asarray(n_wt),
               n_t=np.asarray(n_t))
    order = np.arange(5, dtype=np.int32)
    with _jax_forced(U_TOP):
        sj, bj = jsparse(_jax_state(tab), jnp.asarray(doc_ids),
                         jnp.asarray(word_ids), jnp.asarray(order), 0.5,
                         BETA, return_bucket_stats=True)
    with forced_uniforms(U_TOP):
        sp, bp = sweep_sparse_lda(_port_state(tab), doc_ids, word_ids,
                                  order, 0.5, BETA, return_bucket_stats=True)
    for name in ("z", "n_td", "n_wt", "n_t"):
        np.testing.assert_array_equal(getattr(sp, name).numpy(),
                                      np.asarray(getattr(sj, name)))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    assert bool(((sp.z >= 0) & (sp.z < T)).all())


def test_sparse_word_bucket_dominates_zipf():
    """Table-2 argument on the reference's Zipf corpus: the same bucket
    choices as the reference, and the word bucket takes most draws."""
    kw = dict(num_docs=100, vocab_size=128, num_topics=8,
              mean_doc_len=30.0, zipf_a=1.3, seed=7)
    cj, cp = jsyn.make_corpus(**kw)[0], synthetic.make_corpus(**kw)[0]
    sj = jcgs.init_state(cj, 16, jax.random.key(0))
    sp = _port_from(sj)
    order = cp.doc_order()
    jargs = (jnp.asarray(cj.doc_ids), jnp.asarray(cj.word_ids),
             jnp.asarray(order))
    for _ in range(2):                       # one sweep of burn-in
        sj, bj = _jit_sweep("sparse", 0.5)(sj, *jargs)
        sp, bp = sweep_sparse_lda(sp, cp.doc_ids, cp.word_ids, order, 0.5,
                                  BETA, return_bucket_stats=True)
    _same_chain(sp, sj)
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    hit = np.bincount(bp.numpy(), minlength=3) / bp.shape[0]
    assert hit[2] > 0.5 and hit[2] > hit[1] and hit[2] > hit[0]


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(min_value=0, max_value=1000),
       u01=st.sampled_from([0.0, U_TOP]))
def test_alias_boundary_uniforms_keep_the_mh_invariant(seed, u01):
    """Every uniform forced to a boundary: the same chain and MH flags as
    the reference's, every MH step's ratio finite and its acceptance in
    (0, 1]."""
    cj, cp = _corpora(seed=seed, docs=16, vocab=32, mean_len=8.0, topics=4)
    sj = jcgs.init_state(cj, 8, jax.random.key(seed))
    sp = _port_from(sj)
    order = cp.doc_order()
    with _jax_forced(u01, u01, u01):
        sj, okj = jalias(sj, jnp.asarray(cj.doc_ids),
                         jnp.asarray(cj.word_ids), jnp.asarray(order), 0.5,
                         BETA, return_mh_stats=True)
    with forced_uniforms(u01, u01, u01):
        sp, okp = sweep_alias_lda(sp, cp.doc_ids, cp.word_ids, order, 0.5,
                                  BETA, return_mh_stats=True)
    _same_chain(sp, sj)
    np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
    assert bool(okp.all())
    assert all(v == 0 for v in cgs.check_invariants(sp, cp).values())
