"""The port's baseline LDA sweeps (``repro_torch/core/sparse_lda.py``,
``core/alias_lda.py``) against ``repro/core/sparse_lda.py`` and
``repro/core/alias_lda.py``: the chain (``z``, the counts, the key), the
bucket choices and the MH flags after every sweep, bit for bit, at
T ∈ {16, 64} (and one SparseLDA sweep at the smoke's T = 1024), with
``num_mh`` ∈ {1, 2, 4}; one case per fused multiply-add site whose draw
flips with the rounding.  No tolerance anywhere (the boundary cases of
``tests/test_sampler_boundaries.py`` have their twins in
``tests/test_torch_baseline_boundaries.py``).

The reference runs under ``jit`` (the sweeps give the same chain eagerly),
except where its uniforms are forced, which patches ``jax.random`` while
it traces."""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cgs as jcgs
from repro.core.alias_lda import sweep_alias_lda as jalias
from repro.core.sparse_lda import sweep_sparse_lda as jsparse
from repro.data import synthetic as jsyn
from repro_torch import convert, rng
from repro_torch.core import cgs
from repro_torch.core.alias_lda import sweep_alias_lda
from repro_torch.core.sparse_lda import sweep_sparse_lda
from repro_torch.data import synthetic
from torch_baseline_cases import (ALIAS_FLIP_CASES, BETA, SPARSE_FLIP_CASES,
                                  alias_flip_draw, forced_uniforms,
                                  one_token_state, one_token_tables,
                                  sparse_flip_draw)

SWEEPS = 3


@functools.lru_cache(maxsize=None)
def _jit_sweep(kind, alpha, num_mh=2):
    if kind == "sparse":
        return jax.jit(lambda s, d, w, o: jsparse(
            s, d, w, o, alpha, BETA, return_bucket_stats=True))
    return jax.jit(lambda s, d, w, o: jalias(
        s, d, w, o, alpha, BETA, num_mh=num_mh, return_mh_stats=True))


def _corpora(seed=1, docs=24, vocab=60, mean_len=10.0, topics=8, **kw):
    kw = dict(num_docs=docs, vocab_size=vocab, num_topics=topics,
              mean_doc_len=mean_len, seed=seed, **kw)
    return jsyn.make_corpus(**kw)[0], synthetic.make_corpus(**kw)[0]


def _same_chain(sp, sj):
    for name in ("z", "n_td", "n_wt", "n_t"):
        np.testing.assert_array_equal(getattr(sp, name).numpy(),
                                      np.asarray(getattr(sj, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(rng.key_data(sp.key),
                                  np.asarray(jax.random.key_data(sj.key)))


def _port_from(sj):
    """The port's state from the reference's, through ``convert``."""
    return convert.state_from_reference(
        *(np.array(getattr(sj, k)) for k in ("z", "n_td", "n_wt", "n_t")),
        np.asarray(jax.random.key_data(sj.key)), device="cpu")


def _run_chains(kind, T, num_mh=2, sweeps=SWEEPS, **corpus_kw):
    cj, cp = _corpora(**corpus_kw)
    alpha = 50.0 / T
    sj = jcgs.init_state(cj, T, jax.random.key(7))
    sp = _port_from(sj)
    order = cp.doc_order()
    jargs = (jnp.asarray(cj.doc_ids), jnp.asarray(cj.word_ids),
             jnp.asarray(order))
    for _ in range(sweeps):
        sj, stats_j = _jit_sweep(kind, alpha, num_mh)(sj, *jargs)
        if kind == "sparse":
            sp, stats_p = sweep_sparse_lda(sp, cp.doc_ids, cp.word_ids,
                                           order, alpha, BETA,
                                           return_bucket_stats=True)
        else:
            sp, stats_p = sweep_alias_lda(sp, cp.doc_ids, cp.word_ids,
                                          order, alpha, BETA, num_mh=num_mh,
                                          return_mh_stats=True)
        _same_chain(sp, sj)
        np.testing.assert_array_equal(stats_p.numpy(), np.asarray(stats_j))
    assert all(v == 0 for v in cgs.check_invariants(sp, cp).values())
    return sp, stats_p


@pytest.mark.parametrize("T", [16, 64])
def test_sparse_chain_matches_after_every_sweep(T):
    _, buckets = _run_chains("sparse", T)
    assert buckets.dtype == torch.int32
    assert set(buckets.tolist()) <= {0, 1, 2}


def test_sparse_chain_matches_at_1024_topics():
    """The masses are XLA's row sums: at T = 1024, runs of 32 of runs of
    32, inside the sweep's scan body as outside it."""
    _run_chains("sparse", 1024, sweeps=1, docs=8)


def test_alias_chain_matches_at_1024_topics():
    """The contracted sums (proposal mass, q numerator, proposal density)
    and the rounded ones stay so at the smoke's T = 1024."""
    _, mh_ok = _run_chains("alias", 1024, num_mh=2, sweeps=1, docs=8)
    assert bool(mh_ok.all())


@pytest.mark.parametrize("num_mh", [1, 2, 4])
@pytest.mark.parametrize("T", [16, 64])
def test_alias_chain_matches_after_every_sweep(T, num_mh):
    _, mh_ok = _run_chains("alias", T, num_mh=num_mh)
    assert mh_ok.dtype == torch.bool and bool(mh_ok.all())


def test_sweeps_start_from_the_same_init_and_leave_it_alone():
    """Both packages' ``init_state`` give one state; a sweep returns a new
    state and leaves the given one as it was."""
    cj, cp = _corpora()
    sj = jcgs.init_state(cj, 16, jax.random.key(3))
    sp = cgs.init_state(cp, 16, rng.key(3, "cpu"))
    _same_chain(sp, sj)
    before = [x.clone() for x in sp]
    order = cp.doc_order()
    sweep_sparse_lda(sp, cp.doc_ids, cp.word_ids, order, 0.5, BETA)
    sweep_alias_lda(sp, cp.doc_ids, cp.word_ids, torch.as_tensor(order),
                    0.5, BETA)
    for a, b in zip(sp, before):
        assert torch.equal(a, b)


def _jax_state(tab):
    return jcgs.LDAState(z=jnp.asarray(tab["z"]),
                         n_td=jnp.asarray(tab["n_td"]),
                         n_wt=jnp.asarray(tab["n_wt"]),
                         n_t=jnp.asarray(tab["n_t"]),
                         key=jax.random.key(0))


def _jax_forced(*values):
    calls = iter(values)

    def forced(key, shape=(), dtype=jnp.float32, **kw):
        v = np.asarray(next(calls), np.float32)
        return jnp.asarray(np.broadcast_to(v, shape).copy())
    return mock.patch.object(jax.random, "uniform", forced)


@pytest.mark.parametrize("site", sorted(SPARSE_FLIP_CASES))
def test_sparse_contraction_site_flip(site):
    """One token whose draw depends on how one sum is rounded: the port
    draws the reference's topic from the reference's bucket, and the
    other rounding another topic."""
    case = SPARSE_FLIP_CASES[site]
    zero = jnp.zeros(1, jnp.int32)
    with _jax_forced(case["u01"]):
        sj, bj = jsparse(_jax_state(one_token_tables(case)), zero, zero,
                         zero, case["alpha"], BETA, return_bucket_stats=True)
    with forced_uniforms(case["u01"]):
        sp, bp = sweep_sparse_lda(one_token_state(case), [0], [0], [0],
                                  case["alpha"], BETA,
                                  return_bucket_stats=True)
    assert int(sj.z[0]) == int(sp.z[0]) == case["want"]
    assert int(bj[0]) == int(bp[0]) == case["bucket"]
    assert sparse_flip_draw(case) == case["want"]
    assert sparse_flip_draw(case, site) != case["want"]


@pytest.mark.parametrize("site", sorted(ALIAS_FLIP_CASES))
def test_alias_contraction_site_flip(site):
    """As above for AliasLDA with one MH step."""
    case = ALIAS_FLIP_CASES[site]
    zero = jnp.zeros(1, jnp.int32)
    u = (case["u01"], case["u_acc"], case["u_prop"])
    with _jax_forced(*u):
        sj, okj = jalias(_jax_state(one_token_tables(case)), zero, zero,
                         zero, case["alpha"], BETA, num_mh=1,
                         return_mh_stats=True)
    with forced_uniforms(*u):
        sp, okp = sweep_alias_lda(one_token_state(case), [0], [0], [0],
                                  case["alpha"], BETA, num_mh=1,
                                  return_mh_stats=True)
    assert int(sj.z[0]) == int(sp.z[0]) == case["want"]
    assert bool(okj[0]) == bool(okp[0])
    assert alias_flip_draw(case) == case["want"]
    assert alias_flip_draw(case, site) != case["want"]
