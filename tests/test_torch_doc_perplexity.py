"""The port's serial and held-out leftovers against the JAX reference:

* ``cgs.sweep_fplda_doc`` (decomposition (4)) is bit-equal to
  ``jax.jit`` of the reference's, on small corpora and on single tokens
  whose uniform sits next to a draw boundary, one case for each float
  site XLA CPU rounds its own way (each draw flips when that site is
  rounded the other way);
* ``heldout.document_completion_perplexity``'s fold-in counts equal the
  reference's serial ``fold_in`` on the estimation halves, its value
  agrees to a relative 1e-5 (the reference sums its f32 log terms in
  f32), and a corpus of single-token documents scores exactly 1.0;
* the example twins run on the CPU at tiny sizes: the quickstart's chain
  equals the reference's serial sweep, and ``train_lda_e2e`` and
  ``nomad_distributed`` resume bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cgs as jcgs
from repro.core import heldout as jheldout
from repro.data import synthetic as jsyn
from repro_torch import rng
from repro_torch.core import cgs, ftree, heldout
from repro_torch.data.corpus import Corpus
from repro_torch.examples import (nomad_distributed, quickstart,
                                  serve_topics, train_lda_e2e)
from repro_torch.kernels.fused_sweep.ref import U_MAX
from repro_torch.numerics import blocked_cumsum, fma

PPL_RTOL = 1e-5


def _corpora(T, docs, seed, mean_len=20.0, vocab=64):
    cj, _, _ = jsyn.make_corpus(num_docs=docs, vocab_size=vocab,
                                num_topics=T, mean_doc_len=mean_len,
                                seed=seed)
    return cj, Corpus(cj.doc_ids.copy(), cj.word_ids.copy(), cj.num_docs,
                      cj.num_words)


def _port_state(js):
    """A reference ``LDAState`` as the port's, on the CPU."""
    return cgs.LDAState(*(torch.as_tensor(np.array(x)) for x in js[:4]),
                        key=rng.wrap_key_data(
                            np.asarray(jax.random.key_data(js.key)), "cpu"))


def _doc_args(corpus):
    order = corpus.doc_order()
    d = corpus.doc_ids[order]
    return order, np.concatenate([[True], d[1:] != d[:-1]])


@pytest.mark.parametrize("T,seed,alpha,beta", [(8, 0, 0.5, 0.01),
                                               (16, 1, 50 / 16, 0.1),
                                               (64, 2, 0.1, 0.01)])
def test_sweep_fplda_doc_equals_jitted_reference(T, seed, alpha, beta):
    cj, cp = _corpora(T, 20, seed)
    order, bound = _doc_args(cj)
    js = jcgs.init_state(cj, T, jax.random.key(seed))
    sweep = jax.jit(lambda s: jcgs.sweep_fplda_doc(
        s, jnp.asarray(cj.doc_ids), jnp.asarray(cj.word_ids),
        jnp.asarray(order), jnp.asarray(bound), alpha, beta))
    ps = _port_state(js)
    for _ in range(2):
        js = sweep(js)
        ps = cgs.sweep_fplda_doc(ps, cp.doc_ids, cp.word_ids, order, bound,
                                 alpha, beta)
        for got, want in zip(ps[:4], js[:4]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            rng.key_data(ps.key), np.asarray(jax.random.key_data(js.key)))
    assert cgs.check_invariants(ps, cp) == {
        "n_td_mismatch": 0, "n_wt_mismatch": 0, "n_t_mismatch": 0,
        "negatives": 0, "z_range": 0}


# Single-token doc-by-doc cases (T = 16), each found by a search over the
# keys whose uniform sits next to a draw boundary (jax 0.9.0, XLA CPU):
#   norm_r — u_scaled = u01 * fma(beta, F[1], r_mass) on the r side;
#   norm_q — the q side's norm beta*F[1] + r_mass, rounded as written;
#   qnum   — fma(u01, norm, -r_mass), the q side's numerator.
# ``n_wt`` is the token's word row; the rest of ``n_t`` lies on another
# word.  The token is topic ``t_old`` of doc 0 and the chain key is
# ``[0, key]``.
DOC_FLIP_CASES = [
    ("norm_r", dict(
        n_td=[0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1],
        n_wt=[0, 0, 2, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, 0],
        n_t=[1317, 4918, 2240, 3245, 816, 1485, 3613, 504, 4334, 2214,
             3708, 4135, 2271, 1651, 709, 853],
        t_old=5, alpha=0.1, beta=0.3, J=69457, key=7005916)),
    ("norm_r", dict(
        n_td=[0, 0, 0, 0, 1, 0, 1, 1, 2, 0, 0, 0, 1, 0, 0, 0],
        n_wt=[2, 0, 0, 1, 3, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        n_t=[4581, 503, 3254, 1156, 2746, 4676, 3072, 1286, 975, 4954,
             3928, 3076, 3184, 3143, 4763, 676],
        t_old=4, alpha=3.125, beta=3.0, J=85717, key=1990032)),
    ("norm_q", dict(
        n_td=[1, 0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 0, 2, 0, 0, 0],
        n_wt=[0, 0, 0, 0, 1, 0, 0, 0, 2, 0, 0, 0, 1, 0, 2, 0],
        n_t=[4520, 3923, 305, 477, 2666, 1875, 2352, 4678, 1258, 2781,
             1828, 1686, 4091, 1020, 1789, 858],
        t_old=12, alpha=0.1, beta=0.3, J=60436, key=11267471)),
    ("qnum", dict(
        n_td=[0, 1, 1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 1, 1, 0, 0],
        n_wt=[1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0],
        n_t=[4213, 4332, 4959, 3970, 2959, 4101, 1413, 1044, 3396, 1469,
             3403, 1367, 2719, 4152, 1611, 2929],
        t_old=13, alpha=0.5, beta=0.3, J=66738, key=36667688)),
]


def _one_token_state(case):
    n_wt = np.zeros((case["J"], 16), np.int32)
    n_wt[0] = case["n_wt"]
    n_wt[1] = np.asarray(case["n_t"]) - n_wt[0]
    z = np.array([case["t_old"]], np.int32)
    key = jax.random.wrap_key_data(jnp.asarray(np.array([0, case["key"]],
                                                        np.uint32)))
    return jcgs.LDAState(jnp.asarray(z),
                         jnp.asarray(np.array([case["n_td"]], np.int32)),
                         jnp.asarray(n_wt),
                         jnp.asarray(np.array(case["n_t"], np.int32)), key)


def _other_draw(case, site: str) -> int:
    """The case's draw with ``site`` rounded the other way."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    a, b = f32(case["alpha"]), f32(case["beta"])
    bb = f32(case["beta"] * case["J"])
    n_td, n_wt, n_t = (torch.tensor(case[k]) for k in ("n_td", "n_wt",
                                                      "n_t"))
    t = case["t_old"]
    q = lambda: (n_td.float() + a) / (n_t.float() + bb)
    F = ftree.build(q())
    n_td[t] -= 1
    n_wt[t] -= 1
    n_t[t] -= 1
    F = ftree.set_leaf(F, torch.tensor(t), q()[t])
    c = blocked_cumsum(n_wt.float() * ftree.leaves(F))
    key = rng.wrap_key_data(np.array([0, case["key"]], np.uint32), "cpu")
    u = rng.uniform(rng.split(key)[1], (1,))[0]
    r_mass, bq = c[-1], b * F[1]
    contracted = fma(b, F[1], r_mass)
    norm_r = bq + r_mass if site == "norm_r" else contracted
    norm_q = contracted if site == "norm_q" else bq + r_mass
    num = u * norm_q - r_mass if site == "qnum" else fma(u, norm_q, -r_mass)
    us = u * norm_r
    if us < r_mass:
        return int((c <= us).sum())
    return int(ftree.sample(F, (num / bq).clamp(0.0, U_MAX)))


@pytest.mark.parametrize("i", range(len(DOC_FLIP_CASES)))
def test_sweep_fplda_doc_rounds_each_site_as_jit(i):
    site, case = DOC_FLIP_CASES[i]
    js = _one_token_state(case)
    args = (jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32),
            jnp.zeros(1, jnp.int32), jnp.ones(1, bool))
    want = int(jax.jit(lambda s: jcgs.sweep_fplda_doc(
        s, *args, case["alpha"], case["beta"]))(js).z[0])
    got = cgs.sweep_fplda_doc(_port_state(js), np.zeros(1, np.int32),
                              np.zeros(1, np.int32), [0], [True],
                              case["alpha"], case["beta"])
    assert int(got.z[0]) == want
    assert _other_draw(case, site) != want, site


def _heldout(T=8, seed=3, docs=30):
    cj, cp = _corpora(T, docs, seed, mean_len=15.0)
    r = np.random.default_rng(seed)
    n_wt = r.integers(0, 40, (cj.num_words, T)).astype(np.int32)
    return cj, cp, n_wt, n_wt.sum(0).astype(np.int32)


@pytest.mark.parametrize("T,seed", [(8, 0), (16, 1), (32, 2)])
def test_perplexity_counts_equal_and_value_agrees(T, seed):
    cj, cp, n_wt, n_t = _heldout(T, seed)
    alpha, beta, sweeps = 50.0 / T, 0.01, 5
    want = jheldout.document_completion_perplexity(
        cj, n_wt, n_t, alpha=alpha, beta=beta, key=jax.random.key(7),
        fold_sweeps=sweeps)
    got = heldout.document_completion_perplexity(
        cp, n_wt, n_t, alpha=alpha, beta=beta, key=rng.key(7, "cpu"),
        fold_sweeps=sweeps, device="cpu")
    assert got == pytest.approx(want, rel=PPL_RTOL)
    # the counts: the batched fold-in of the estimation halves against
    # the reference's serial fold-in on them
    order = cj.doc_order()
    first = heldout._positions_in_doc(cj.doc_ids[order]) % 2 == 0
    est = order[first]
    phi_j = jheldout._phi_hat(jnp.asarray(n_wt), jnp.asarray(n_t), beta)
    counts = jheldout.fold_in(jnp.asarray(cj.word_ids[est]),
                              jnp.asarray(cj.doc_ids[est]), cj.num_docs,
                              phi_j, alpha, jax.random.key(7), sweeps)
    phi = heldout._phi_hat(torch.as_tensor(n_wt), torch.as_tensor(n_t),
                           beta)
    np.testing.assert_array_equal(phi.numpy(), np.asarray(phi_j))
    mine = heldout._fold_in_halves(cp.word_ids[est], cp.doc_ids[est],
                                   cp.num_docs, phi, alpha,
                                   rng.key(7, "cpu"), sweeps)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(counts))


def test_perplexity_edges():
    _, _, n_wt, n_t = _heldout()
    single = Corpus(np.arange(5, dtype=np.int32),
                    np.array([1, 2, 3, 4, 5], np.int32), 5, n_wt.shape[0])
    assert heldout.document_completion_perplexity(
        single, n_wt, n_t, alpha=0.5, beta=0.01, device="cpu") == 1.0
    empty = Corpus(np.zeros(0, np.int32), np.zeros(0, np.int32), 3,
                   n_wt.shape[0])
    with pytest.raises(ValueError, match="empty"):
        heldout.document_completion_perplexity(
            empty, n_wt, n_t, alpha=0.5, beta=0.01, device="cpu")
    assert "document_completion_perplexity" in heldout.__all__


def test_quickstart_twin_runs_the_reference_chain():
    out = quickstart.main(["--device", "cpu", "--docs", "8", "--sweeps",
                           "5"])
    (s0, ll0), (s5, ll5) = out["ll"]
    assert (s0, s5) == (0, 5) and ll5 > ll0
    cj, _, _ = jsyn.make_corpus(num_docs=8, vocab_size=512, num_topics=16,
                                mean_doc_len=60.0, seed=0)
    order = cj.word_order()
    bound = jnp.asarray(cj.word_boundary(order))
    state = jcgs.init_state(cj, 16, jax.random.key(0))
    sweep = jax.jit(lambda s: jcgs.sweep_fplda_word(
        s, jnp.asarray(cj.doc_ids), jnp.asarray(cj.word_ids),
        jnp.asarray(order), bound, 50.0 / 16, 0.01))
    for _ in range(5):
        state = sweep(state)
    for got, want in zip(out["state"][:4], state[:4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _same_arrays(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_train_lda_e2e_twin_resumes_bit_for_bit(tmp_path):
    base = ["--device", "cpu", "--docs", "24", "--topics", "8"]
    straight = train_lda_e2e.main(base + ["--sweeps", "3",
                                          "--checkpoint-every", "0"])
    ckpt = str(tmp_path / "e2e.npz")
    train_lda_e2e.main(base + ["--sweeps", "2", "--checkpoint-every", "1",
                               "--ckpt", ckpt])
    resumed = train_lda_e2e.main(base + ["--sweeps", "3",
                                         "--checkpoint-every", "0",
                                         "--resume-from", ckpt])
    _same_arrays(straight, resumed)


def test_nomad_distributed_twin_resumes_bit_for_bit(tmp_path, capsys):
    base = ["--device", "cpu", "--docs", "40"]
    straight = nomad_distributed.main(base + ["--sweeps", "2"])
    ckpt = str(tmp_path / "nomad.npz")
    nomad_distributed.main(["0", "barrier", "dense", "0"] + base
                           + ["--sweeps", "1", "--checkpoint-every", "1",
                              "--checkpoint-path", ckpt])
    # a dense-layout checkpoint resumes on the ragged layout (z is stored
    # in canonical order) and the barrier ring's chain is the pipelined
    resumed = nomad_distributed.main(base + ["--sweeps", "2",
                                             "--resume-from", ckpt])
    for k in ("n_td", "n_wt", "n_t", "z"):
        assert torch.equal(straight[k], resumed[k]), k
    assert "count tables exact" in capsys.readouterr().out


def test_serve_topics_twin_publishes_and_saves(tmp_path):
    path = str(tmp_path / "phi.npz")
    out = serve_topics.main(["--device", "cpu", "--sweeps", "1",
                             "--publish-every", "1", "--queries", "2",
                             "--save", path])
    assert out["generations"] == 2 and out["saved"]
    assert len(out["answers"]) >= 2
    assert all(np.allclose(a.theta.sum(1), 1.0, atol=1e-5)
               for a in out["answers"])
