"""The port's ``lda_scores`` kernel module (``repro_torch/kernels/
lda_scores``) against the JAX reference, on the CPU where the ops run the
plain version.

The rows form against ``lda_scores_pallas`` in interpret mode (through
the reference's padding op) and against the reference's ``ref.py``, at
the count ranges of ``benchmarks/kernel_bench.py``: ``z`` and ``norm``
bit-equal, since the port scans in XLA CPU's blocked-16 order and forms
the norm from that scan, as the reference does.  The pass form, given the
masked-in tokens and with its deltas applied, against
``repro.core.nomad._vectorized_pass`` given all tokens and the mask: the
new ``z`` and all three tables bit-equal, with repeated docs and words in
one pass.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cgs as jcgs
from repro.core.nomad import _vectorized_pass
from repro.kernels.lda_scores import lda_scores_draw as j_draw
from repro.kernels.lda_scores.lda_scores import N_BLK, lda_scores_pallas
from repro.kernels.lda_scores.ref import lda_scores_draw_ref as j_ref
from repro_torch.core import cgs
from repro_torch.kernels.lda_scores import (lda_scores_draw,
                                            lda_scores_pass, vectorized_pass)
from repro_torch.kernels.lda_scores import lda_scores as ls_mod

KW = dict(alpha=0.05, beta=0.01, beta_bar=51.2)


def _rows(T, n, seed):
    """Count rows as ``kernel_bench.run`` draws them."""
    r = np.random.default_rng(seed)
    return (r.integers(0, 8, (n, T)).astype(np.int32),
            r.integers(0, 20, (n, T)).astype(np.int32),
            r.integers(20, 500, T).astype(np.int32),
            r.random(n).astype(np.float32))


@pytest.mark.parametrize("T", [128, 1024, 8192])
@pytest.mark.parametrize("n", [1, 255, 256, 300])
def test_rows_form_matches_reference(T, n):
    ntd, nwt, nt, u = _rows(T, n, 7 * T + n)
    z, norm = lda_scores_draw(*map(torch.as_tensor, (ntd, nwt, nt, u)), **KW)
    assert z.dtype == torch.int32 and norm.dtype == torch.float32
    for name, (zj, nj) in {
            "pallas": j_draw(*map(jnp.asarray, (ntd, nwt, nt, u)), **KW),
            "ref": jax.jit(lambda *a: j_ref(*a, **KW))(ntd, nwt, nt, u)
    }.items():
        np.testing.assert_array_equal(z.numpy(), np.asarray(zj),
                                      err_msg=name)
        np.testing.assert_array_equal(norm.numpy().view(np.int32),
                                      np.asarray(nj).view(np.int32),
                                      err_msg=name)


def test_rows_form_matches_the_kernel_on_whole_tiles():
    """``lda_scores_pallas`` itself, on two whole tiles, with zero rows
    and a uniform that reaches the norm."""
    ntd, nwt, nt, u = _rows(256, 2 * N_BLK, 3)
    ntd[:3] = 0
    nwt[1] = 0
    u[:4] = [0.0, 1.0 - 2**-24, np.nextafter(np.float32(1), 0), 0.5]
    zj, nj = lda_scores_pallas(*map(jnp.asarray, (ntd, nwt, nt, u)),
                               interpret=True, **KW)
    z, norm = lda_scores_draw(*map(torch.as_tensor, (ntd, nwt, nt, u)), **KW)
    np.testing.assert_array_equal(z.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(norm.numpy(), np.asarray(nj))


def test_conditional_is_the_reference_oracles():
    r = np.random.default_rng(5)
    T = 64
    a, b = r.integers(0, 9, T), r.integers(0, 30, T)
    c = r.integers(30, 900, T)
    got = cgs.conditional_probs(*map(torch.as_tensor, (a, b, c)), 0.3, 0.01,
                                7.5)
    want = jcgs.conditional_probs(*map(jnp.asarray, (a, b, c)), 0.3, 0.01,
                                  7.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for u01 in (0.0, 0.37, 1.0 - 2**-24):
        assert int(cgs._inverse_cdf_draw(got, u01)) == int(
            jcgs._inverse_cdf_draw(want, jnp.float32(u01)))


def _pass_case(T, seed, N=256, I=5, J=7):
    """A pass over N tokens of cells 0 and 1, a fifth of them in no cell
    (-1, as a masked slot), repeated docs and words, counts consistent
    with nothing (the pass does not need them to be)."""
    r = np.random.default_rng(seed)
    n_td = r.integers(1, 30, (I, T)).astype(np.int32)
    n_wt = r.integers(1, 30, (J, T)).astype(np.int32)
    n_t = (n_wt.sum(0) + r.integers(0, 50, T)).astype(np.int32)
    cell = r.integers(0, 2, N).astype(np.int32)
    cell[r.random(N) < 0.2] = -1
    return dict(doc=r.integers(0, I, N).astype(np.int32),
                wrd=r.integers(0, J, N).astype(np.int32),
                cell=cell, z=r.integers(0, T, N).astype(np.int32),
                u=r.random(N).astype(np.float32), n_td=n_td, n_wt=n_wt,
                n_t=n_t)


@pytest.mark.parametrize("T", [16, 128, 1024, 8192, 40001, 65536])
@pytest.mark.parametrize("seed", [0, 1])
def test_pass_form_matches_vectorized_pass(T, seed):
    """Up to T = 65,536 (a few dozen tokens above 1024; 40,001 ends in a
    ragged chunk and a ragged scan block), where the card's kernel forms
    each line twice."""
    c = _pass_case(T, seed, N=256 if T <= 1024 else 40)
    J = c["n_wt"].shape[0]
    kw = dict(alpha=50.0 / T, beta=0.01, beta_bar=0.01 * J)
    mask = c["cell"] == 1
    want = jax.jit(_vectorized_pass, static_argnums=(8, 9, 10))(
        c["doc"], c["wrd"], mask, c["z"], c["n_td"], c["n_wt"], c["n_t"],
        c["u"], kw["alpha"], kw["beta"], kw["beta_bar"])
    t = lambda a: torch.as_tensor(np.array(a))
    # the worker's n_t is row 1 of a two-row table
    n_t = t(np.stack([c["n_t"] + 7, c["n_t"]]))
    tables = (t(c["n_td"]), t(c["n_wt"]), n_t)
    ones = torch.ones(int(mask.sum()), dtype=torch.int32)
    z_in = t(c["z"][mask])
    drawn = vectorized_pass(t(c["doc"][mask]), t(c["wrd"][mask]), ones,
                            z_in, t(c["u"][mask]), *tables, **kw)
    assert torch.equal(z_in, t(c["z"][mask]))
    assert int((drawn != z_in).sum()) > 0
    z = t(c["z"])
    z[t(mask)] = drawn
    for got, w, name in zip((z, *tables[:2], n_t[1]), want,
                            ("z", "n_td", "n_wt", "n_t")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w),
                                      err_msg=name)
    np.testing.assert_array_equal(n_t[0].numpy(), c["n_t"] + 7)


def test_pass_form_reads_the_tables_as_they_were():
    """All tokens of a pass see the counts at entry: the draw alone leaves
    the tables unchanged, and a pass of one token equals that token's
    draw within a larger pass."""
    c = _pass_case(64, 4)
    t = lambda a: torch.as_tensor(np.array(a))
    kw = dict(alpha=0.5, beta=0.01, beta_bar=0.07)
    tables = [t(c["n_td"]), t(c["n_wt"]), t(c["n_t"][None])]
    mine = c["cell"] == 0
    n = int(mine.sum())
    tok = [t(c[name][mine]) for name in ("doc", "wrd")]
    tok.append(torch.zeros(n, dtype=torch.int32))
    tok += [t(c["z"][mine]), t(c["u"][mine])]
    z = lda_scores_pass(*tok, *tables, **kw)
    for got, name in zip(tables, ("n_td", "n_wt")):
        np.testing.assert_array_equal(got.numpy(), c[name])
    i = n - 1
    z1 = lda_scores_pass(*(x[i:] for x in tok), *tables, **kw)
    assert int(z1[0]) == int(z[i])


def test_cuda_wrappers_refuse_cpu_tensors():
    ntd, nwt, nt, u = map(torch.as_tensor, _rows(16, 4, 0))
    with pytest.raises(ValueError, match="CUDA"):
        ls_mod.lda_scores_cuda(ntd, nwt, nt, u, **KW)
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ls_mod.lda_scores_pass_cuda(z, z, z, z, u, ntd, nwt, nt[None], **KW)
    for T in (1, 4096, 8192, 65536, 131072, ls_mod.MAX_TOPICS):
        ls_mod.check_fits(T)
    for T in (0, ls_mod.MAX_TOPICS + 1):
        with pytest.raises(ValueError, match="int32"):
            ls_mod.check_fits(T)
    assert ls_mod.launches == {"lda_scores": 0, "lda_scores_pass": 0}


@pytest.mark.parametrize("T,where,smem", [
    (1024, "registers", 2176), (7168, "stored", 211968),
    (7169, "shared levels", 15360), (65536, "shared levels", 139776),
    (108944, "shared levels", 232448), (108945, "device levels", 0),
    (1 << 20, "device levels", 0)])
def test_placement_by_shared_memory(T, where, smem):
    """The stored layout up to T = 7,168, the deep one above with its
    upper levels in shared memory while 8 warps' fit the 232,448 bytes
    a block may use, else in the device scratch; the bytes the launcher
    checks (``smem_for`` in the kernel)."""
    assert ls_mod.placement(T) == where
    assert ls_mod.smem_bytes(T) == smem <= ls_mod.SMEM_LIMIT_BYTES
