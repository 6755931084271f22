"""The port's out-of-core corpus store (``repro_torch/data/corpus_store.py``)
against ``repro/data/corpus_store.py``: the stores' files are the same
and open in either package; ``build_layout_from_store`` is byte-identical
to the port's ``build_layout`` and to the reference's streaming build, for
both layouts, ``doc_tile`` ∈ {None, 3, 8} and two shard sizes;
``update_layout``, ``remap_canonical`` and ``carry_assignments`` give the
reference's outputs on the reference's own cases (tests/
test_corpus_store.py), overflow past ``B·L`` included; and a live chain
carried across an update equals the reference's carried chain bit for
bit after 2 sweeps: W = 1 in process, W = 4 against one subprocess that
fakes four CPU devices, the port paged and the reference unpaged (its
paged kernels do not trace on the installed jax).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.core.nomad import NomadLDA as JNomad
from repro.data import corpus_store as jcs
from repro.data import sharding as jsh
from repro.data import synthetic as jsyn
from repro.kernels.fused_sweep import rbucket as jrbucket
from repro_torch.core.nomad import NomadLDA
from repro_torch.data import (CorpusStore, build_layout_from_store,
                              carry_assignments, remap_canonical,
                              update_layout)
from repro_torch.data import sharding
from repro_torch.data.corpus import Corpus
from repro_torch.kernels.fused_sweep import rbucket

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, ALPHA, BETA, SWEEPS = 8, 0.5, 0.01, 2


def _corpus(num_docs=40, vocab=96, seed=0, mean_len=15.0):
    """The reference's corpus, as a port ``Corpus`` too."""
    cj, _, _ = jsyn.make_corpus(num_docs=num_docs, vocab_size=vocab,
                                num_topics=8, mean_doc_len=mean_len,
                                seed=seed)
    return cj, Corpus(cj.doc_ids.copy(), cj.word_ids.copy(), cj.num_docs,
                      cj.num_words)


def _assert_same_layout(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert x.tobytes() == y.tobytes(), f.name
        else:
            assert x == y, f.name


def _assert_same_files(a: str, b: str):
    """Two store directories hold the same files: meta and side file
    equal, every npz member equal in dtype, shape and bytes."""
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".json"):
            assert json.load(open(pa)) == json.load(open(pb)), name
        elif name.endswith(".npy"):
            x, y = np.load(pa), np.load(pb)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
        else:
            with np.load(pa) as x, np.load(pb) as y:
                assert sorted(x.files) == sorted(y.files), name
                for m in x.files:
                    assert x[m].dtype == y[m].dtype, (name, m)
                    assert x[m].tobytes() == y[m].tobytes(), (name, m)


@pytest.mark.parametrize("per_shard", [37, 1 << 20])
def test_store_files_match_and_cross_both_ways(tmp_path, per_shard):
    cj, cp = _corpus(seed=4)
    mine = CorpusStore.from_corpus(cp, str(tmp_path / "port"),
                                   tokens_per_shard=per_shard)
    ref = jcs.CorpusStore.from_corpus(cj, str(tmp_path / "ref"),
                                      tokens_per_shard=per_shard)
    _assert_same_files(mine.path, ref.path)
    mine.retire(np.array([1, 7], np.int32))
    ref.retire(np.array([1, 7], np.int32))
    _assert_same_files(mine.path, ref.path)
    mine.append(np.array([40, 40], np.int32), np.array([3, 5], np.int32))
    ref.append(np.array([40, 40], np.int32), np.array([3, 5], np.int32))
    _assert_same_files(mine.path, ref.path)
    # each package opens the other's store and reads the same streams
    for opened, written in ((CorpusStore.open(ref.path), ref),
                            (jcs.CorpusStore.open(mine.path), mine)):
        assert opened.num_docs == written.num_docs == 41
        assert opened.num_tokens == written.num_tokens
        np.testing.assert_array_equal(opened.doc_lengths(),
                                      written.doc_lengths())
        np.testing.assert_array_equal(opened.word_freqs(),
                                      written.word_freqs())
        for (d0, w0), (d1, w1) in zip(opened.iter_tokens(),
                                      written.iter_tokens(), strict=True):
            np.testing.assert_array_equal(d0, d1)
            np.testing.assert_array_equal(w0, w1)
    back = mine.to_corpus()
    live = ~np.isin(cp.doc_ids, [1, 7])
    np.testing.assert_array_equal(back.doc_ids[:-2], cp.doc_ids[live])
    np.testing.assert_array_equal(back.word_ids[:-2], cp.word_ids[live])


def test_store_refuses_what_the_reference_refuses(tmp_path):
    store = CorpusStore.create(str(tmp_path / "s"), num_words=10)
    with pytest.raises(FileExistsError):
        CorpusStore.create(store.path, num_words=10)
    with pytest.raises(ValueError, match="range"):
        store.append(np.array([0], np.int32), np.array([99], np.int32))
    with pytest.raises(ValueError, match="1-D"):
        store.append(np.zeros((2, 2), np.int32), np.zeros((2, 2), np.int32))
    store.append(np.array([0, 1], np.int32), np.array([2, 3], np.int32))
    store.retire([1])
    with pytest.raises(ValueError, match="retired"):
        store.retire([1])
    with pytest.raises(ValueError, match="retired"):
        store.append(np.array([1], np.int32), np.array([0], np.int32))
    meta = json.load(open(os.path.join(store.path, "meta.json")))
    meta["format_version"] = 2
    json.dump(meta, open(os.path.join(store.path, "meta.json"), "w"))
    with pytest.raises(ValueError, match="format_version"):
        CorpusStore.open(store.path)


@pytest.mark.parametrize("per_shard", [53, 1 << 20])
@pytest.mark.parametrize("doc_tile", [None, 3, 8])
@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_streaming_build_is_byte_identical(tmp_path, kind, doc_tile,
                                           per_shard):
    cj, cp = _corpus(seed=2)
    mine = CorpusStore.from_corpus(cp, str(tmp_path / "port"),
                                   tokens_per_shard=per_shard).retire([0, 13])
    ref = jcs.CorpusStore.from_corpus(cj, str(tmp_path / "ref"),
                                      tokens_per_shard=per_shard
                                      ).retire([0, 13])
    kw = dict(n_workers=3, T=T, n_blocks=6, layout=kind, doc_tile=doc_tile)
    streamed = build_layout_from_store(mine, **kw)
    _assert_same_layout(streamed,
                        sharding.build_layout(mine.to_corpus(), **kw))
    _assert_same_layout(streamed, jcs.build_layout_from_store(ref, **kw))


def _grouped(kind, seed=3, lib=sharding):
    cj, cp = _corpus(num_docs=60, vocab=96, seed=seed, mean_len=20.0)
    return lib.build_layout(cj if lib is jsh else cp, n_workers=4, T=T,
                            n_blocks=8, layout=kind, doc_tile=4)


def _same_update(kind, **kw):
    """``update_layout`` of both packages on the reference's test layout:
    the layouts byte-identical and ``old_to_new`` equal → the port's."""
    mine, o2n = update_layout(_grouped(kind), **kw)
    want, o2n_ref = jcs.update_layout(_grouped(kind, lib=jsh), **kw)
    _assert_same_layout(mine, want)
    assert o2n.dtype == o2n_ref.dtype
    np.testing.assert_array_equal(o2n, o2n_ref)
    return mine, o2n


@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_update_survivors_keep_uid_and_order(kind):
    lay = _grouped(kind)
    r = np.random.default_rng(5)
    ad = np.repeat(np.arange(60, 64, dtype=np.int32), 15)
    aw = r.integers(0, 96, ad.size).astype(np.int32)
    new_lay, o2n = _same_update(kind, add_doc_ids=ad, add_word_ids=aw,
                                retire=[2, 30], num_new_docs=4)
    ow, ob, odl, _ = lay.token_coords()
    oslot = lay.extract_canonical(lay.tok_slot)
    surv = o2n >= 0
    np.testing.assert_array_equal(
        surv, ~np.isin(lay.doc_of_worker[ow, odl], [2, 30]))
    tgt = o2n[surv]
    nw, nb, _, _ = new_lay.token_coords()
    nslot = new_lay.extract_canonical(new_lay.tok_slot)
    np.testing.assert_array_equal(ow[surv], nw[tgt])
    np.testing.assert_array_equal(ob[surv], nb[tgt])
    np.testing.assert_array_equal(oslot[surv], nslot[tgt])
    assert (np.diff(tgt) > 0).all() and new_lay.L == lay.L
    z_old = np.random.default_rng(0).integers(
        0, T, lay.canon_idx.shape[0]).astype(np.int32)
    z_new = carry_assignments(z_old, o2n, new_lay, seed=1)
    want = jcs.carry_assignments(z_old, o2n, new_lay, seed=1)
    assert z_new.dtype == want.dtype
    np.testing.assert_array_equal(z_new, want)
    np.testing.assert_array_equal(z_old[surv], z_new[tgt])
    n_td, _, n_t = sharding.counts_from_layout(
        new_lay, new_lay.place_canonical(z_new), T)
    assert int(n_t.sum()) == new_lay.canon_idx.shape[0]
    assert int(n_td[[2, 30]].sum()) == 0


@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_update_overflow_routes_past_B_times_L(kind):
    lay = _grouped(kind)
    words = lay.word_of_block[0]
    words = words[words >= 0]
    n = int(lay.L) + 8
    new_lay, _ = _same_update(kind, add_doc_ids=np.full(n, 60, np.int32),
                              add_word_ids=np.resize(words, n).astype(
                                  np.int32), num_new_docs=1)
    nw, nb, _, _ = new_lay.token_coords()
    nslot = new_lay.extract_canonical(new_lay.tok_slot).astype(np.int64)
    uid = nb.astype(np.int64) * new_lay.L + nslot
    keyed = nw.astype(np.int64) * (int(uid.max()) + 1) + uid
    assert np.unique(keyed).size == keyed.size
    over = uid[nslot >= lay.L]
    assert over.size > 0 and int(over.min()) >= lay.B * lay.L


def test_update_refuses_what_the_reference_refuses():
    _, cp = _corpus()
    flat = sharding.build_layout(cp, n_workers=2, T=T)
    with pytest.raises(ValueError, match="doc_tile"):
        update_layout(flat, add_doc_ids=np.array([40], np.int32),
                      add_word_ids=np.array([0], np.int32))
    lay = sharding.build_layout(cp, n_workers=2, T=T, doc_tile=4)
    with pytest.raises(ValueError, match="fresh"):
        update_layout(lay, add_doc_ids=np.array([0], np.int32),
                      add_word_ids=np.array([0], np.int32))
    with pytest.raises(ValueError, match="range"):
        update_layout(lay, retire=[999])


def test_remap_canonical():
    o2n = np.array([2, -1, 0, 1])
    vals = np.array([10, 11, 12, 13])
    out = remap_canonical(vals, o2n, 3, fill=-5)
    np.testing.assert_array_equal(out, [12, 13, 10])
    np.testing.assert_array_equal(out, jcs.remap_canonical(vals, o2n, 3,
                                                           fill=-5))


# -- a live chain carried across an update --------------------------------
def _update_case(W, kind, lib):
    """The grouped layout of a W-worker run on the test corpus, and the
    update that retires documents 2 and 30 and adds 4 new ones."""
    cj, cp = _corpus(num_docs=60, vocab=96, seed=3, mean_len=20.0)
    lay = lib.build_layout(cj if lib is jsh else cp, n_workers=W, T=T,
                           n_blocks=2 * W, layout=kind, doc_tile=4)
    r = np.random.default_rng(5)
    ad = np.repeat(np.arange(60, 64, dtype=np.int32), 15)
    aw = r.integers(0, 96, ad.size).astype(np.int32)
    return lay, dict(add_doc_ids=ad, add_word_ids=aw, retire=[2, 30],
                     num_new_docs=4)


def carried_state(new_lay, z_canon, cap, build_side_table):
    """The chain state of ``z_canon`` on ``new_lay``: the counts rebuilt
    from the assignments and the sparse side tables (``cap`` > 0) made
    from ``n_td`` as ``init_arrays`` makes them."""
    n_td, n_wt, n_t = sharding.counts_from_layout(
        new_lay, new_lay.place_canonical(z_canon), T)
    state = {"z_canon": z_canon.astype(np.int32),
             "n_td": n_td.astype(np.int32), "n_wt": n_wt.astype(np.int32),
             "n_t": n_t.astype(np.int32)}
    if cap:
        padded = np.zeros((new_lay.W, new_lay.I_max, T), np.int32)
        m = new_lay.doc_of_worker >= 0
        padded[m] = state["n_td"][new_lay.doc_of_worker[m]]
        tpc, cnt = build_side_table(padded.reshape(-1, T), cap)
        shape = (new_lay.W, new_lay.I_max, cap)
        state.update(rb_topics=np.asarray(tpc).reshape(shape),
                     rb_counts=np.asarray(cnt).reshape(shape))
    return state


def _port_carry(W, kind, sync, ring, r_mode, seed0):
    """The port's run: 2 sweeps, the update, the carry, the restore into a
    paged trainer on the new layout and 2 more sweeps → per-sweep arrays
    of the second half, as numpy."""
    lay, upd = _update_case(W, kind, sharding)
    cap = T if r_mode == "sparse" else 0
    kw = dict(alpha=ALPHA, beta=BETA, sync_mode=sync, ring_mode=ring,
              r_mode=r_mode, inner_mode="fused", device="cpu")
    old = NomadLDA(layout=lay, doc_tile=4, **kw)
    a = old.init_arrays(seed=seed0)
    for s in range(SWEEPS):
        a = old.sweep(a, seed=s)
    new_lay, o2n = update_layout(lay, **upd)
    z = carry_assignments(lay.extract_canonical(a["z"].numpy()), o2n,
                          new_lay, seed=seed0)
    import torch
    state = carried_state(
        new_lay, z, cap,
        lambda x, c: rbucket.build_side_table(torch.as_tensor(x), c))
    new = NomadLDA(layout=new_lay, doc_tile=4, **kw)
    a, nxt = new.restore_chain_state(
        state, new._chain_meta(next_seed=SWEEPS))
    out = []
    for s in range(nxt, nxt + SWEEPS):
        a = new.sweep(a, seed=s)
        out.append({k: v.numpy() for k, v in a.items()})
    return new_lay, out


@pytest.mark.parametrize("kind,r_mode", [("ragged", "dense"),
                                         ("dense", "sparse")])
def test_carried_chain_equals_reference_one_worker(kind, r_mode):
    """W = 1 in process: the reference carries its own chain (unpaged,
    scan) across the same update; every array is equal after each of the
    2 sweeps after it."""
    new_lay, mine = _port_carry(1, kind, "stoken", "pipelined", r_mode, 1)
    lay, upd = _update_case(1, kind, jsh)
    cap = T if r_mode == "sparse" else 0
    mesh = jax.make_mesh((1,), ("worker",), devices=jax.devices()[:1])
    kw = dict(mesh=mesh, ring_axes=("worker",), alpha=ALPHA, beta=BETA,
              sync_mode="stoken", ring_mode="pipelined", r_mode=r_mode)
    old = JNomad(layout=lay, **kw)
    a = old.init_arrays(seed=1)
    for s in range(SWEEPS):
        a = old.sweep(a, seed=s)
    jlay, o2n = jcs.update_layout(lay, **upd)
    _assert_same_layout(new_lay, jlay)
    z = jcs.carry_assignments(lay.extract_canonical(np.asarray(a["z"])),
                              o2n, jlay, seed=1)
    state = carried_state(jlay, z, cap, jrbucket.build_side_table)
    new = JNomad(layout=jlay, **kw)
    a, nxt = new.restore_chain_state(state,
                                     new._chain_meta(next_seed=SWEEPS))
    for s in range(SWEEPS):
        a = new.sweep(a, seed=nxt + s)
        for k in a:
            np.testing.assert_array_equal(mine[s][k], np.asarray(a[k]),
                                          err_msg=f"sweep {s} {k}")


# W = 4 against one subprocess that fakes four CPU devices: the reference
# runs each combination's chain, update, carry and 2 more sweeps, unpaged.
_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, sys.argv[3])
import jax
import numpy as np
from repro.core.nomad import NomadLDA
from repro.data import corpus_store, sharding
from repro.kernels.fused_sweep import rbucket
from test_torch_corpus_store import _update_case, carried_state, T
spec = json.loads(sys.argv[1])
out = {}
for i, (kind, sync, ring, r_mode) in enumerate(spec["combos"]):
    lay, upd = _update_case(4, kind, sharding)
    mesh = jax.make_mesh((4,), ("worker",))
    kw = dict(mesh=mesh, ring_axes=("worker",), alpha=spec["alpha"],
              beta=spec["beta"], sync_mode=sync, ring_mode=ring,
              r_mode=r_mode)
    old = NomadLDA(layout=lay, **kw)
    a = old.init_arrays(seed=i)
    for s in range(spec["sweeps"]):
        a = old.sweep(a, seed=s)
    new_lay, o2n = corpus_store.update_layout(lay, **upd)
    z = corpus_store.carry_assignments(
        lay.extract_canonical(np.asarray(a["z"])), o2n, new_lay, seed=i)
    state = carried_state(new_lay, z, T if r_mode == "sparse" else 0,
                          rbucket.build_side_table)
    new = NomadLDA(layout=new_lay, **kw)
    a, nxt = new.restore_chain_state(
        state, new._chain_meta(next_seed=spec["sweeps"]))
    for s in range(spec["sweeps"]):
        a = new.sweep(a, seed=nxt + s)
        for k, v in a.items():
            out[f"{i}/{s}/{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""
COMBOS_W4 = [("ragged", "stoken", "pipelined", "dense"),
             ("dense", "stale", "barrier", "sparse"),
             ("ragged", "allreduce", "pipelined", "sparse")]


@pytest.fixture(scope="module")
def reference_w4(tmp_path_factory):
    path = tmp_path_factory.mktemp("carry") / "reference.npz"
    spec = dict(alpha=ALPHA, beta=BETA, sweeps=SWEEPS, combos=COMBOS_W4)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REFERENCE,
                          json.dumps(spec), str(path),
                          os.path.join(REPO, "tests")],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("i", range(len(COMBOS_W4)))
def test_carried_chain_equals_reference_four_workers(reference_w4, i):
    kind, sync, ring, r_mode = COMBOS_W4[i]
    _, mine = _port_carry(4, kind, sync, ring, r_mode, i)
    for name, want in reference_w4.items():
        j, s, k = name.split("/")
        if int(j) == i:
            np.testing.assert_array_equal(
                mine[int(s)][k], want,
                err_msg=f"{COMBOS_W4[i]} sweep {s} {k}")
