"""The chain half of the port's checkpoint store
(``repro_torch/train/checkpoint.py``) against the reference's
(``repro/train/checkpoint.py``): each damage case of the reference's own
``TestLoadChainErrors`` and ``TestCheckpointRotation``
(``tests/test_fault.py``) gets the same outcome in both packages; files
written by either package (a chain ``.npz``, a rotation directory, a
``save``/``restore`` tree) load in the other with equal arrays and meta;
and a serial chain checkpointed by one package resumes in the other and
equals the reference's straight chain bit for bit."""
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import fault as jfault
from repro.core import cgs as jcgs
from repro.data import synthetic as jsyn
from repro.train import checkpoint as jckpt
from repro_torch import fault as pfault
from repro_torch import rng
from repro_torch.core import cgs
from repro_torch.data import synthetic
from repro_torch.train import checkpoint as pckpt

PACKAGES = {"reference": (jckpt, jfault), "port": (pckpt, pfault)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """``(checkpoint module, fault package)`` of one package."""
    return PACKAGES[request.param]


def _write_chain(ckpt, tmp_path, name="chain", n=16, seed=0):
    r = np.random.default_rng(seed)
    state = {"z": r.integers(0, 7, n).astype(np.int32),
             "n_t": r.integers(0, 50, 8).astype(np.int32)}
    path = ckpt.save_chain(str(tmp_path / name), state, {"next_seed": 3})
    return path, state


def _rewrite_meta(ckpt, path, **changes):
    with np.load(path) as data:
        payload = {k: data[k] for k in data.files}
    meta = json.loads(bytes(payload[ckpt._META_KEY].tobytes()).decode())
    meta.update(changes)
    payload[ckpt._META_KEY] = np.frombuffer(json.dumps(meta).encode(),
                                            np.uint8)
    np.savez(path, **payload)


# ---------------------------------------------------------------------------
# load_chain's failure surface, in both packages
# ---------------------------------------------------------------------------
def test_round_trip_stamps_version_and_digests(pkg, tmp_path):
    ckpt, _ = pkg
    path, state = _write_chain(ckpt, tmp_path)
    got, meta = ckpt.load_chain(path)
    np.testing.assert_array_equal(got["z"], state["z"])
    assert meta["next_seed"] == 3
    assert meta["format_version"] == ckpt.CHAIN_FORMAT_VERSION == 1
    assert set(meta["payload_sha256"]) == {"z", "n_t"}


@pytest.mark.parametrize("case", ["missing file", "truncated", "flipped byte",
                                  "no meta", "digest in meta", "version"])
def test_load_chain_errors(pkg, tmp_path, case):
    ckpt, fault = pkg
    if case == "missing file":
        with pytest.raises(FileNotFoundError):
            ckpt.load_chain(str(tmp_path / "nope"))
        return
    path, _ = _write_chain(ckpt, tmp_path)
    want, match = fault.SnapshotCorruptError, None
    if case == "truncated":
        os.truncate(path, os.path.getsize(path) // 3)
    elif case == "flipped byte":
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
            blobs = {n: bytearray(z.read(n)) for n in names}
        blobs["z.npy"][-1] ^= 0xFF
        with zipfile.ZipFile(path, "w") as z:
            for n in names:
                z.writestr(n, bytes(blobs[n]))
        match = "digest mismatch|unreadable"
    elif case == "no meta":
        path = str(tmp_path / "bare.npz")
        np.savez(path, z=np.arange(4, dtype=np.int32))
        match = "is not a chain checkpoint"
    elif case == "digest in meta":
        _rewrite_meta(ckpt, path, payload_sha256={"z": "0" * 64})
        match = "digest mismatch"
    else:
        _rewrite_meta(ckpt, path, format_version=999)
        want, match = fault.FormatVersionError, "format"
    with pytest.raises(want, match=match):
        ckpt.load_chain(path)
    with pytest.raises(ValueError):          # the typed errors are ValueErrors
        ckpt.load_chain(path)


def test_chain_write_fires_its_fault_site(pkg, tmp_path):
    ckpt, fault = pkg
    plan = fault.FaultPlan([fault.FaultSpec("corrupt", "chain.write", at=1,
                                            nbytes=8)], seed=3)
    with fault.install(plan):
        good, _ = _write_chain(ckpt, tmp_path, "a")
        bad, _ = _write_chain(ckpt, tmp_path, "b")
    assert plan.log == [("chain.write", 1, "corrupt")]
    ckpt.load_chain(good)
    with pytest.raises(fault.SnapshotCorruptError):
        ckpt.load_chain(bad)


# ---------------------------------------------------------------------------
# CheckpointRotation, in both packages
# ---------------------------------------------------------------------------
def _save_steps(rot, steps, seed=0):
    for step in steps:
        r = np.random.default_rng(seed + step)
        rot.save({"z": r.integers(0, 5, 12).astype(np.int32)},
                 {"next_seed": step}, step=step)


def test_rotation_keeps_prunes_and_points(pkg, tmp_path):
    ckpt, _ = pkg
    rot = ckpt.CheckpointRotation(str(tmp_path / "rot"), keep=3)
    _save_steps(rot, [1, 2, 3, 4, 5])
    assert [s for s, _ in rot.slots()] == [3, 4, 5]
    assert rot.last_good() == 5
    _, meta, step = rot.load_latest_valid()
    assert step == 5 and meta["next_seed"] == 5


def test_rotation_skips_a_damaged_newest_slot(pkg, tmp_path):
    ckpt, fault = pkg
    rot = ckpt.CheckpointRotation(str(tmp_path / "rot"), keep=3)
    _save_steps(rot, [1, 2, 3])
    plan = fault.FaultPlan([fault.FaultSpec("corrupt", "x", at=0, nbytes=8)])
    plan.fire("x", path=rot.slot_path(3))
    assert rot.last_good() == 3              # the pointer is not trusted
    _, meta, step = rot.load_latest_valid()
    assert step == 2 and meta["next_seed"] == 2


def test_rotation_refuses_when_every_slot_is_damaged(pkg, tmp_path):
    ckpt, fault = pkg
    rot = ckpt.CheckpointRotation(str(tmp_path / "rot"), keep=2)
    _save_steps(rot, [1, 2])
    for _, path in rot.slots():
        os.truncate(path, 10)
    with pytest.raises(fault.SnapshotCorruptError, match="every checkpoint"):
        rot.load_latest_valid()


def test_rotation_propagates_a_version_skew(pkg, tmp_path):
    ckpt, fault = pkg
    rot = ckpt.CheckpointRotation(str(tmp_path / "rot"), keep=2)
    _save_steps(rot, [1, 2])
    _rewrite_meta(ckpt, rot.slot_path(2), format_version=999)
    with pytest.raises(fault.FormatVersionError):
        rot.load_latest_valid()


def test_rotation_empty_dir_and_keep_validation(pkg, tmp_path):
    ckpt, _ = pkg
    with pytest.raises(FileNotFoundError):
        ckpt.CheckpointRotation(str(tmp_path / "rot")).load_latest_valid()
    with pytest.raises(ValueError, match="keep"):
        ckpt.CheckpointRotation(str(tmp_path), keep=0)


# ---------------------------------------------------------------------------
# Files cross between the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_chain_files_cross_packages(writer, tmp_path):
    reader = "port" if writer == "reference" else "reference"
    w, r = PACKAGES[writer][0], PACKAGES[reader][0]
    path, state = _write_chain(w, tmp_path, n=40, seed=5)
    got, meta = r.load_chain(path)
    assert sorted(got) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(got[k], state[k])
    assert meta == w.load_chain(path)[1]
    rot_w = w.CheckpointRotation(str(tmp_path / "rot"), keep=2)
    _save_steps(rot_w, [4, 5, 6], seed=9)
    rot_r = r.CheckpointRotation(str(tmp_path / "rot"), keep=2)
    assert rot_r.slots() == rot_w.slots()
    assert rot_r.last_good() == 6
    a, ma, sa = rot_r.load_latest_valid()
    b, mb, sb = rot_w.load_latest_valid()
    assert sa == sb == 6 and ma == mb
    np.testing.assert_array_equal(a["z"], b["z"])


def _tree_np():
    r = np.random.default_rng(2)
    return {"b": [r.random((3, 2)).astype(np.float32),
                  (np.arange(4, dtype=np.int32), None)],
            "a": {"w": r.random(5).astype(ml_dtypes.bfloat16)},
            "c": r.integers(0, 9, (2, 2)).astype(np.int64)}


def test_save_restore_trees_cross_packages(tmp_path):
    tree = _tree_np()
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = {"b": [torch.from_numpy(tree["b"][0]),
                   (torch.from_numpy(tree["b"][1][0]), None)],
             "a": {"w": torch.from_numpy(
                 tree["a"]["w"].astype(np.float32)).to(torch.bfloat16)},
             "c": torch.from_numpy(tree["c"])}
    jckpt.save(str(tmp_path / "ref"), jtree)
    pckpt.save(str(tmp_path / "port"), ttree)
    for name in ("ref", "port"):
        with np.load(tmp_path / f"{name}.npz") as d:
            files = {k: d[k] for k in d.files}
        assert sorted(files) == ["a/w", "b/0", "b/1/0", "c"]
        assert files["a/w"].dtype == np.float32     # bf16 stored as f32
        np.testing.assert_array_equal(files["b/1/0"], tree["b"][1][0])
        np.testing.assert_array_equal(
            files["a/w"], tree["a"]["w"].astype(np.float32))
    back = pckpt.restore(str(tmp_path / "ref.npz"), ttree)
    assert back["a"]["w"].dtype == torch.bfloat16
    assert back["b"][1][1] is None and isinstance(back["b"][1], tuple)
    for got, want in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.float().numpy(), back)),
            jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    back_j = jckpt.restore(str(tmp_path / "port"), jtree)
    for got, want in zip(jax.tree_util.tree_leaves(back_j),
                         jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError, match="shape"):
        pckpt.restore(str(tmp_path / "ref"),
                      dict(ttree, c=torch.zeros(3, dtype=torch.int64)))


# ---------------------------------------------------------------------------
# A serial chain resumes across the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_serial_chain_resumes_across_packages(writer, tmp_path):
    kw = dict(num_docs=30, vocab_size=60, num_topics=8, mean_doc_len=10.0,
              seed=6)
    cj, _, _ = jsyn.make_corpus(**kw)
    cp, _, _ = synthetic.make_corpus(**kw)
    T, alpha, beta, n, k = 16, 50.0 / 16, 0.01, 4, 2
    order, bound = cp.word_order(), cp.word_boundary()
    jargs = (jnp.asarray(cj.doc_ids), jnp.asarray(cj.word_ids),
             jnp.asarray(order), jnp.asarray(bound), alpha, beta)
    pargs = (cp.doc_ids, cp.word_ids, order, bound, alpha, beta)
    straight = jcgs.init_state(cj, T, jax.random.key(4))
    for _ in range(n):
        straight = jcgs.sweep_fplda_word(straight, *jargs, backend="fused")
    path = str(tmp_path / "serial.npz")
    if writer == "reference":
        s = jcgs.init_state(cj, T, jax.random.key(4))
        for _ in range(k):
            s = jcgs.sweep_fplda_word(s, *jargs, backend="fused")
        jckpt.save_chain(path, jcgs.state_to_checkpoint(s), {"sweeps": k})
        state, meta = pckpt.load_chain(path)
        sp = cgs.state_from_checkpoint(state, device="cpu")
        for _ in range(n - meta["sweeps"]):
            sp = cgs.sweep_fplda_word(sp, *pargs, backend="fused")
        got = cgs.state_to_checkpoint(sp)
    else:
        sp = cgs.init_state(cp, T, rng.key(4, "cpu"))
        for _ in range(k):
            sp = cgs.sweep_fplda_word(sp, *pargs, backend="fused")
        pckpt.save_chain(path, cgs.state_to_checkpoint(sp), {"sweeps": k})
        state, meta = jckpt.load_chain(path)
        assert state["key_data"].dtype == np.uint32
        s = jcgs.state_from_checkpoint(state)
        for _ in range(n - meta["sweeps"]):
            s = jcgs.sweep_fplda_word(s, *jargs, backend="fused")
        got = jcgs.state_to_checkpoint(s)
    want = jcgs.state_to_checkpoint(straight)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
