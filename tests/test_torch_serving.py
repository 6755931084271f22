"""The port's serving path against the JAX reference: snapshots, the φ
store, the publish gate, ``fetch_snapshot``'s retry split, and whole
``LdaEngine`` queries, bit for bit.  Also the port's import boundary."""
import ast
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.fault import FaultPlan as RefFaultPlan
from repro.fault import FaultSpec as RefFaultSpec
from repro.fault import install as ref_install
from repro.serve import lda_engine as ref_engine
from repro.train import checkpoint as ref_ckpt
from repro_torch import fault, rng
from repro_torch.convert import key_from_reference, snapshot_from_reference
from repro_torch.core.heldout import theta_from_counts
from repro_torch.serve import lda_engine as port_engine
from repro_torch.train import checkpoint as port_ckpt

ROOT = pathlib.Path(__file__).resolve().parents[1]
ALPHA, BETA, SWEEPS = 0.1, 0.01, 2


def _counts(J, T, seed=0):
    r = np.random.default_rng(seed)
    n_wt = r.integers(0, 50, (J, T))
    n_wt[r.random((J, T)) < 0.6] = 0          # sparse, as trained counts
    return n_wt, n_wt.sum(0)


@pytest.fixture(scope="module", params=[48, 64])
def snaps(request):
    """The same counts frozen by both packages, at T=48 and T=64."""
    n_wt, n_t = _counts(512, request.param)
    ref = ref_engine.snapshot_from_counts(n_wt, n_t, alpha=ALPHA, beta=BETA)
    port = port_engine.snapshot_from_counts(n_wt, n_t, alpha=ALPHA,
                                            beta=BETA)
    return ref, port


@pytest.mark.parametrize("beta", [0.01, 0.1, 1 / 3])
def test_snapshot_from_counts_bit_equal(beta):
    n_wt, n_t = _counts(257, 48, seed=1)
    ref = ref_engine.snapshot_from_counts(n_wt, n_t, alpha=ALPHA, beta=beta)
    port = port_engine.snapshot_from_counts(n_wt, n_t, alpha=ALPHA,
                                            beta=beta)
    assert port.phi.dtype == np.float32
    np.testing.assert_array_equal(port.phi.view(np.uint32),
                                  ref.phi.view(np.uint32))
    assert port.meta == ref.meta


@pytest.mark.parametrize("T", [48, 1024])
def test_theta_from_counts_matches_engine_jit(T):
    """θ as the reference engine forms it under ``jit`` (T·α an f32
    product), at a T that is a power of two and one that is not."""
    r = np.random.default_rng(T)
    n_td = r.integers(0, 5, (64, T)).astype(np.int32)
    n_td[: T // 2 if T < 100 else 8] = 0
    n_td[0] = 0
    want = np.asarray(jax.jit(ref_engine.theta_from_counts)(n_td, 0.0137))
    got = theta_from_counts(torch.as_tensor(n_td), 0.0137).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_phi_files_cross_load(snaps, tmp_path):
    ref, port = snaps
    a, b = str(tmp_path / "from_ref"), str(tmp_path / "from_port")
    ref.save(a)
    port.save(b)
    phi, meta = port_ckpt.load_phi(a)
    np.testing.assert_array_equal(phi, ref.phi)
    assert meta["digest"] == ref.digest == port_ckpt.phi_digest(phi)
    phi, meta = ref_ckpt.load_phi(b)
    np.testing.assert_array_equal(phi, port.phi)
    assert meta["digest"] == port.digest == ref_ckpt.phi_digest(phi)
    with np.load(a + ".npz") as data:
        stamped = json.loads(bytes(data["__phi_meta__"]).decode())
        port_ckpt._verify_payload_digests(a, {"phi": data["phi"]}, stamped)


def test_load_refuses_tampering_like_reference(snaps, tmp_path):
    ref, _ = snaps
    for name, meta in [("version", dict(ref.meta, format_version=99)),
                       ("digest", dict(ref.meta, digest="0" * 64))]:
        p = str(tmp_path / name)
        ref_ckpt._atomic_savez(p, {"phi": ref.phi}, meta,
                               ref_ckpt._PHI_META_KEY)
        with pytest.raises(Exception) as want:
            ref_ckpt.load_phi(p)
        with pytest.raises(Exception) as got:
            port_ckpt.load_phi(p)
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)


def _gate_outcomes(mod, engine, snap, make):
    """Publish four bad candidates; name what each raised."""
    out = []
    bad = [
        make(snap.phi, {**snap.meta, "format_version": 99}),
        make(snap.phi + 1.0, dict(snap.meta)),
        mod.snapshot_from_counts(np.ones((snap.phi.shape[0] + 1,
                                          snap.phi.shape[1])),
                                 np.ones(snap.phi.shape[1]), alpha=ALPHA,
                                 beta=BETA),
        make(snap.phi, {**snap.meta, "sweep": 3}),
    ]
    for cand in bad:
        try:
            engine.publish(cand)
            out.append("published")
        except ValueError as e:
            out.append(type(e).__name__)
    return out, engine.generation, engine.stats()["rejected_publishes"]


def test_publish_gate_matches_reference(snaps):
    ref, port = snaps
    ref_eng = ref_engine.LdaEngine(ref_engine.PhiSnapshot(
        ref.phi, {**ref.meta, "sweep": 5}), sweeps=SWEEPS)
    port_eng = port_engine.LdaEngine(port_engine.PhiSnapshot(
        port.phi, {**port.meta, "sweep": 5}), sweeps=SWEEPS, device="cpu")
    want = _gate_outcomes(ref_engine, ref_eng, ref, ref_engine.PhiSnapshot)
    got = _gate_outcomes(port_engine, port_eng, port,
                         port_engine.PhiSnapshot)
    assert got == want
    assert got[0] == ["FormatVersionError", "SnapshotCorruptError",
                      "ValueError", "StaleGenerationError"]


def _fetch_outcome(mod, plan, install, path):
    slept = []
    with install(plan):
        try:
            snap = mod.fetch_snapshot(path, retries=3, backoff_s=0.01,
                                      sleep=slept.append)
            result = snap.digest
        except ValueError as e:
            result = type(e).__name__
    return result, slept, plan._counters.get("serve.fetch")


@pytest.mark.parametrize("damage", ["transient", "exhausted", "version",
                                    "digest"])
def test_fetch_snapshot_retry_split_matches_reference(snaps, tmp_path,
                                                      damage):
    ref, _ = snaps
    p = str(tmp_path / "phi.npz")
    ref.save(p)
    fails = {"transient": 2, "exhausted": 9}.get(damage, 0)
    if damage in ("version", "digest"):
        with np.load(p) as data:
            payload = {k: data[k] for k in data.files}
        meta = json.loads(bytes(payload["__phi_meta__"]).decode())
        meta.update(format_version=999) if damage == "version" else \
            meta.update(digest="0" * 64)
        payload["__phi_meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                                np.uint8)
        np.savez(p, **payload)

    def plans(plan_cls, spec_cls):
        specs = [spec_cls("fail", "serve.fetch", at=0, count=fails)] \
            if fails else []
        return plan_cls(specs)

    want = _fetch_outcome(ref_engine, plans(RefFaultPlan, RefFaultSpec),
                          ref_install, p)
    got = _fetch_outcome(port_engine, plans(fault.FaultPlan,
                                            fault.FaultSpec),
                         fault.install, p)
    assert got == want


def _docs(J, lengths, seed):
    r = np.random.default_rng(seed)
    return tuple(r.integers(0, J, n).astype(np.int32) for n in lengths)


@pytest.mark.parametrize("inner_mode,long_doc", [
    pytest.param("fused", False, id="fused"),
    pytest.param("scan", False, id="scan"),
    # a 9,000-token document in its own bucket of L = 16,384: on the card
    # the fold-in kernel's long placement, at one sweep
    pytest.param("fused", True, id="fused-long")])
def test_engine_query_matches_reference(snaps, inner_mode, long_doc):
    """A mixed-length query with an empty document and an outlier that
    splits off its own length bucket: n_td and θ equal the reference
    engine's (scan mode; its fused mode cannot trace on jax 0.9.0)."""
    ref, port = snaps
    lengths = [5, 7, 0, 9, 6, 9000 if long_doc else 60, 12]
    sweeps = 1 if long_doc else SWEEPS
    docs = _docs(512, lengths, seed=1)
    k = jax.random.key(7)
    want = ref_engine.LdaEngine(ref, sweeps=sweeps, inner_mode="scan").query(
        ref_engine.TopicQuery(docs=docs, key=k))
    eng = port_engine.LdaEngine(snapshot_from_reference(ref.phi, ref.meta),
                                sweeps=sweeps, inner_mode=inner_mode,
                                device="cpu")
    got = eng.query(port_engine.TopicQuery(
        docs=docs, key=key_from_reference(
            np.asarray(jax.random.key_data(k)), "cpu")))
    assert got.batch_shape == want.batch_shape == (
        (8, 16), (1, 16384 if long_doc else 64))
    np.testing.assert_array_equal(got.n_td, want.n_td)
    np.testing.assert_array_equal(got.theta.view(np.uint32),
                                  want.theta.view(np.uint32))
    assert got.digest == want.digest == port.digest
    np.testing.assert_allclose(got.theta.sum(1), 1.0, rtol=1e-6)
    assert got.n_td[5].sum() == lengths[5]


def test_engine_default_key_matches_reference(snaps):
    ref, port = snaps
    docs = _docs(512, [3, 11], seed=2)
    want = ref_engine.LdaEngine(ref, sweeps=1, inner_mode="scan").query(
        ref_engine.TopicQuery(docs=docs))
    got = port_engine.LdaEngine(port, sweeps=1, device="cpu").query(
        port_engine.TopicQuery(docs=docs))
    np.testing.assert_array_equal(got.n_td, want.n_td)


def test_engine_admission_control(snaps):
    _, port = snaps
    eng = port_engine.LdaEngine(port, sweeps=SWEEPS, max_pending=1,
                                degrade_pending=1, degraded_sweeps=1,
                                device="cpu")
    q = port_engine.TopicQuery(docs=_docs(512, [4], seed=3))
    assert eng.query(q).sweeps_used == SWEEPS
    eng._pending = 1                      # one query already in flight
    with pytest.raises(fault.EngineOverloadedError):
        eng.query(q)
    eng.max_pending = 2
    res = eng.query(q)
    assert res.degraded and res.sweeps_used == 1
    assert eng.stats()["shed"] == 1 and eng.stats()["degraded"] == 1


def test_engine_needs_cuda_unless_asked_for_cpu(snaps, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_engine.LdaEngine(snaps[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        rng.key(0)
    assert port_engine.LdaEngine(snaps[1], device="cpu").generation == 1


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, name)
