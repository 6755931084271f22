"""The port's nomad trainer (``repro_torch/core/nomad.py``) against the JAX
``NomadLDA``: from the same corpus, layout, seed and modes, ``z``,
``n_td``, ``n_wt``, ``n_t`` and the side tables are bit-equal after every
sweep, the φ snapshot too.  The log-likelihood agrees to a relative
5e-4: the reference sums f32 ``gammaln`` terms in f32, over a sharded
table, and its terms are ten times the total in magnitude, so its own
rounding reaches ~1.2e-4 of the total here; the port sums the same f32
terms in f64 and is within 1e-7 of an f64 evaluation of them.

W = 1 runs against the reference on one CPU device in this process.
W ∈ {2, 4} runs against one subprocess that fakes four CPU devices, as
``repro/launch/lda_dist_check.py`` does, and writes the reference's arrays
to an npz; that covers the sync × ring × r-mode grid on the ragged and
the dense layout, ungrouped and grouped by ``doc_tile``.  On a grouped
layout the port pages ``n_td`` (``doc_tile=``) and the reference runs
unpaged: its paged kernels do not trace on the installed jax, and the
reference holds paged and unpaged equal.  The ``"vectorized"`` inner mode
runs the same grid (the port's against the reference's; ``doc_tile=`` is
given to it and ignored) and W = 1 in process, and its dense and ragged
chains are equal.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.nomad import NomadLDA as JNomad
from repro.data import sharding as jsh
from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch.core.nomad import NomadLDA
from repro_torch.data import sharding
from repro_torch.data import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, ALPHA, BETA, SWEEPS = 16, 50.0 / 16, 0.01, 2
LL_RTOL = 5e-4
CORPUS = dict(num_docs=40, vocab_size=80, num_topics=8, mean_doc_len=12.0,
              seed=2)
FIELDS = ("z", "n_td", "n_wt", "n_t")
DOC_BLK = 8                      # the grouped dense grid's step
# (W, B, sync, ring, r_mode, r_cap from the layout, JAX inner mode,
#  layout kind, doc_tile or 0)
COMBOS = [
    (2, 4, "stoken", "pipelined", "dense", False, "fused", "ragged", 0),
    (2, 2, "stale", "barrier", "sparse", True, "scan", "ragged", 0),
    (2, 6, "allreduce", "pipelined", "sparse", False, "scan", "ragged", 0),
    (4, 8, "stoken", "pipelined", "dense", False, "scan", "ragged", 0),
    (4, 8, "stoken", "barrier", "sparse", True, "scan", "ragged", 0),
    (4, 12, "allreduce", "barrier", "dense", False, "scan", "ragged", 0),
    (4, 8, "stale", "pipelined", "dense", False, "scan", "ragged", 0),
    (2, 4, "stoken", "pipelined", "dense", False, "fused", "dense", 0),
    (2, 2, "stale", "barrier", "sparse", True, "scan", "dense", 0),
    (4, 8, "allreduce", "pipelined", "sparse", False, "scan", "dense", 0),
    (4, 12, "stoken", "barrier", "dense", False, "scan", "dense", 0),
    (2, 4, "stoken", "pipelined", "sparse", False, "scan", "ragged", 4),
    (4, 8, "stale", "barrier", "dense", False, "scan", "ragged", 4),
    (2, 6, "allreduce", "pipelined", "dense", True, "scan", "dense", 4),
    (4, 8, "stoken", "pipelined", "sparse", False, "scan", "dense", 4),
    (2, 4, "stoken", "pipelined", "dense", False, "vectorized", "ragged", 0),
    (2, 6, "stale", "barrier", "dense", False, "vectorized", "ragged", 0),
    (4, 8, "allreduce", "pipelined", "dense", False, "vectorized", "ragged",
     0),
    (4, 12, "stoken", "barrier", "dense", False, "vectorized", "ragged", 0),
    (2, 4, "allreduce", "barrier", "dense", False, "vectorized", "dense", 0),
    (4, 8, "stoken", "pipelined", "dense", False, "vectorized", "dense", 0),
    (4, 12, "stale", "pipelined", "dense", False, "vectorized", "dense", 0),
    (2, 4, "stoken", "pipelined", "dense", False, "vectorized", "ragged", 4),
    (4, 8, "allreduce", "barrier", "dense", False, "vectorized", "dense", 4),
]

# Runs in a fresh interpreter: the device count must be set before jax
# is imported.
_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import numpy as np
from repro.core.nomad import NomadLDA
from repro.data import synthetic
from repro.data.sharding import build_layout
spec = json.loads(sys.argv[1])
corpus, _, _ = synthetic.make_corpus(**spec["corpus"])
out = {}
for i, (W, B, sync, ring, r_mode, cap, inner, kind, dt) in enumerate(
        spec["combos"]):
    grouped = {}
    if dt:
        grouped = dict(doc_tile=dt, doc_blk=spec["doc_blk"]
                       if kind == "dense" else None)
    lay = build_layout(corpus, n_workers=W, T=spec["T"], n_blocks=B,
                       layout=kind, **grouped)
    mesh = jax.make_mesh((W,), ("worker",), devices=jax.devices()[:W])
    m = NomadLDA(mesh=mesh, ring_axes=("worker",), layout=lay,
                 alpha=spec["alpha"], beta=spec["beta"], sync_mode=sync,
                 inner_mode=inner, ring_mode=ring, r_mode=r_mode,
                 r_cap=lay.r_cap if cap else 0)
    a = m.init_arrays(seed=i)
    for s in range(spec["sweeps"]):
        a = m.sweep(a, seed=10 * i + s)
        for k, v in a.items():
            out[f"{i}/{s}/{k}"] = np.asarray(v)
    out[f"{i}/ll"] = np.float64(m.log_likelihood(a))
    out[f"{i}/phi"] = m.export_phi_snapshot(a).phi
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("nomad") / "reference.npz"
    spec = dict(corpus=CORPUS, T=T, alpha=ALPHA, beta=BETA, sweeps=SWEEPS,
                combos=COMBOS, doc_blk=DOC_BLK)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REFERENCE,
                          json.dumps(spec), str(path)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(path))


def _layout(W, B, kind="ragged", dt=0, lib=sharding, corpus=None):
    """``build_layout`` of the port (or of the reference, ``lib=jsh``) on
    the test corpus; ``dt`` > 0 groups it by ``doc_tile``."""
    if corpus is None:
        corpus, _, _ = synthetic.make_corpus(**CORPUS)
    grouped = {}
    if dt:
        grouped = dict(doc_tile=dt,
                       doc_blk=DOC_BLK if kind == "dense" else None)
    return lib.build_layout(corpus, n_workers=W, T=T, n_blocks=B,
                            layout=kind, **grouped)


def _port(W, B, sync, ring, r_mode, cap, inner_mode="fused", kind="ragged",
          dt=0, page=True):
    lay = _layout(W, B, kind, dt)
    return NomadLDA(layout=lay, alpha=ALPHA, beta=BETA, sync_mode=sync,
                    ring_mode=ring, r_mode=r_mode,
                    r_cap=lay.r_cap if cap else 0, inner_mode=inner_mode,
                    doc_tile=dt if dt and page else None, device="cpu")


@pytest.mark.parametrize("i", range(len(COMBOS)))
def test_ring_matches_reference_on_fake_devices(reference, i):
    W, B, sync, ring, r_mode, cap, inner, kind, dt = COMBOS[i]
    model = _port(W, B, sync, ring, r_mode, cap, kind=kind, dt=dt,
                  inner_mode="vectorized" if inner == "vectorized"
                  else "fused")
    arrays = model.init_arrays(seed=i)
    keys = FIELDS + (("rb_topics", "rb_counts") if r_mode == "sparse"
                     else ())
    for s in range(SWEEPS):
        arrays = model.sweep(arrays, seed=10 * i + s)
        for k in keys:
            np.testing.assert_array_equal(
                arrays[k].numpy(), reference[f"{i}/{s}/{k}"],
                err_msg=f"{COMBOS[i]} sweep {s} {k}")
    np.testing.assert_allclose(model.log_likelihood(arrays),
                               float(reference[f"{i}/ll"]), rtol=LL_RTOL)
    np.testing.assert_array_equal(model.export_phi_snapshot(arrays).phi,
                                  reference[f"{i}/phi"])


@pytest.mark.parametrize("sync,ring,r_mode", [
    ("stoken", "pipelined", "dense"), ("stale", "barrier", "sparse"),
    ("allreduce", "pipelined", "sparse")])
def test_one_worker_matches_reference_in_process(sync, ring, r_mode):
    """W = 1 against the reference on one CPU device, the port started
    from the reference's own initial arrays (``convert``)."""
    _one_worker_in_process(sync, ring, r_mode, "scan")


@pytest.mark.parametrize("sync,ring", [
    ("stoken", "pipelined"), ("stale", "barrier"), ("allreduce", "barrier")])
def test_one_worker_vectorized_matches_reference_in_process(sync, ring):
    """The same for the vectorized inner mode."""
    _one_worker_in_process(sync, ring, "dense", "vectorized")


def _one_worker_in_process(sync, ring, r_mode, inner):
    corpus, _, _ = jsyn.make_corpus(**CORPUS)
    lay_j = jsh.build_layout(corpus, n_workers=1, T=T, n_blocks=3,
                             layout="ragged")
    mesh = jax.make_mesh((1,), ("worker",), devices=jax.devices()[:1])
    jm = JNomad(mesh=mesh, ring_axes=("worker",), layout=lay_j, alpha=ALPHA,
                beta=BETA, sync_mode=sync, ring_mode=ring, r_mode=r_mode,
                inner_mode=inner)
    pm = _port(1, 3, sync, ring, r_mode, False, inner_mode=inner)
    ja = jm.init_arrays(seed=5)
    pa = convert.nomad_arrays_from_reference(
        {k: np.asarray(v) for k, v in ja.items()}, device="cpu")
    own = pm.init_arrays(seed=5)
    for k in own:
        assert torch.equal(own[k], pa[k]), k
    for s in range(SWEEPS):
        ja, pa = jm.sweep(ja, seed=s), pm.sweep(pa, seed=s)
        for k in ja:
            np.testing.assert_array_equal(pa[k].numpy(), np.asarray(ja[k]),
                                          err_msg=f"sweep {s} {k}")
    back = convert.nomad_arrays_to_reference(pa)
    assert back["tok_valid"].dtype == np.asarray(ja["tok_valid"]).dtype
    for got, want in zip(pm.global_counts(pa), jm.global_counts(ja)):
        np.testing.assert_array_equal(got, want)
    sj, sp = jm.export_phi_snapshot(ja, sweep=2), pm.export_phi_snapshot(
        pa, sweep=2)
    np.testing.assert_array_equal(sp.phi, sj.phi)
    assert sp.meta == sj.meta


def test_scan_and_fused_modes_agree_and_sweep_is_pure():
    model = _port(2, 4, "stoken", "pipelined", "dense", False)
    scan = _port(2, 4, "stoken", "pipelined", "dense", False,
                 inner_mode="scan")
    a0 = model.init_arrays(seed=1)
    before = {k: v.clone() for k, v in a0.items()}
    a, b = model.sweep(a0, seed=0), scan.sweep(a0, seed=0)
    for k in a0:
        assert torch.equal(a0[k], before[k]), k
        assert torch.equal(a[k], b[k]), k
    assert model.log_likelihood(a) > model.log_likelihood(a0)


@pytest.mark.parametrize("sync,ring,r_mode,kind,dt", [
    ("stoken", "pipelined", "dense", "dense", 0),
    ("stale", "barrier", "sparse", "ragged", 4),
    ("allreduce", "pipelined", "dense", "dense", 4)])
def test_one_worker_dense_and_grouped_match_reference(sync, ring, r_mode,
                                                      kind, dt):
    """W = 1 on the dense and the grouped layouts, the port (paged where
    grouped) started from the reference's arrays, ``tok_slot`` and
    ``doc_tile_of`` among them (``convert``)."""
    corpus, _, _ = jsyn.make_corpus(**CORPUS)
    lay_j = _layout(1, 3, kind, dt, lib=jsh, corpus=corpus)
    mesh = jax.make_mesh((1,), ("worker",), devices=jax.devices()[:1])
    jm = JNomad(mesh=mesh, ring_axes=("worker",), layout=lay_j, alpha=ALPHA,
                beta=BETA, sync_mode=sync, ring_mode=ring, r_mode=r_mode)
    pm = _port(1, 3, sync, ring, r_mode, False, kind=kind, dt=dt)
    ja = jm.init_arrays(seed=7)
    pa = convert.nomad_arrays_from_reference(
        {k: np.asarray(v) for k, v in ja.items()}, device="cpu")
    own = pm.init_arrays(seed=7)
    assert sorted(own) == sorted(pa)
    for k in own:
        assert torch.equal(own[k], pa[k]), k
    for s in range(SWEEPS):
        ja, pa = jm.sweep(ja, seed=s), pm.sweep(pa, seed=s)
        for k in ja:
            np.testing.assert_array_equal(pa[k].numpy(), np.asarray(ja[k]),
                                          err_msg=f"sweep {s} {k}")
    np.testing.assert_array_equal(pm.export_phi_snapshot(pa).phi,
                                  jm.export_phi_snapshot(ja).phi)


@pytest.mark.parametrize("r_mode", ["dense", "sparse"])
def test_layouts_and_paging_run_one_chain(r_mode):
    """The port's own chains: on one corpus, seed and modes the dense
    grid equals the ragged stream, in both ring modes and in scan mode;
    on the grouped order, paged equals unpaged equals scan, dense equals
    ragged.  Canonical ``z`` and the global counts after every sweep."""
    def chain(kind, dt=0, page=True, ring="pipelined", inner="fused"):
        m = _port(2, 4, "stoken", ring, r_mode, False, inner_mode=inner,
                  kind=kind, dt=dt, page=page)
        a = m.init_arrays(seed=3)
        out = []
        for s in range(SWEEPS):
            a = m.sweep(a, seed=s)
            out.append((m.layout.extract_canonical(a["z"].numpy()),
                        *m.global_counts(a)))
        return out

    def same(runs):
        for run in runs[1:]:
            for got, want in zip(run, runs[0]):
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)

    same([chain("ragged"), chain("dense"), chain("dense", ring="barrier"),
          chain("ragged", inner="scan")])
    same([chain("ragged", 4), chain("ragged", 4, page=False),
          chain("dense", 4), chain("dense", 4, page=False, ring="barrier"),
          chain("ragged", 4, inner="scan")])


@pytest.mark.parametrize("dt", [0, 4])
def test_vectorized_layouts_run_one_chain(dt):
    """The vectorized mode's own chains: on one corpus, seed and modes the
    dense grid equals the ragged stream in both ring modes, ungrouped and
    grouped (``doc_tile=`` given, and ignored); canonical ``z`` and the
    global counts after every sweep; the sweep leaves its input alone and
    the log-likelihood rises."""
    def chain(kind, ring):
        m = _port(2, 4, "stoken", ring, "dense", False,
                  inner_mode="vectorized", kind=kind, dt=dt)
        assert not m.paged
        a0 = m.init_arrays(seed=3)
        before = {k: v.clone() for k, v in a0.items()}
        a, out = a0, []
        for s in range(SWEEPS):
            a = m.sweep(a, seed=s)
            out.append((m.layout.extract_canonical(a["z"].numpy()),
                        *m.global_counts(a)))
        for k in before:
            assert torch.equal(a0[k], before[k]), k
        assert m.log_likelihood(a) > m.log_likelihood(a0)
        return out

    runs = [chain("ragged", "pipelined"), chain("ragged", "barrier"),
            chain("dense", "pipelined"), chain("dense", "barrier")]
    for run in runs[1:]:
        for got, want in zip(run, runs[0]):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_vectorized_refuses_sparse_r_mode():
    corpus, _, _ = synthetic.make_corpus(**CORPUS)
    lay = sharding.build_layout(corpus, n_workers=2, T=T, layout="ragged")
    with pytest.raises(ValueError, match="sparse"):
        NomadLDA(layout=lay, alpha=ALPHA, beta=BETA, device="cpu",
                 inner_mode="vectorized", r_mode="sparse")


def test_what_is_not_ported_raises():
    corpus, _, _ = synthetic.make_corpus(**CORPUS)
    lay = sharding.build_layout(corpus, n_workers=2, T=T, layout="ragged")
    for kw in (dict(collect_lag=True),):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            NomadLDA(layout=lay, alpha=ALPHA, beta=BETA, device="cpu", **kw)
    model = NomadLDA(layout=lay, alpha=ALPHA, beta=BETA, device="cpu")
    for call in (model.run, model.export_chain_state,
                 model.restore_chain_state, model.save_checkpoint,
                 model.load_checkpoint):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call(3)
    with pytest.raises(ValueError):
        NomadLDA(layout=lay, alpha=ALPHA, beta=BETA, device="cpu",
                 r_cap=T + 1)
    grouped = sharding.build_layout(corpus, n_workers=2, T=T, doc_tile=4)
    for layout, dt in ((lay, 4), (grouped, 3)):
        with pytest.raises(ValueError, match="doc_tile"):
            NomadLDA(layout=layout, alpha=ALPHA, beta=BETA, device="cpu",
                     doc_tile=dt)


def test_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    corpus, _, _ = synthetic.make_corpus(**CORPUS)
    lay = sharding.build_layout(corpus, n_workers=2, T=T, layout="ragged")
    with pytest.raises(RuntimeError, match="CUDA"):
        NomadLDA(layout=lay, alpha=ALPHA, beta=BETA)
