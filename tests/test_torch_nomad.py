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
to an npz; that covers the sync × ring × r-mode grid.
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
# (W, B, sync, ring, r_mode, r_cap from the layout, JAX inner mode)
COMBOS = [
    (2, 4, "stoken", "pipelined", "dense", False, "fused"),
    (2, 2, "stale", "barrier", "sparse", True, "scan"),
    (2, 6, "allreduce", "pipelined", "sparse", False, "scan"),
    (4, 8, "stoken", "pipelined", "dense", False, "scan"),
    (4, 8, "stoken", "barrier", "sparse", True, "scan"),
    (4, 12, "allreduce", "barrier", "dense", False, "scan"),
    (4, 8, "stale", "pipelined", "dense", False, "scan"),
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
for i, (W, B, sync, ring, r_mode, cap, inner) in enumerate(spec["combos"]):
    lay = build_layout(corpus, n_workers=W, T=spec["T"], n_blocks=B,
                       layout="ragged")
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
                combos=COMBOS)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REFERENCE,
                          json.dumps(spec), str(path)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(path))


def _port(W, B, sync, ring, r_mode, cap, inner_mode="fused"):
    corpus, _, _ = synthetic.make_corpus(**CORPUS)
    lay = sharding.build_layout(corpus, n_workers=W, T=T, n_blocks=B,
                                layout="ragged")
    return NomadLDA(layout=lay, alpha=ALPHA, beta=BETA, sync_mode=sync,
                    ring_mode=ring, r_mode=r_mode,
                    r_cap=lay.r_cap if cap else 0, inner_mode=inner_mode,
                    device="cpu")


@pytest.mark.parametrize("i", range(len(COMBOS)))
def test_ring_matches_reference_on_fake_devices(reference, i):
    W, B, sync, ring, r_mode, cap, _ = COMBOS[i]
    model = _port(W, B, sync, ring, r_mode, cap)
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
    corpus, _, _ = jsyn.make_corpus(**CORPUS)
    lay_j = jsh.build_layout(corpus, n_workers=1, T=T, n_blocks=3,
                             layout="ragged")
    mesh = jax.make_mesh((1,), ("worker",), devices=jax.devices()[:1])
    jm = JNomad(mesh=mesh, ring_axes=("worker",), layout=lay_j, alpha=ALPHA,
                beta=BETA, sync_mode=sync, ring_mode=ring, r_mode=r_mode)
    pm = _port(1, 3, sync, ring, r_mode, False, inner_mode="scan")
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


def test_what_is_not_ported_raises():
    corpus, _, _ = synthetic.make_corpus(**CORPUS)
    dense = sharding.build_layout(corpus, n_workers=2, T=T)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NomadLDA(layout=dense, alpha=ALPHA, beta=BETA, device="cpu")
    lay = sharding.build_layout(corpus, n_workers=2, T=T, layout="ragged")
    for kw in (dict(inner_mode="vectorized"), dict(doc_tile=4),
               dict(collect_lag=True)):
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


def test_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    corpus, _, _ = synthetic.make_corpus(**CORPUS)
    lay = sharding.build_layout(corpus, n_workers=2, T=T, layout="ragged")
    with pytest.raises(RuntimeError, match="CUDA"):
        NomadLDA(layout=lay, alpha=ALPHA, beta=BETA)
