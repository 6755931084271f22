"""The port's chain checkpoints against the JAX ``NomadLDA`` across
packages.  One subprocess fakes four CPU devices (as
``tests/test_torch_nomad.py`` does) and, for each combination, runs the
reference straight to ``N`` sweeps, writes a reference checkpoint at
sweep ``K`` and resumes from a checkpoint the port wrote before the
subprocess started; it also records ``nomad_sweep_fn(collect_lag=True)``'s
lag trace for both ring modes × both layouts.  The reference runs
``scan`` or ``fused`` unpaged (its paged kernels do not trace on the
installed jax).  Here the port must resume the reference's checkpoint to
the reference's straight arrays and ``chain_digest``, the reference must
resume the port's to the same, the port's exported meta must equal the
reference's key for key (``ftree_digest`` included), and the port's lag
trace must equal the reference's bit for bit."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.core.nomad import NomadLDA
from repro_torch.data import synthetic
from repro_torch.data.sharding import build_layout
from repro_torch.launch.resume_check import chain_digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, ALPHA, BETA, N, K = 16, 50.0 / 16, 0.01, 3, 1
CORPUS = dict(num_docs=40, vocab_size=80, num_topics=8, mean_doc_len=12.0,
              seed=2)
# (W, B, sync, ring, r_mode, r_cap from the layout, JAX inner mode,
#  layout kind, store: a ".npz" file or a rotation directory)
COMBOS = [
    (4, 8, "stoken", "pipelined", "sparse", True, "scan", "ragged", "npz"),
    (2, 4, "allreduce", "barrier", "dense", False, "fused", "dense", "rot"),
    (4, 4, "stale", "barrier", "dense", False, "scan", "dense", "npz"),
]
LAG = dict(W=4, B=8)
FIELDS = ("z", "n_td", "n_wt", "n_t", "rb_topics", "rb_counts")

# Runs in a fresh interpreter: the device count must be set before jax
# is imported.
_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import jax.numpy as jnp
import numpy as np
from repro.core.nomad import NomadLDA, nomad_sweep_fn
from repro.data import synthetic
from repro.data.sharding import build_layout
from repro.launch.resume_check import chain_digest
spec, d = json.loads(sys.argv[1]), sys.argv[2]
T, N, K = spec["T"], spec["N"], spec["K"]
corpus, _, _ = synthetic.make_corpus(**spec["corpus"])
out = {}
for i, (W, B, sync, ring, r_mode, cap, inner, kind, store) in enumerate(
        spec["combos"]):
    lay = build_layout(corpus, n_workers=W, T=T, n_blocks=B, layout=kind)
    mesh = jax.make_mesh((W,), ("worker",), devices=jax.devices()[:W])
    m = NomadLDA(mesh=mesh, ring_axes=("worker",), layout=lay,
                 alpha=spec["alpha"], beta=spec["beta"], sync_mode=sync,
                 inner_mode=inner, ring_mode=ring, r_mode=r_mode,
                 r_cap=lay.r_cap if cap else 0)
    ext = ".npz" if store == "npz" else ""
    a, _ = m.run(N, init_seed=i)
    for k in spec["fields"]:
        if k in a:
            out[f"{i}/straight/{k}"] = np.asarray(a[k])
    out[f"{i}/digest"] = np.array(chain_digest(m, a))
    out[f"{i}/meta"] = np.array(json.dumps(
        m.export_chain_state(a, next_seed=N)[1]))
    m.checkpoint_every, m.checkpoint_path = K, os.path.join(d, f"ref{i}{ext}")
    m.run(K, init_seed=i)
    m.checkpoint_every, m.checkpoint_path = None, None
    m.resume_from = os.path.join(d, f"port{i}{ext}")
    a, _ = m.run(N)
    for k in spec["fields"]:
        if k in a:
            out[f"{i}/resumed/{k}"] = np.asarray(a[k])
    out[f"{i}/resumed_digest"] = np.array(chain_digest(m, a))
W, B = spec["lag"]["W"], spec["lag"]["B"]
mesh = jax.make_mesh((W,), ("worker",), devices=jax.devices()[:W])
for kind in ("dense", "ragged"):
    lay = build_layout(corpus, n_workers=W, T=T, n_blocks=B, layout=kind)
    m = NomadLDA(mesh=mesh, ring_axes=("worker",), layout=lay,
                 alpha=spec["alpha"], beta=spec["beta"])
    a = m.init_arrays(seed=0)
    for ring in ("barrier", "pipelined"):
        sweep = nomad_sweep_fn(
            mesh, ("worker",), B=lay.B, T=T, alpha=spec["alpha"],
            beta=spec["beta"], beta_bar=m.beta_bar, sync_mode="stoken",
            inner_mode="scan", ring_mode=ring, collect_lag=True,
            layout_kind=kind, tile=lay.tile, n_tiles=lay.n_tiles,
            tile_split=lay.tile_split, rng_stride=lay.L)
        args = (a["tok_doc"], a["tok_wrd"], a["tok_valid"], a["tok_bound"],
                a["z"], a["n_td"], a["n_wt"], a["n_t"], jnp.int32(0))
        if kind == "ragged":
            args += (a["cell_of_tile"], a["tok_slot"])
        out[f"lag/{kind}/{ring}"] = np.asarray(sweep(*args)[-1])
np.savez(os.path.join(d, "reference.npz"), **out)
"""


def _port(i, **kw):
    W, B, sync, ring, r_mode, cap, _, kind, _ = COMBOS[i]
    corpus, _, _ = synthetic.make_corpus(**CORPUS)
    lay = build_layout(corpus, n_workers=W, T=T, n_blocks=B, layout=kind)
    return NomadLDA(layout=lay, alpha=ALPHA, beta=BETA, sync_mode=sync,
                    ring_mode=ring, r_mode=r_mode,
                    r_cap=lay.r_cap if cap else 0, inner_mode="fused",
                    device="cpu", **kw)


def _path(d, name, i):
    return os.path.join(d, f"{name}{i}" + (".npz" if COMBOS[i][-1] == "npz"
                                           else ""))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("resume"))
    for i in range(len(COMBOS)):                   # the port's checkpoints
        _port(i, checkpoint_every=K,
              checkpoint_path=_path(d, "port", i)).run(K, init_seed=i)
    spec = dict(corpus=CORPUS, T=T, N=N, K=K, alpha=ALPHA, beta=BETA,
                combos=COMBOS, fields=FIELDS, lag=LAG)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REFERENCE,
                          json.dumps(spec), d],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return d, dict(np.load(os.path.join(d, "reference.npz")))


def _assert_arrays(arrays, ref, prefix):
    keys = [k for k in FIELDS if f"{prefix}/{k}" in ref]
    assert sorted(keys) == sorted(k for k in FIELDS if k in arrays)
    for k in keys:
        np.testing.assert_array_equal(arrays[k].numpy(), ref[f"{prefix}/{k}"],
                                      err_msg=f"{prefix} {k}")


@pytest.mark.parametrize("i", range(len(COMBOS)))
def test_reference_checkpoint_resumes_in_the_port(reference, i):
    d, ref = reference
    model = _port(i, resume_from=_path(d, "ref", i))
    arrays, done = model.run(N)
    assert done == N
    _assert_arrays(arrays, ref, f"{i}/straight")
    assert chain_digest(model, arrays) == str(ref[f"{i}/digest"])


@pytest.mark.parametrize("i", range(len(COMBOS)))
def test_port_checkpoint_resumes_in_the_reference(reference, i):
    _, ref = reference
    for k in FIELDS:
        if f"{i}/straight/{k}" in ref:
            np.testing.assert_array_equal(ref[f"{i}/resumed/{k}"],
                                          ref[f"{i}/straight/{k}"])
    assert str(ref[f"{i}/resumed_digest"]) == str(ref[f"{i}/digest"])


@pytest.mark.parametrize("i", range(len(COMBOS)))
def test_exported_meta_equals_the_reference(reference, i):
    _, ref = reference
    model = _port(i)
    arrays, _ = model.run(N, init_seed=i)
    _assert_arrays(arrays, ref, f"{i}/straight")
    _, meta = model.export_chain_state(arrays, next_seed=N)
    assert json.loads(json.dumps(meta)) == json.loads(str(ref[f"{i}/meta"]))


@pytest.mark.parametrize("kind", ["dense", "ragged"])
@pytest.mark.parametrize("ring", ["barrier", "pipelined"])
@pytest.mark.parametrize("inner", ["fused", "vectorized"])
def test_lag_trace_equals_the_reference(reference, kind, ring, inner):
    """The reference's scan chain is the port's fused chain, and its
    vectorized one is a different chain: the vectorized trace is only
    held to the fold schedule, through ``stoken_lag_check``."""
    _, ref = reference
    corpus, _, _ = synthetic.make_corpus(**CORPUS)
    lay = build_layout(corpus, n_workers=LAG["W"], T=T, n_blocks=LAG["B"],
                       layout=kind)
    model = NomadLDA(layout=lay, alpha=ALPHA, beta=BETA, ring_mode=ring,
                     inner_mode=inner, collect_lag=True, device="cpu")
    a0 = model.init_arrays(seed=0)
    lag = model.sweep(a0, seed=0)["lag"].numpy()
    want = ref[f"lag/{kind}/{ring}"]
    assert lag.shape == want.shape and lag.dtype == want.dtype == np.int32
    if inner == "fused":
        np.testing.assert_array_equal(lag, want)
    else:
        from repro_torch.launch.stoken_lag_check import lag_report
        report = lag_report(lag, a0["n_t"].numpy(), lay.cell_sizes, lay.k)
        assert report["fold_schedule_exact"] and report["lag_within_bound"]
