"""The port's distributed-check twin (``repro_torch/launch/
lda_dist_check.py``) against ``repro/launch/lda_dist_check.py``: for
ragged fused pipelined, dense scan on a ``pods=2`` mesh and ragged scan
with ``doc_tile=3`` the reports are equal key for key (timings excepted;
the log-likelihood to the relative 5e-4 of ``test_torch_nomad.py``), and
a chain checkpoint written by either CLI resumes in the other bit for
bit.  The reference runs in subprocesses that fake W CPU devices,
started together so that they run beside the port's in-process runs.
"""
import os
import subprocess
import sys

import json
import numpy as np
import pytest

from repro_torch.launch import lda_dist_check
from repro_torch.train import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LL_RTOL = 5e-4
TIMINGS = ("tokens_per_sec", "ref_sweep_sec")
CONFIGS = {
    "ragged_fused_pipelined": ["--n-devices", "8", "--inner-mode", "fused",
                               "--layout", "ragged", "--ring-mode",
                               "pipelined"],
    "dense_scan_pods": ["--n-devices", "8", "--pods", "2", "--sync-mode",
                        "stale", "--layout", "dense"],
    "ragged_scan_doc_tile": ["--n-devices", "8", "--layout", "ragged",
                             "--doc-tile", "3"],
}


def _reference(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "repro.launch.lda_dist_check", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _report(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("dist")


@pytest.fixture(scope="module")
def reference(ckpt_dir):
    """Every reference run, started at once; the ``pods`` run also writes
    its chain checkpoint."""
    extra = {"dense_scan_pods": ["--checkpoint-path",
                                 str(ckpt_dir / "ref.npz")]}
    return {name: _reference(args + extra.get(name, []))
            for name, args in CONFIGS.items()}


def _mine(args):
    rep = lda_dist_check.run_check(lda_dist_check.parse_args(
        args + ["--device", "cpu"]))
    assert lda_dist_check.passed(rep), rep
    return rep


def _assert_same_report(mine, ref):
    assert set(mine) == set(ref)
    for k, v in ref.items():
        if k == "ll":
            np.testing.assert_allclose(mine[k], v, rtol=LL_RTOL)
        elif k not in TIMINGS:
            assert mine[k] == v, k


@pytest.mark.parametrize("name", ["ragged_fused_pipelined",
                                  "ragged_scan_doc_tile"])
def test_report_equals_reference(reference, name):
    _assert_same_report(_mine(CONFIGS[name]), _report(reference[name]))


def test_pods_report_and_checkpoints_cross_both_ways(reference, ckpt_dir):
    """``--pods 2`` runs the one-pod chain and reports ``pods``; each
    package resumes the other's checkpoint, and the two resumed chains
    write equal checkpoints."""
    args = CONFIGS["dense_scan_pods"]
    mine = _mine(args + ["--checkpoint-path", str(ckpt_dir / "port.npz")])
    ref = _report(reference["dense_scan_pods"])
    _assert_same_report(mine, ref)
    assert mine["pods"] == 2
    a, ma = checkpoint.load_chain(str(ckpt_dir / "port.npz"))
    b, mb = checkpoint.load_chain(str(ckpt_dir / "ref.npz"))
    assert ma == mb and a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # each resumes the other's file and writes its own again
    back = _reference(args + ["--resume-from", str(ckpt_dir / "port.npz"),
                              "--checkpoint-path",
                              str(ckpt_dir / "ref2.npz")])
    mine = _mine(args + ["--resume-from", str(ckpt_dir / "ref.npz"),
                         "--checkpoint-path", str(ckpt_dir / "port2.npz")])
    ref = _report(back)
    assert mine["next_seed"] == ref["next_seed"] == 14
    _assert_same_report(dict(mine, resumed_from=""),
                        dict(ref, resumed_from=""))
    a, ma = checkpoint.load_chain(str(ckpt_dir / "port2.npz"))
    b, mb = checkpoint.load_chain(str(ckpt_dir / "ref2.npz"))
    assert ma == mb
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_pods_must_divide_the_ring():
    with pytest.raises(SystemExit):
        lda_dist_check.parse_args(["--n-devices", "6", "--pods", "4"])
