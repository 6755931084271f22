"""The port's exactness-matrix twin (``repro_torch/launch/
lda_matrix_check.py``): its smoke subset is ``all_exact`` on the CPU, and
its full enumeration runs the reference's 420 combinations in the
reference's order with the reference's keys and values (without sweeps,
which the reference's paged kernels cannot run on the installed jax; the
chains themselves are held to the reference in ``test_torch_nomad.py``).
The full matrix runs on the card in ``test_torch_gpu.py``.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import lda_matrix_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reference_enumeration():
    """The reference's ``lda_matrix_check 4 0 full`` report, started at
    once so that it runs beside the port's."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "repro.launch.lda_matrix_check", "4", "0",
         "full"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)


def test_smoke_subset_is_all_exact_on_the_cpu(reference_enumeration):
    rep = lda_matrix_check.run_matrix(4, 1, "smoke", device="cpu")
    assert rep["all_exact"], rep
    assert len(rep["combos"]) == 6
    assert all(c["inner_mode"] == "fused" and c["B"] == 8
               for c in rep["combos"])
    assert sum(c["paged"] for c in rep["combos"]) == 2
    assert [c.get("vs_untiled_z_mismatch") for c in rep["combos"]
            if c["paged"]] == [0, 0]
    assert [(s["layout"], s["fused_smem_bytes"]) for s in rep["slab_smem"]
            ] == [("dense", None), ("ragged", None)]


def test_full_enumeration_is_the_reference_s(reference_enumeration):
    out, err = reference_enumeration.communicate(timeout=600)
    assert reference_enumeration.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    mine = lda_matrix_check.run_matrix(4, 0, "full", device="cpu")
    assert len(mine["combos"]) == len(ref["combos"]) == 420
    assert mine["combos"] == ref["combos"]
    assert mine["all_exact"] and ref["all_exact"]
    strip = lambda rows, key: [{k: v for k, v in s.items() if k != key}
                               for s in rows]
    assert strip(mine["slab_smem"], "fused_smem_bytes") == strip(
        ref["slab_vmem"], "fused_vmem_bytes")


def test_cli_exits_on_the_report(capsys):
    assert lda_matrix_check.main(["2", "1", "smoke", "--device",
                                  "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["all_exact"] and rep["n_devices"] == 2
    with pytest.raises(SystemExit):
        lda_matrix_check.main(["2", "1", "most"])
