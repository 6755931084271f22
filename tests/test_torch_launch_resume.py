"""The port's launch twins of the trainer's lifecycle, at a tiny size on
the CPU: ``resume_check`` (the in-process matrix, and a real process
killed with ``os._exit`` after its checkpoint, then resumed to the
straight run's digest), ``stoken_lag_check`` (its vectorised
``lag_report`` against a loop over the reference's own schedule) and
``train lda``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.core.nomad import NomadLDA
from repro_torch.data import synthetic
from repro_torch.data.sharding import build_layout
from repro_torch.launch import resume_check, stoken_lag_check, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _report(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_resume_matrix_is_exact(capsys):
    resume_check.main(["--device", "cpu", "--workers", "2", "--n-blocks",
                       "4", "--sweeps", "2", "--checkpoint-at", "1"])
    report = _report(capsys)
    assert report["all_exact"] and len(report["combos"]) == 8


def test_killed_process_resumes_to_the_straight_digest(tmp_path):
    ckpt = str(tmp_path / "chain.npz")
    common = ["--device", "cpu", "--workers", "2", "--layout", "ragged",
              "--ring-mode", "pipelined", "--r-mode", "sparse",
              "--n-blocks", "4", "--sweeps", "3", "--checkpoint-at", "2",
              "--ckpt", ckpt]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))

    def phase(name, *extra):
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.resume_check",
             "--phase", name, *common, *extra],
            capture_output=True, text=True, env=env, timeout=300)
        return res.returncode, res.stdout.strip().splitlines()[-1]

    rc, line = phase("train", "--kill")
    assert rc == 137 and json.loads(line)["phase"] == "train"
    assert os.path.exists(ckpt)
    rc, straight = phase("straight")
    assert rc == 0
    rc, resumed = phase("resume")
    assert rc == 0
    assert json.loads(resumed)["digest"] == json.loads(straight)["digest"]


def _lag_report_loop(lag, n_t0, cell_sizes, k):
    """The reference's checks (``repro/launch/stoken_lag_check.py``) as
    its loops, the yardstick of the vectorised :func:`lag_report`."""
    diag = lag.astype(np.int64)
    W = diag.shape[1]
    local, delta = diag[:, :, 0], diag[:, :, 1]
    exact = n_t0[None] + delta.sum(axis=1)

    def round_tokens(w, rho):
        c = (w + rho) % W
        return int(cell_sizes[w, c * k:(c + 1) * k].sum())

    out = dict(fold_schedule_exact=True, lag_within_bound=True,
               lag_nonzero=False, lag_max_l1=0, bound_max_l1=0,
               fold_window_rounds_max=0, window_rounds_max=0)
    for r in range(W):
        for w in range(W):
            r_h0 = (-w) % W
            held = r >= r_h0
            r_h = r_h0 + ((r - r_h0) // W) * W if held else None
            expected = n_t0 + delta[r, w]
            missing = 0
            for w2 in range(W):
                if w2 == w:
                    continue
                rho = (r_h - (w2 - w) % W) if held else -1
                if rho >= 0:
                    expected = expected + delta[rho, w2]
                lo = max(rho + 1, 0)
                window = r - lo + 1
                out["window_rounds_max"] = max(out["window_rounds_max"],
                                               window)
                if held and r == r_h:
                    out["fold_window_rounds_max"] = max(
                        out["fold_window_rounds_max"], window)
                missing += sum(round_tokens(w2, x) for x in range(lo, r + 1))
            if (local[r, w] != expected).any():
                out["fold_schedule_exact"] = False
            lag_l1 = int(np.abs(local[r, w] - exact[r]).sum())
            out["lag_max_l1"] = max(out["lag_max_l1"], lag_l1)
            out["bound_max_l1"] = max(out["bound_max_l1"], 2 * missing)
            out["lag_nonzero"] |= lag_l1 > 0
            if lag_l1 > 2 * missing:
                out["lag_within_bound"] = False
    return out


@pytest.mark.parametrize("W,B,tamper", [(3, 6, False), (4, 8, False),
                                        (4, 8, True)])
def test_lag_report_equals_the_reference_loops(W, B, tamper):
    corpus, _, _ = synthetic.make_corpus(num_docs=30, vocab_size=60,
                                         num_topics=4, mean_doc_len=12.0,
                                         seed=2)
    lay = build_layout(corpus, n_workers=W, T=8, n_blocks=B, layout="ragged")
    model = NomadLDA(layout=lay, alpha=50.0 / 8, beta=0.01,
                     inner_mode="vectorized", collect_lag=True, device="cpu")
    a0 = model.init_arrays(seed=1)
    lag = model.sweep(a0, seed=0)["lag"].numpy()
    if tamper:                          # a copy one fold out of step
        lag = lag.copy()
        lag[2, 1, 0, 3] += 5
    n_t0 = a0["n_t"].numpy().astype(np.int64)
    got = stoken_lag_check.lag_report(lag, n_t0, lay.cell_sizes, lay.k)
    want = _lag_report_loop(lag, n_t0, lay.cell_sizes, lay.k)
    assert {k: got[k] for k in want} == want
    assert got["fold_schedule_exact"] is not tamper


def test_stoken_lag_check_passes(capsys):
    stoken_lag_check.main(["--device", "cpu", "--workers", "4",
                           "--inner-mode", "vectorized"])
    report = _report(capsys)
    assert report["all_ok"] and report["k"] == 2


def test_train_lda_saves_the_reference_store(tmp_path, capsys):
    ckpt = str(tmp_path / "lda.npz")
    train.main(["lda", "--workers", "2", "--sweeps", "2", "--topics", "8",
                "--docs", "20", "--device", "cpu", "--ckpt", ckpt])
    assert "checkpoint:" in capsys.readouterr().out
    with np.load(ckpt) as data:
        assert sorted(data.files) == ["n_t", "n_td", "n_wt", "z"]
        assert (int(data["n_t"].sum()) == int(data["n_td"].sum())
                == int(data["n_wt"].sum()) > 0)
    with pytest.raises(SystemExit, match="pod"):
        train.main(["lda", "--multi-pod", "--device", "cpu"])
