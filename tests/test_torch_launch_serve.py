"""The port's launch twins of the serving side of the lifecycle, at a tiny
size on the CPU: ``chaos_check`` (the kill + damage → fallback matrix and
the serving flood with bad publishes, shedding and fetch retries) and
``serve_check`` (a trainer publishing through ``NomadLDA.run`` while the
main thread queries: no torn read, every answer equal to the serial
fold-in and to the other inner mode's)."""
import json

from repro_torch.launch import chaos_check, serve_check


def _report(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_chaos_matrix_falls_back_and_stays_exact(capsys):
    chaos_check.main(["--device", "cpu", "--phase", "matrix", "--workers",
                      "2", "--sweeps", "3", "--kill-at", "2", "--keep", "2"])
    report = _report(capsys)
    assert report["all_ok"]
    assert [c["damage"] for c in report["combos"]] == ["none", "corrupt",
                                                       "truncate"]
    assert [c["fell_back"] for c in report["combos"]] == [False, True, True]


def test_chaos_serve_refuses_bad_publishes_and_sheds(capsys):
    chaos_check.main(["--device", "cpu", "--phase", "serve", "--fast",
                      "--workers", "2", "--flood-threads", "4",
                      "--flood-queries", "4"])
    report = _report(capsys)
    assert report["all_ok"], report
    assert report["publishes_rejected"] == {"corrupt": 1, "stale": 1,
                                            "format": 1, "unexpected": 0}
    assert report["shed"] > 0 and report["fetch_retry_ok"]


def test_serve_check_has_no_torn_read(capsys):
    serve_check.main(["--device", "cpu", "--workers", "2", "--sweeps", "2",
                      "--publish-every", "1", "--queries", "6", "--batch",
                      "2", "--key-cycle", "2", "--pool", "6"])
    report = _report(capsys)
    assert report["all_ok"], report
    assert report["torn_reads"] == 0 and report["publishes"] == 3
    assert report["fold_in_mismatch"] == report["cross_mode_mismatch"] == 0
