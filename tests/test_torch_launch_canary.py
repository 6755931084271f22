"""The port's padding canary (``repro_torch/launch/lda_canary_check.py``)
on the CPU at ``n = 2, reps = 1``: the reference's report keys
(``repro/launch/lda_canary_check.py``), its corpus, and positive, finite
rates whose ratio is the report's."""
import json
import math

from repro_torch.launch import lda_canary_check

REFERENCE_KEYS = ["n_devices", "reps", "n_tokens", "tokens_per_sec_w",
                  "tokens_per_sec_4w", "ratio_4w_over_w"]


def test_canary_reports_the_reference_keys_on_the_cpu(capsys):
    assert lda_canary_check.main(["2", "1", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(rep) == REFERENCE_KEYS
    assert (rep["n_devices"], rep["reps"]) == (2, 1)
    # the reference's corpus: 120 documents of mean length 30, seed 3
    from repro.data import synthetic
    corpus, _, _ = synthetic.make_corpus(num_docs=120, vocab_size=256,
                                         num_topics=16, mean_doc_len=30.0,
                                         seed=3)
    assert rep["n_tokens"] == corpus.num_tokens
    for key in REFERENCE_KEYS[3:]:
        assert math.isfinite(rep[key]) and rep[key] > 0
    assert math.isclose(rep["ratio_4w_over_w"],
                        rep["tokens_per_sec_4w"] / rep["tokens_per_sec_w"])


def test_canary_arguments_default_as_the_reference():
    args = lda_canary_check.parse_args([])
    assert (args.n_workers, args.reps, args.device) == (4, 8, None)
