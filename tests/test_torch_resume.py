"""The port's chain checkpoint, resume and ``run`` loop
(``repro_torch/core/nomad.py``), in process on the CPU: a run straight to
n sweeps equals a run to k, a checkpoint and a resume to n, bit for bit,
on every layout × ring mode × r-mode with the ``scan`` and ``fused``
inner modes (``fused`` runs its plain version here) and ``vectorized`` in
dense r-mode, through a ``.npz`` file and a rotation directory, and from
a dense-grid checkpoint onto the ragged layout.  Restore refuses a
checkpoint whose chain-affecting knobs differ, one not at a sweep
boundary and one whose ``n_wt`` fails its digest; a killed run whose
newest slot is corrupt falls back to the previous slot and still
finishes bit-equal; publishing and ``collect_lag`` leave the chain
alone."""
import numpy as np
import pytest
import torch

from repro_torch.core.nomad import NomadLDA
from repro_torch.data import synthetic
from repro_torch.data.sharding import build_layout
from repro_torch.fault import FaultPlan, FaultSpec, InjectedKill
from repro_torch.train.checkpoint import CheckpointRotation

T, N, K = 8, 2, 1
CORPUS = dict(num_docs=24, vocab_size=48, num_topics=4, mean_doc_len=10.0,
              seed=11)


def _model(kind="ragged", ring="pipelined", r_mode="dense", inner="fused",
           **kw):
    corpus, _, _ = synthetic.make_corpus(**CORPUS)
    lay = build_layout(corpus, n_workers=2, T=T, n_blocks=4, layout=kind)
    return NomadLDA(layout=lay, alpha=50.0 / T, beta=0.01,
                    sync_mode="stoken", ring_mode=ring, r_mode=r_mode,
                    r_cap=lay.r_cap if r_mode == "sparse" else 0,
                    inner_mode=inner, device="cpu", **kw)


def _canonical(model, arrays) -> list:
    """The chain in layout-free terms: canonical ``z``, the global counts
    and the side tables."""
    out = [model.layout.extract_canonical(arrays["z"].numpy()),
           *model.global_counts(arrays)]
    if model.r_mode == "sparse":
        out += [arrays["rb_topics"].numpy(), arrays["rb_counts"].numpy()]
    return out


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].device == b[k].device, k
        assert torch.equal(a[k], b[k]), k


COMBOS = [(kind, ring, r_mode, inner)
          for kind in ("dense", "ragged")
          for ring in ("barrier", "pipelined")
          for r_mode in ("dense", "sparse")
          for inner in ("scan", "fused")]
COMBOS += [(kind, ring, "dense", "vectorized")
           for kind in ("dense", "ragged") for ring in ("barrier", "pipelined")]


@pytest.mark.parametrize("kind,ring,r_mode,inner", COMBOS)
def test_resumed_chain_equals_straight(tmp_path, kind, ring, r_mode, inner):
    combo = dict(kind=kind, ring=ring, r_mode=r_mode, inner=inner)
    straight, done = _model(**combo).run(N, init_seed=2)
    assert done == N
    rot = str(tmp_path / "rot")
    trainer = _model(**combo, checkpoint_every=K, checkpoint_path=rot)
    at_k, _ = trainer.run(K, init_seed=2)
    npz = trainer.save_checkpoint(str(tmp_path / "chain.npz"), at_k,
                                  next_seed=K)
    assert [s for s, _ in CheckpointRotation(rot).slots()] == [K]
    for path in (rot, npz):
        resumed, done = _model(**combo, resume_from=path).run(N)
        assert done == N
        _assert_same(resumed, straight)


@pytest.mark.parametrize("r_mode", ["dense", "sparse"])
def test_dense_grid_checkpoint_resumes_on_the_ragged_layout(tmp_path, r_mode):
    path = str(tmp_path / "dense.npz")
    _model("dense", r_mode=r_mode, checkpoint_every=K,
           checkpoint_path=path).run(K, init_seed=4)
    ragged = _model("ragged", r_mode=r_mode, resume_from=path)
    resumed, _ = ragged.run(N)
    straight, _ = _model("ragged", r_mode=r_mode).run(N, init_seed=4)
    _assert_same(resumed, straight)
    dense, _ = _model("dense", r_mode=r_mode).run(N, init_seed=4)
    for got, want in zip(_canonical(ragged, resumed),
                         _canonical(_model("dense", r_mode=r_mode), dense)):
        np.testing.assert_array_equal(got, want)


def test_restore_is_the_inverse_of_init_and_export():
    model = _model(r_mode="sparse")
    a0 = model.init_arrays(seed=1)
    state, meta = model.export_chain_state(a0, next_seed=0)
    assert {k: v.dtype for k, v in state.items()} == {
        k: np.dtype(np.int32) for k in ("z_canon", "n_td", "n_wt", "n_t",
                                        "rb_topics", "rb_counts")}
    back, start = model.restore_chain_state(state, meta)
    assert start == 0
    _assert_same(back, a0)


@pytest.mark.parametrize("key", ["T", "alpha", "beta", "sync_mode", "r_mode",
                                 "r_cap", "rng_stride", "n_tokens", "W", "B",
                                 "doc_tile", "num_docs", "num_words"])
def test_restore_refuses_a_knob_that_forks_the_chain(key):
    model = _model()
    state, meta = model.export_chain_state(model.init_arrays(), next_seed=2)
    value = meta[key]
    meta[key] = value + 1 if not isinstance(value, str) else value + "x"
    with pytest.raises(ValueError, match=f"mismatch on '{key}'"):
        model.restore_chain_state(state, meta)


def test_restore_refuses_mid_sweep_and_bad_digest_and_table_shape():
    model = _model()
    state, meta = model.export_chain_state(model.init_arrays(), next_seed=2)
    for k in ("ring_round", "half_pos"):
        with pytest.raises(ValueError, match="sweep boundary"):
            model.restore_chain_state(state, dict(meta, **{k: 1}))
    bad = dict(state, n_wt=state["n_wt"].copy())
    bad["n_wt"][0, 0] += 1
    with pytest.raises(ValueError, match="digest"):
        model.restore_chain_state(bad, meta)
    meta_kind = dict(meta, layout_kind="dense")      # written, not compared
    model.restore_chain_state(state, meta_kind)
    sparse = _model(r_mode="sparse")
    state, meta = sparse.export_chain_state(sparse.init_arrays(),
                                            next_seed=0)
    state["rb_topics"] = state["rb_topics"][:, :-1]
    with pytest.raises(ValueError, match="rb_topics shape"):
        sparse.restore_chain_state(state, meta)


def test_kill_corrupt_fallback_resumes_bit_exact(tmp_path):
    sweeps, kill_at = 4, 3
    straight, _ = _model().run(sweeps, init_seed=0)
    rot = str(tmp_path / "rot")
    plan = FaultPlan([
        FaultSpec("corrupt", "chain.write", at=kill_at - 1, nbytes=4),
        FaultSpec("kill", "trainer.sweep", at=kill_at - 1),
    ], seed=7)
    trainer = _model(checkpoint_every=1, checkpoint_path=rot,
                     checkpoint_keep=2)
    with pytest.raises(InjectedKill):
        trainer.run(sweeps, init_seed=0, fault_plan=plan)
    assert [e[2] for e in plan.log] == ["corrupt", "kill"]
    rotation = CheckpointRotation(rot, keep=2)
    assert [s for s, _ in rotation.slots()] == [kill_at - 1, kill_at]
    assert rotation.last_good() == kill_at
    _, _, step = rotation.load_latest_valid()
    assert step == kill_at - 1               # fell back past the damage
    resumed, done = _model(resume_from=rot).run(sweeps)
    assert done == sweeps
    _assert_same(resumed, straight)


def test_publish_drops_and_never_touches_the_chain():
    published = []
    plan = FaultPlan([FaultSpec("drop", "trainer.publish", at=1)])
    arrays, _ = _model().run(
        3, init_seed=0, publish_every=1, fault_plan=plan,
        on_publish=lambda snap: published.append(snap.meta["sweep"]))
    assert published == [1, 3]               # sweep 2's publish dropped
    straight, _ = _model().run(3, init_seed=0)
    _assert_same(arrays, straight)
    every_two = []
    _model().run(4, publish_every=2, on_publish=every_two.append)
    assert [s.meta["sweep"] for s in every_two] == [2, 4]


def test_run_and_fields_refuse_what_they_cannot_do():
    with pytest.raises(ValueError, match="checkpoint_every"):
        _model(checkpoint_every=0, checkpoint_path="x")
    with pytest.raises(ValueError, match="checkpoint_path"):
        _model(checkpoint_every=1)
    with pytest.raises(ValueError, match="publish_every"):
        _model().run(1, publish_every=0, on_publish=print)
    with pytest.raises(ValueError, match="on_publish"):
        _model().run(1, publish_every=1)


@pytest.mark.parametrize("inner", ["scan", "fused", "vectorized"])
def test_collect_lag_leaves_the_chain_alone(inner):
    plain = _model(inner=inner)
    lagged = _model(inner=inner, collect_lag=True)
    a0 = plain.init_arrays(seed=3)
    a, b = plain.sweep(a0, seed=0), lagged.sweep(a0, seed=0)
    lag = b.pop("lag")
    _assert_same(a, b)
    W = plain.layout.W
    assert lag.shape == (W, W, 2, T) and lag.dtype == torch.int32
    # the last round's deltas add up to the sweep's change of n_t
    assert torch.equal(lag[-1, :, 1].sum(0), a["n_t"] - a0["n_t"])
