"""The port's copy of the nomad layout (``repro_torch/data/sharding.py``)
against ``repro/data/sharding.py``: every field of ``build_layout``'s
``NomadLayout`` equal, byte for byte and dtype for dtype, in both
geometries, for W ∈ {1, 2, 4} and B ∈ {W, 2W, 3W}; and the helpers built
on it."""
import dataclasses

import numpy as np
import pytest

from repro.data import sharding as jsh
from repro.data import synthetic as jsyn
from repro_torch.data import sharding
from repro_torch.data import synthetic


def _corpora(seed=3):
    kw = dict(num_docs=50, vocab_size=120, num_topics=8, mean_doc_len=14.0,
              seed=seed)
    return jsyn.make_corpus(**kw)[0], synthetic.make_corpus(**kw)[0]


def _assert_same_layout(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert x.tobytes() == y.tobytes(), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("mult", [1, 2, 3])
@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_build_layout_is_byte_identical(W, mult, layout):
    cj, cp = _corpora()
    kw = dict(n_workers=W, T=16, n_blocks=W * mult, layout=layout)
    a, b = jsh.build_layout(cj, **kw), sharding.build_layout(cp, **kw)
    _assert_same_layout(a, b)
    for prop in ("k", "stream_len", "pad_fraction", "total_tiles",
                 "round_imbalance"):
        assert getattr(a, prop) == getattr(b, prop), prop
    np.testing.assert_array_equal(a.half_loads(), b.half_loads())
    for x, y in zip(a.token_coords(), b.token_coords()):
        np.testing.assert_array_equal(x, y)
    assert b.word_map_mismatches() == 0


def test_build_layout_options_are_byte_identical():
    cj, cp = _corpora(seed=4)
    for kw in (dict(n_workers=2, T=8, n_blocks=4, layout="ragged", tile=8),
               dict(n_workers=2, T=8, n_blocks=4, balance=False),
               dict(n_workers=2, T=8, n_blocks=2, doc_tile=5),
               dict(n_workers=2, T=8, n_blocks=4, layout="ragged",
                    doc_tile=4)):
        _assert_same_layout(jsh.build_layout(cj, **kw),
                            sharding.build_layout(cp, **kw))


def test_helpers_match():
    cj, cp = _corpora(seed=5)
    lay_j = jsh.build_layout(cj, n_workers=2, T=8, n_blocks=4,
                             layout="ragged")
    lay_p = sharding.build_layout(cp, n_workers=2, T=8, n_blocks=4,
                                  layout="ragged")
    z = np.random.default_rng(0).integers(0, 8, lay_p.tok_doc.shape)
    for x, y in zip(jsh.counts_from_layout(lay_j, z, 8),
                    sharding.counts_from_layout(lay_p, z, 8)):
        np.testing.assert_array_equal(x, y)
    w = np.random.default_rng(1).integers(1, 1000, 300)
    np.testing.assert_array_equal(jsh.lpt_assign(w, 7),
                                  sharding.lpt_assign(w, 7))
    assert [jsh.half_queue_split(k) for k in range(6)] == \
        [sharding.half_queue_split(k) for k in range(6)]
    sizes = np.array([[5, 0, 90], [300, 17, 2]])
    assert jsh.default_ragged_tile(sizes) == \
        sharding.default_ragged_tile(sizes)
    assert sharding.N_BLK == 256
