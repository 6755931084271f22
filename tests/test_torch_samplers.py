"""The port's Table 1 samplers (``repro_torch/core/samplers.py``) against
``repro/core/samplers.py`` under ``jit``, as the reference's Table 1
benchmark runs them (``benchmarks/sampler_bench.py``: ``init`` jitted,
draws ``vmap``-ed, updates in a ``lax.scan``): every state, draw and
update sequence equal bit for bit, at T ∈ {2, 7, 16, 100, 256, 1024},
on uniforms that include 1 − 2^-24.  No tolerance anywhere."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import samplers as jsam
from repro_torch import convert
from repro_torch.core import samplers
from torch_baseline_cases import (ALIAS_DRAW_CASE, ROW, U_TOP,
                                  alias_draw_other, alias_draw_row,
                                  sampler_row, u_grid, update_seq)

T_GRID = [2, 7, 16, 100, 256, 1024]
NAMES = ["lsearch", "bsearch", "alias", "ftree"]
ALIAS_UPDATES = 3                  # Θ(T) rebuilds at each T


@functools.lru_cache(maxsize=None)
def _jit(name, what):
    init, draw, update = jsam.SAMPLERS[name]
    if what == "init":
        return jax.jit(init)
    if what == "draw":
        return jax.jit(lambda s, u: jax.vmap(lambda x: draw(s, x))(u))

    def many(s, ts, ds):
        return jax.lax.scan(lambda c, td: (update(c, td[0], td[1]), None),
                            s, (ts, ds))[0]
    return jax.jit(many)


def _same_state(got, want):
    assert type(got).__name__ == type(want).__name__
    for k, w in want._asdict().items():
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(w), err_msg=k)


def _pow2(T):
    return T & (T - 1) == 0


@pytest.mark.parametrize("T", T_GRID)
@pytest.mark.parametrize("name", NAMES)
def test_init_and_draws_match(name, T):
    """States and a batch of draws, for two rows (one with a zero tail)."""
    if name == "ftree" and not _pow2(T):
        p = sampler_row(0, T)
        for init in (samplers.ftree_init, jsam.ftree_init):
            with pytest.raises(ValueError, match="power of two"):
                init(torch.as_tensor(p) if init is samplers.ftree_init
                     else jnp.asarray(p))
        return
    init, draw, _ = samplers.SAMPLERS[name]
    u = u_grid(seed=T)
    for seed in (0, 1):
        p = sampler_row(seed, T)
        js = _jit(name, "init")(p)
        ps = init(torch.as_tensor(p))
        _same_state(ps, js)
        got = draw(ps, torch.as_tensor(u))
        assert got.dtype == torch.int32 and got.shape == u.shape
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(_jit(name, "draw")(js, u)))
        # a scalar draw and a 2-D batch take the same path
        assert int(draw(ps, torch.tensor(U_TOP))) == int(got[-1])
        np.testing.assert_array_equal(
            draw(ps, torch.as_tensor(u[:6].reshape(2, 3))).numpy(),
            got[:6].numpy().reshape(2, 3))


@pytest.mark.parametrize("T", T_GRID)
@pytest.mark.parametrize("name", ["lsearch", "bsearch", "ftree"])
def test_update_sequences_match(name, T):
    """40 updates in sequence (the reference's in one ``lax.scan``), then
    the state and the draws."""
    if name == "ftree" and not _pow2(T):
        return test_init_and_draws_match(name, T)
    init, draw, update = samplers.SAMPLERS[name]
    p = sampler_row(1, T)
    ts, ds = update_seq(1, T)
    js = _jit(name, "scan")(_jit(name, "init")(p), ts, ds)
    ps = init(torch.as_tensor(p))
    for t, d in zip(ts.tolist(), torch.as_tensor(ds)):
        ps = update(ps, t, d)
    _same_state(ps, js)
    u = u_grid(seed=T + 1)
    np.testing.assert_array_equal(draw(ps, torch.as_tensor(u)).numpy(),
                                  np.asarray(_jit(name, "draw")(js, u)))


@pytest.mark.parametrize("T", T_GRID)
def test_alias_rebuilds_match(T):
    """The alias update is a Θ(T) rebuild from the caller's ``p``; with
    ``t=None`` it rebuilds from ``p`` as it is; without ``p`` it
    raises."""
    p = sampler_row(3, T)
    ts, ds = update_seq(3, T, n=ALIAS_UPDATES)
    jp, pp = jnp.asarray(p), torch.as_tensor(p)
    js, ps = jsam.alias_init(jp), samplers.alias_init(pp)
    for t, d in zip(ts.tolist(), ds.tolist()):
        js = jsam.alias_update(js, t, np.float32(d), p=jp)
        ps = samplers.alias_update(ps, t, d, p=pp)
        _same_state(ps, js)
        jp, pp = jp.at[t].add(np.float32(d)), pp.clone()
        pp[t] += np.float32(d)
    _same_state(samplers.alias_update(ps, None, 0.0, p=pp),
                jsam.alias_update(js, None, 0.0, p=jp))
    with pytest.raises(ValueError, match="full parameter vector"):
        samplers.alias_update(ps, 0, 1.0)


def test_alias_draw_rounds_the_product_before_the_subtraction():
    """``u01·T − j`` is not contracted: at T = 7 a fused multiply-add
    there draws another topic than the reference."""
    case = ALIAS_DRAW_CASE
    p = alias_draw_row(case)
    u = np.array([case["u01"]], np.float32)
    ref = int(_jit("alias", "draw")(_jit("alias", "init")(p), u)[0])
    got = int(samplers.alias_draw(samplers.alias_init(torch.as_tensor(p)),
                                  torch.as_tensor(u))[0])
    assert ref == got == case["want"]
    assert alias_draw_other(case) == case["fma_gives"] != case["want"]


def test_alias_point_mass_and_zero_row():
    """A point mass draws only its topic; an all-zero row takes the
    reference's all-ones table."""
    u = u_grid()
    for p in (np.array([0, 0, 5, 0], np.float32), np.zeros(8, np.float32)):
        js, ps = _jit("alias", "init")(p), samplers.alias_init(
            torch.as_tensor(p))
        _same_state(ps, js)
        np.testing.assert_array_equal(
            samplers.alias_draw(ps, torch.as_tensor(u)).numpy(),
            np.asarray(_jit("alias", "draw")(js, u)))
    assert (samplers.alias_draw(samplers.alias_init(torch.tensor(
        [0.0, 0.0, 5.0, 0.0])), torch.as_tensor(u)) == 2).all()


def test_lsearch_drifted_normalizer_is_guarded():
    """Twin of ``test_lsearch_guarded_boundary_drift``: a normalizer past
    the cumsum's total keeps the draw on a positive-mass topic, as the
    reference's."""
    p = ROW.astype(np.float32)
    c_T = np.float32(float(np.asarray(jnp.cumsum(jnp.asarray(p)))[-1])
                     * (1 + 1e-6))
    js = jsam.LSearchState(p=jnp.asarray(p), c_T=jnp.float32(c_T))
    ps = samplers.LSearchState(p=torch.as_tensor(p),
                               c_T=torch.tensor(c_T))
    got = int(samplers.lsearch_draw(ps, torch.tensor(U_TOP)))
    assert got == int(jsam.lsearch_draw(js, jnp.float32(U_TOP)))
    assert p[got] > 0


@settings(max_examples=20, deadline=None)
@given(T_log=st.integers(1, 7), seed=st.integers(0, 1000))
def test_every_sampler_matches_on_sparse_rows(T_log, seed):
    """The reference's property test's rows (half the topics zero): each
    sampler's draws equal the reference's, in range, and the exact ones
    on positive mass."""
    T = 1 << T_log
    r = np.random.default_rng(seed)
    p = r.random(T).astype(np.float32)
    p[r.random(T) < 0.5] = 0.0
    p[r.integers(T)] += 0.5
    u = np.concatenate([r.random(32), [0.0, U_TOP]]).astype(np.float32)
    for name, (init, draw, _) in samplers.SAMPLERS.items():
        z = draw(init(torch.as_tensor(p)), torch.as_tensor(u)).numpy()
        np.testing.assert_array_equal(
            z, np.asarray(_jit(name, "draw")(_jit(name, "init")(p), u)))
        assert ((z >= 0) & (z < T)).all(), name
        if name != "alias":
            assert (p[z] > 0).all(), name


@pytest.mark.parametrize("name", NAMES)
def test_states_cross_packages(name):
    """``convert`` carries a reference state into the port and back; the
    port then draws what the reference draws."""
    p = sampler_row(5, 64)
    js = _jit(name, "init")(p)
    fields = {k: np.asarray(v) for k, v in js._asdict().items()}
    ps = convert.sampler_state_from_reference(name, fields, device="cpu")
    _same_state(ps, js)
    back = convert.sampler_state_to_reference(ps)
    assert back.keys() == fields.keys()
    for k in fields:
        np.testing.assert_array_equal(back[k], fields[k])
        assert back[k].dtype == fields[k].dtype
    u = u_grid(seed=5)
    np.testing.assert_array_equal(
        samplers.SAMPLERS[name][1](ps, torch.as_tensor(u)).numpy(),
        np.asarray(_jit(name, "draw")(
            type(js)(**{k: jnp.asarray(v) for k, v in back.items()}), u)))


def test_samplers_table_matches_the_reference():
    assert list(samplers.SAMPLERS) == list(jsam.SAMPLERS)
    assert samplers.SAMPLERS["alias"][2] is None
    for name, cls in convert.SAMPLER_STATES.items():
        assert cls._fields == getattr(jsam, type(
            _jit(name, "init")(np.ones(4, np.float32))).__name__)._fields
