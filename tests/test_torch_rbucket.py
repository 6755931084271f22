"""The port's r-bucket (``repro_torch/kernels/fused_sweep/rbucket.py``)
against ``repro/kernels/fused_sweep/rbucket.py``, bit for bit, on
hypothesis-drawn count rows: the compaction, the side-table updates (with
capacities below T, full tables included), the rounded-product cumsum, and
the guarded pick at the boundary uniforms 1 − 2⁻²² and 1 − 2⁻²⁴ and on
zero-mass rows."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.fused_sweep import rbucket as jrb
from repro_torch.kernels.fused_sweep import rbucket

U_BOUNDARY = [0.0, 0.5, 1.0 - 2.0**-22, 1.0 - 2.0**-24]


def _rows(seed, T, n=24, density=0.3):
    r = np.random.default_rng(seed)
    rows = r.integers(1, 5, (n, T)) * (r.random((n, T)) < density)
    rows[0] = 0                                    # an empty document
    rows[1] = 0
    rows[1, T - 1] = 3                             # one topic, the last
    return rows.astype(np.int32)


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), logT=st.integers(1, 7),
       cap_frac=st.floats(0.05, 1.0))
def test_compact_and_side_tables_match(seed, logT, cap_frac):
    T = 1 << logT
    cap = max(1, int(T * cap_frac))
    rows = _rows(seed, T)
    want = jrb.build_side_table(jnp.asarray(rows), cap)
    _eq(rbucket.build_side_table(torch.as_tensor(rows), cap), want)
    _eq(rbucket.compact_row(torch.as_tensor(rows[2]), cap),
        jrb.compact_row(jnp.asarray(rows[2]), cap))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), logT=st.integers(1, 7),
       cap_frac=st.floats(0.05, 1.0))
def test_decrement_and_increment_match(seed, logT, cap_frac):
    """Random topics, present or not, valid or masked, on tables that are
    partly full or full (cap below the active count)."""
    T = 1 << logT
    cap = max(1, int(T * cap_frac))
    r = np.random.default_rng(seed)
    rows = _rows(seed, T)
    tpc, cnt = jrb.build_side_table(jnp.asarray(rows), cap)
    t = r.integers(0, T, rows.shape[0]).astype(np.int32)
    present = np.asarray(tpc)[np.arange(rows.shape[0]),
                              r.integers(0, cap, rows.shape[0])]
    t[::2] = present[::2]
    valid = r.random(rows.shape[0]) < 0.8
    args_j = (tpc, cnt, jnp.asarray(t), jnp.asarray(valid))
    args_p = (torch.as_tensor(np.asarray(tpc)),
              torch.as_tensor(np.asarray(cnt)), torch.as_tensor(t),
              torch.as_tensor(valid))
    _eq(rbucket.decrement(*args_p), jax.vmap(jrb.decrement)(*args_j))
    _eq(rbucket.increment(*args_p), jax.vmap(jrb.increment)(*args_j))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), logT=st.integers(1, 10),
       u_pick=st.integers(0, 3))
def test_cumsum_and_pick_match(seed, logT, u_pick):
    T = 1 << logT
    r = np.random.default_rng(seed)
    rows = _rows(seed, T, n=8)
    q = (r.random(T) * 10.0 ** r.integers(-6, 3, T)).astype(np.float32)
    tpc, cnt = jrb.build_side_table(jnp.asarray(rows), T)
    c_j = jax.jit(jax.vmap(jrb.r_cumsum, in_axes=(0, 0, None)))(
        tpc, cnt, jnp.asarray(q))
    tp, cp = torch.as_tensor(np.asarray(tpc)), torch.as_tensor(
        np.asarray(cnt))
    c_p = rbucket.r_cumsum(tp, cp, torch.as_tensor(q))
    np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_j))
    u = (np.float32(U_BOUNDARY[u_pick]) * np.asarray(c_j)[:, -1]).astype(
        np.float32)
    want = jax.vmap(jrb.pick)(tpc, cnt, c_j, jnp.asarray(u))
    got = rbucket.pick(tp, cp, c_p, torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0] == 0 and got[1] == T - 1        # empty row; lone topic


def test_r_cumsum_takes_per_row_q():
    r = np.random.default_rng(4)
    rows = _rows(4, 16, n=5)
    q = r.random((5, 16)).astype(np.float32)
    tpc, cnt = rbucket.build_side_table(torch.as_tensor(rows), 16)
    per_row = rbucket.r_cumsum(tpc, cnt, torch.as_tensor(q))
    for i in range(5):
        one = rbucket.r_cumsum(tpc[i], cnt[i], torch.as_tensor(q[i]))
        assert torch.equal(per_row[i], one)
