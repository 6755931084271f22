"""Inputs shared by the CPU and the card tests of the baseline samplers
(``core/samplers.py``, ``core/sparse_lda.py``, ``core/alias_lda.py``):
the sampler rows, one-token sweep cases whose draw flips with the
rounding of one sum, and a helper that forces a sweep's uniforms."""
import contextlib
from unittest import mock

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core.cgs import LDAState
from repro_torch.core.samplers import alias_init, lsearch_guarded
from repro_torch.kernels.fused_sweep.ref import U_MAX
from repro_torch.numerics import blocked_cumsum, fma, xla_sum

#: The largest f32 uniform ``jax.random.uniform`` returns: 1 − 2^-24.
U_TOP = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
BETA = 0.01

# ``tests/test_sampler_boundaries.py``'s mixed-magnitude count row, whose
# f32 ``sum()`` exceeds its blocked ``cumsum()[-1]`` (trailing zero).
ROW = np.array([73, 91, 289735, 8790, 11, 0, 0, 274, 461, 245, 2001000,
                815, 88026, 3, 240, 0, 0, 1475, 0, 153, 8531, 34647, 1180,
                800, 47, 170569, 9, 2231, 0, 5613, 5, 24, 2, 10729, 28371,
                13, 948, 1, 166020, 45013, 105, 126, 190, 126246, 1, 691,
                34649, 3168, 1389, 0, 439094, 1, 118, 10195, 119, 463,
                1908, 0, 0, 646325, 4204, 6, 12890, 0], dtype=np.int64)


def sampler_row(seed: int, T: int) -> np.ndarray:
    """Mixed-magnitude f32 parameters with zero runs (a zero tail from
    the middle on for even seeds), at least one positive."""
    r = np.random.default_rng(seed)
    p = (r.random(T) * 10.0 ** r.integers(-4, 3, T)).astype(np.float32)
    p[r.random(T) < 0.2] = 0.0
    if seed % 2 == 0 and T > 2:
        p[T // 2 + 1:] = 0.0
    p[0] += np.float32(0.5)
    return p


def u_grid(n: int = 97, seed: int = 0) -> np.ndarray:
    """Uniforms for the draws: an even grid, random ones, and the
    boundaries 0 and 1 − 2^-24."""
    r = np.random.default_rng(seed)
    return np.concatenate([np.linspace(0, 1, n, endpoint=False),
                           r.random(n), [0.0, 0.5, U_TOP]]).astype(
                               np.float32)


def update_seq(seed: int, T: int, n: int = 40):
    """``n`` updates ``(t, delta)`` that keep every parameter of
    :func:`sampler_row` non-negative: deltas in [0, 0.3) and, at a topic
    with mass, small negative ones."""
    r = np.random.default_rng(seed + 1000)
    p = sampler_row(seed, T).astype(np.float64)
    ts, ds = [], []
    for _ in range(n):
        t = int(r.integers(T))
        d = float(np.float32(r.random() * 0.3))
        if p[t] > 0.1 and r.random() < 0.4:
            d = -float(np.float32(p[t] * 0.5 * r.random()))
        p[t] += d
        ts.append(t)
        ds.append(d)
    return np.array(ts, np.int32), np.array(ds, np.float32)


# One-token SparseLDA cases (T = 8, β = 0.01, one doc, word 0 of J): the
# counts after the token's decrement, its old topic, and a uniform next to
# a draw boundary where the reference (jax 0.9.0, XLA CPU) draws topic
# ``want`` from ``bucket``, and rounding the named site the other way
# draws another topic:
#   doc_u    — the doc bucket's u = fma(u01, norm, -q_mass);
#   smooth_u — the smoothing bucket's u = fma(u01, norm, -q_mass) - r_mass.
SPARSE_FLIP_CASES = {
    "doc_u": dict(n_td=[3, 2, 2, 1, 1, 0, 0, 0],
                  n_wt=[5, 0, 0, 27, 0, 18, 0, 21],
                  n_t=[454, 4317, 112, 2735, 402, 1516, 2405, 2134],
                  t_old=3, u01=0.9952099919319153, alpha=0.1, J=10,
                  want=1, bucket=1),
    "smooth_u": dict(n_td=[0, 0, 2, 2, 2, 1, 2, 3],
                     n_wt=[0, 13, 29, 0, 29, 11, 20, 0],
                     n_t=[3252, 377, 4701, 2658, 1819, 3375, 2879, 1276],
                     t_old=2, u01=0.9995937943458557, alpha=1.0, J=240,
                     want=1, bucket=0),
}

# One-token AliasLDA cases with one MH step, as above; the stale tables
# come from word 0's counts before the decrement.  Sites:
#   prop_mass — the proposal's mass fma(α, stale_mass, r_mass);
#   q_num     — the q side's numerator fma(u, prop_mass, -r_mass);
#   density   — the proposal density fma(α, stale_q[t], r_vec[t]).
ALIAS_FLIP_CASES = {
    "prop_mass": dict(n_td=[0, 1, 0, 2, 1, 1, 2, 0],
                      n_wt=[1, 14, 28, 12, 0, 13, 5, 5],
                      n_t=[2530, 2996, 2657, 709, 2020, 214, 1008, 690],
                      t_old=1, J=162, u01=0.13427230715751648,
                      u_acc=0.08928682655096054, u_prop=0.05014172941446304,
                      alpha=6.25, want=4),
    "q_num": dict(n_td=[0, 0, 2, 0, 1, 0, 0, 0],
                  n_wt=[0, 25, 16, 1, 22, 21, 0, 0],
                  n_t=[771, 1871, 2310, 1152, 1405, 3012, 2414, 2942],
                  t_old=3, J=285, u01=0.5943000316619873,
                  u_acc=0.3916189968585968, u_prop=0.5780375599861145,
                  alpha=1.0, want=2),
    "density": dict(n_td=[0, 3, 0, 1, 0, 0, 1, 2],
                    n_wt=[0, 0, 21, 19, 17, 0, 24, 23],
                    n_t=[1596, 2319, 403, 974, 2195, 605, 865, 2960],
                    t_old=1, J=259, u01=0.3912937641143799,
                    u_acc=0.01459040679037571, u_prop=0.0, alpha=6.25,
                    want=2),
}

# The alias draw at T = 7 (``sampler_row``-free: p = U[0,1) + 0.01 from
# seed 0): the reference rounds u01·T before it subtracts j, and a fused
# multiply-add there draws topic 6 instead of 3.
ALIAS_DRAW_CASE = dict(seed=0, T=7, u01=0.43645036220550537, want=3,
                       fma_gives=6)


def alias_draw_row(case=ALIAS_DRAW_CASE) -> np.ndarray:
    return (np.random.default_rng(case["seed"]).random(case["T"])
            + 0.01).astype(np.float32)


def one_token_tables(case) -> dict:
    """The case's tables before the token's decrement, as numpy: a doc
    ``(1, T)``, ``J`` word rows with the case's in row 0, and ``n_t``."""
    T, t = len(case["n_td"]), case["t_old"]
    n_td = np.array([case["n_td"]], np.int32)
    n_wt = np.zeros((case["J"], T), np.int32)
    n_wt[0] = case["n_wt"]
    n_t = np.array(case["n_t"], np.int32)
    n_td[0, t] += 1
    n_wt[0, t] += 1
    n_t[t] += 1
    return dict(z=np.array([t], np.int32), n_td=n_td, n_wt=n_wt, n_t=n_t)


def one_token_state(case, device="cpu") -> LDAState:
    """The port's one-token state of a case (its key is never read when
    the uniforms are forced)."""
    i32 = lambda a: torch.as_tensor(a, device=device)
    tab = one_token_tables(case)
    return LDAState(z=i32(tab["z"]), n_td=i32(tab["n_td"]),
                    n_wt=i32(tab["n_wt"]), n_t=i32(tab["n_t"]),
                    key=rng.key(0, device))


@contextlib.contextmanager
def forced_uniforms(*values):
    """Make the port's sweeps draw the given uniforms: the k-th call of
    ``rng.uniform`` returns ``values[k]`` in the asked shape."""
    calls = iter(values)

    def forced(keys, shape=()):
        v = np.asarray(next(calls), np.float32)
        return torch.as_tensor(np.broadcast_to(v, shape).copy(),
                               device=keys.device)
    with mock.patch.object(rng, "uniform", forced):
        yield


def _post(case):
    f = lambda k: torch.tensor(case[k])
    return f("n_td"), f("n_wt"), f("n_t")


def sparse_flip_draw(case, other: str | None = None) -> int:
    """The case's SparseLDA draw, the port's way, or with the other
    rounding at site ``other``."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    n_td, n_wt, n_t = (x.float() for x in _post(case))
    a, b = f32(case["alpha"]), f32(BETA)
    denom = n_t + f32(BETA * case["J"])
    vecs = torch.stack([f32(case["alpha"] * BETA) / denom, b * n_td / denom,
                        n_wt * (n_td + a) / denom])
    s_mass, r_mass, q_mass = xla_sum(vecs)
    norm = s_mass + r_mass + q_mass
    u01 = f32(case["u01"])
    u_val = u01 * norm
    u_r = fma(u01, norm, -q_mass)
    u_r_round = u_val - q_mass
    u_doc = u_r_round if other == "doc_u" else u_r
    u_smooth = (u_r_round if other == "smooth_u" else u_r) - r_mass
    t = lsearch_guarded(blocked_cumsum(vecs),
                        torch.stack([u_smooth, u_doc, u_val]))
    if u_val < q_mass:
        return int(t[2])
    return int(t[1] if u_val < q_mass + r_mass else t[0])


def alias_flip_draw(case, other: str | None = None) -> int:
    """The case's AliasLDA draw (one MH step), the port's way, or with
    the other rounding at site ``other``."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    tab = one_token_tables(case)
    a, b, bb = f32(case["alpha"]), f32(BETA), f32(BETA * case["J"])
    stale_q = (torch.tensor(tab["n_wt"][0]).float() + b) / (
        torch.tensor(tab["n_t"]).float() + bb)
    stale_cdf = blocked_cumsum(stale_q)
    sm = stale_cdf[-1]
    n_td, n_wt, n_t = (x.float() for x in _post(case))
    q_vec = (n_wt + b) / (n_t + bb)
    r_vec = n_td * q_vec
    r_cdf = blocked_cumsum(r_vec)
    r_mass = r_cdf[-1]
    pm = a * sm + r_mass if other == "prop_mass" else fma(a, sm, r_mass)

    def propose(uu):
        uval = uu * pm
        num = uval - r_mass if other == "q_num" else fma(uu, pm, -r_mass)
        u_q = (num / (a * sm)).clamp(0.0, U_MAX) * sm
        cdf = r_cdf if uval < r_mass else stale_cdf
        return int(lsearch_guarded(cdf, uval if uval < r_mass else u_q))

    def p_true(t):
        return (n_td[t] + a) * q_vec[t]

    def density(t):
        if other == "density":
            return a * stale_q[t] + r_vec[t]
        return fma(a, stale_q[t], r_vec[t])

    t_cur = propose(f32(case["u01"]))
    t_prop = propose(f32(case["u_prop"]))
    ratio = (p_true(t_prop) * density(t_cur)) / torch.clamp(
        p_true(t_cur) * density(t_prop), min=1e-30)
    return t_prop if f32(case["u_acc"]) < torch.clamp(ratio, max=1.0) \
        else t_cur


def alias_draw_other(case=ALIAS_DRAW_CASE) -> int:
    """The alias draw of :data:`ALIAS_DRAW_CASE` with ``u01·T − j`` as one
    fused multiply-add."""
    st = alias_init(torch.as_tensor(alias_draw_row(case)))
    u01 = torch.tensor(case["u01"], dtype=torch.float32)
    T = case["T"]
    j = torch.floor(u01 * T).long().clamp(0, T - 1)
    frac = fma(u01, float(T), -j.float())
    return int(j if frac < st.prob[j] else st.alias[j])
