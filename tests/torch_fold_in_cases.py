"""Inputs shared by the CPU and the card tests: the fold-in cases, and the
fused-sweep cases whose draw flips with the rounding of one product."""
import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import ftree
from repro_torch.core.samplers import lsearch_guarded
from repro_torch.kernels.fused_sweep import rbucket
from repro_torch.numerics import SCAN_BLOCK, blocked_cumsum, fma


def _draw(cdf, u, total):
    uval = torch.tensor(u, dtype=torch.float32) * total
    return int(lsearch_guarded(cdf[None], uval[None])[0])


def total_rounding_case(T=1024, alpha=0.5, seed=0):
    """A φ row and a uniform whose single draw depends on how ``cdf[T-1]``
    is rounded.

    The blocked scan forms ``cdf[T-1]`` as the last block's local total
    plus that block's exclusive prefix.  The inclusive scan of the block
    totals ends on a value that can differ from it in the last bit.  The
    returned ``u`` draws topic ``want`` under the first and another topic
    under the second, so only a scan in the reference's order passes.
    The two can differ only when the block totals are themselves scanned
    in blocks, i.e. for ``T > 16 * 16``.  For one token whose counts are all 0 after its decrement, ``prob`` is
    ``α·φ``.  Returns ``(row, u, want)``.
    """
    r = np.random.default_rng(seed)
    a = torch.tensor(alpha, dtype=torch.float32)
    for _ in range(200):
        row = (r.random(T) * 10.0 ** r.integers(-6, 3, T)).astype(np.float32)
        prob = (torch.zeros(T) + a) * torch.as_tensor(row)
        cdf = blocked_cumsum(prob)
        nb = -(-T // SCAN_BLOCK)
        blocks = F.pad(prob, (0, nb * SCAN_BLOCK - T)).reshape(nb, -1)
        sums = torch.stack([blocked_cumsum(b)[-1] for b in blocks])
        wrong = blocked_cumsum(sums)[-1]
        total = cdf[-1]
        if wrong == total:
            continue
        for k in range(T - 1, 0, -1):
            u = np.float32(cdf[k] / total)
            for _ in range(4):
                if _draw(cdf, u, total) != _draw(cdf, u, wrong):
                    return row, float(u), _draw(cdf, u, total)
                u = np.nextafter(u, np.float32(2))
    raise AssertionError("no φ row found whose draw depends on cdf[T-1]")


# Single-token fused-sweep cases (T = 8, beta = 0.01, one word, one doc),
# each found by a search over the f32 uniforms next to a draw boundary:
# the reference (``fused_sweep_ref`` under jit and ``fused_sweep_pallas``
# in interpret mode, jax 0.9.0 on XLA CPU) draws ``want``, and rounding
# the named site the other way draws another topic.
#   norm_r — u_val = u01 * fma(alpha, q_total, r_mass) on the r side;
#   norm_q — the q side's norm alpha*q_total + r_mass, rounded as written;
#   qnum   — fma(u01, norm, -r_mass), the q side's numerator;
#   walk   — u01 * F[1] rounded before the tree walk subtracts ``left``.
FLIP_CASES = {
    "norm_r": dict(n_td=[3, 1, 1, 1, 1, 0, 1, 0],
                   n_wt=[26, 1, 7, 23, 11, 25, 10, 23],
                   n_t=[1803, 3632, 571, 1217, 4993, 1484, 4664, 1992],
                   t_old=1, u01=0.13932899, alpha=6.25, J=38976, want=0),
    "norm_q": dict(n_td=[2, 0, 1, 1, 2, 2, 1, 0],
                   n_wt=[15, 2, 24, 15, 1, 11, 18, 0],
                   n_t=[4234, 3674, 2831, 337, 1906, 1404, 2388, 925],
                   t_old=4, u01=0.99985605, alpha=6.25, J=63285, want=6),
    "qnum": dict(n_td=[2, 0, 4, 1, 1, 2, 3, 1],
                 n_wt=[20, 13, 9, 9, 20, 24, 12, 0],
                 n_t=[3460, 3221, 3679, 1486, 4536, 4512, 2138, 4710],
                 t_old=2, u01=0.99997413, alpha=1.0, J=74789, want=7),
    "walk": dict(n_td=[0, 1, 0, 0, 0, 0, 0, 0],
                 n_wt=[20, 17, 19, 10, 22, 25, 15, 24],
                 n_t=[603, 2913, 2386, 1673, 2750, 2413, 3021, 4614],
                 t_old=1, u01=0.8319722, alpha=0.1, J=93081, want=6),
}
FLIP_BETA = 0.01


def flip_inputs(case, device="cpu"):
    """The case as one-token ``fused_sweep_ref`` arguments (a boundary
    token of word 0 in doc 0) and its keyword arguments."""
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=device)
    args = (i32([0]), i32([0]), i32([1]), i32([1]), i32([case["t_old"]]),
            torch.tensor([case["u01"]], dtype=torch.float32, device=device),
            i32([case["n_td"]]), i32([case["n_wt"]]), i32(case["n_t"]))
    kw = dict(alpha=case["alpha"], beta=FLIP_BETA,
              beta_bar=FLIP_BETA * case["J"])
    return args, kw


def flip_draw(case, other: str | None = None) -> int:
    """The case's draw, the port's way, or with the other rounding at site
    ``other`` (a key of :data:`FLIP_CASES`)."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    a, b = f32(case["alpha"]), f32(FLIP_BETA)
    bb = f32(FLIP_BETA * case["J"])
    n_td, n_wt, n_t = (torch.tensor(case[k]) for k in ("n_td", "n_wt",
                                                      "n_t"))
    t = case["t_old"]
    F = ftree.build((n_wt.float() + b) / (n_t.float() + bb))
    n_td[t] -= 1
    n_wt[t] -= 1
    n_t[t] -= 1
    F = ftree.set_leaf(F, torch.tensor(t),
                       (n_wt[t].float() + b) / (n_t[t].float() + bb))
    tpc, cnt = rbucket.compact_row(n_td, n_td.shape[0])
    c = rbucket.r_cumsum(tpc, cnt, ftree.leaves(F))
    r_mass, qt = c[-1], F[1]
    u01 = f32(case["u01"])
    aq = a * qt
    u_val = u01 * (aq + r_mass if other == "norm_r" else fma(a, qt, r_mass))
    if u_val < r_mass:
        return int(rbucket.pick(tpc, cnt, c, u_val))
    norm = fma(a, qt, r_mass) if other == "norm_q" else aq + r_mass
    num = u01 * norm - r_mass if other == "qnum" else fma(u01, norm,
                                                          -r_mass)
    x = (num / torch.clamp(aq, min=1e-30)).clamp(0.0, 0.99999988)
    if other != "walk":
        return int(ftree.sample(F, x))
    u, i = x * F[1], 1                    # the first step contracted
    T = F.shape[0] // 2
    while i < T:
        left = F[2 * i]
        go = bool(u >= left) and bool(F[2 * i + 1] > 0)
        if go:
            u = fma(x, F[1], -left) if i == 1 else u - left
        i = 2 * i + int(go)
    return i - T
