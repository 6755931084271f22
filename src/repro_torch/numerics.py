"""Float reductions in the order the JAX reference rounds them.

The reference runs on XLA CPU, where ``jnp.cumsum`` of an f32 row is a
recursive blocked scan: sequential within 16-element blocks, the block
totals scanned by the same rule, and each block's exclusive prefix added
to its elements.  Every f32 cumsum on the fold-in chain (the ``cdf`` of
``repro/core/heldout.py`` and ``repro/kernels/fold_in``) is taken in this
order, so :func:`blocked_cumsum` is what the port uses, in its plain path
and inside its CUDA kernel.

Neither ``torch.cumsum`` nor a CUB / ``tl.cumsum`` scan may replace it:
they round partial sums in another order, and a cdf that differs in its
last bit moves a draw on a boundary uniform to the next topic, which forks
the whole chain.  ``tests/test_torch_numerics.py`` pins both facts: this
order matches ``jax.jit(jnp.cumsum)`` bit for bit, and ``torch.cumsum``
does not at length 1024.

XLA CPU also contracts some products into the add that follows them, as
one fused multiply-add, and which ones depends on how it fuses the
surrounding code.  :func:`fma` is the exact f32 fused multiply-add for the
plain path (the CUDA kernel uses ``__fmaf_rn``).  On the F+LDA chain
(``kernels/fused_sweep/ref.py``) it takes the sites the reference was
found to contract, each pinned by a case in
``tests/test_torch_fused_sweep.py`` whose draw flips with the rounding.

A ``jnp.sum`` of an f32 row is not taken in order either.  XLA CPU
rewrites a reduction of more than 32 values into runs of 32, each summed
in order, over the row padded with zeros to a multiple of 32: half the
padding (rounded down) before the row, the rest after it.  The run
totals are reduced by the same rule until at most 32 are left, and those
are summed in order.  :func:`xla_sum` takes this order; ``core/ftree.py``
sums the root of a tree so.

XLA CPU's f32 ``log`` is not the C library's: it expands ``log`` into
Cephes' polynomial (the one Eigen's ``plog`` used), whose products LLVM
contracts into fused multiply-adds, and it is not correctly rounded.
:func:`xla_log` takes the same steps with the same contractions, so the
Gumbel noise of ``jax.random.categorical`` (``rng.gumbel``) comes out
bit for bit; ``torch.log`` differs from it in the last bit on about a
quarter of the inputs in (0, 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["blocked_cumsum", "fma", "xla_sum", "xla_log", "SCAN_BLOCK",
           "SUM_RUN"]

SCAN_BLOCK = 16
#: Values summed in one sequential run at each level of :func:`xla_sum`.
SUM_RUN = 32


def _sequential_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along the last dim, one add per element in order."""
    out = x.clone()
    for j in range(1, x.shape[-1]):
        out[..., j] += out[..., j - 1]
    return out


def blocked_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive cumsum along ``dim`` in XLA CPU's blocked-16 order, for
    any length (a ragged last block scans as if zero-padded)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return _sequential_scan(x).movedim(-1, dim)
    nb = -(-n // SCAN_BLOCK)
    blocks = F.pad(x, (0, nb * SCAN_BLOCK - n)).reshape(
        *x.shape[:-1], nb, SCAN_BLOCK)
    local = _sequential_scan(blocks)
    prefix = blocked_cumsum(local[..., -1])
    local[..., 1:, :] += prefix[..., :-1, None]
    out = local.reshape(*x.shape[:-1], nb * SCAN_BLOCK)[..., :n]
    return out.movedim(-1, dim)


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    """``x[..., 0] + x[..., 1] + ...`` along the last dim, in order."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """``Σ x`` along the last dim in XLA CPU's order: runs of
    :data:`SUM_RUN` summed in order over the row zero-padded to a
    multiple of the run, ``(m - n) // 2`` zeros before it and the rest
    after, then the run totals by the same rule, until at most one run
    is left.  Adding a zero leaves a partial sum as it is."""
    n = x.shape[-1]
    while n > SUM_RUN:
        m = -(-n // SUM_RUN) * SUM_RUN
        lo = (m - n) // 2
        runs = F.pad(x, (lo, m - n - lo)).reshape(*x.shape[:-1], -1, SUM_RUN)
        x = _sequential_sum(runs)
        n = x.shape[-1]
    return _sequential_sum(x)


def fma(a, b, c) -> torch.Tensor:
    """``a*b + c`` rounded once to f32, as a fused multiply-add does;
    broadcast over f32 tensors (or Python floats, taken as f32).

    The f64 product of two f32 values is exact.  The f64 sum rounds once,
    and casting it to f32 would round a second time, which is wrong where
    the first rounding lands on an f32 midpoint.  So the sum is rounded
    to odd instead: TwoSum gives its exact error, and a non-zero error on
    an even last bit moves the sum one f64 ulp toward the exact value.
    An f64 rounded to odd has more than 2 + 24 bits, so the cast to f32
    then rounds correctly."""
    a, b, c = (torch.as_tensor(x, dtype=torch.float32) for x in (a, b, c))
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    bits = s.view(torch.int64)
    nudge = torch.where((err > 0) == (s > 0), 1, -1)
    odd = torch.where((err != 0) & (bits & 1 == 0) & torch.isfinite(s),
                      bits + nudge, bits)
    return odd.view(torch.float64).float()


# Cephes logf: the polynomial in x = m - 1 on [sqrt(1/2) - 1, sqrt(2) - 1]
# and ln 2 split in two (q2 + q1), as XLA CPU's log expansion holds them.
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRTHF = 0.707106781186547524
_MIN_NORM = 1.17549435e-38


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of an f32 tensor as XLA CPU computes it, bit for bit:
    the exponent split off, the mantissa m moved into [sqrt(1/2),
    sqrt(2)), Cephes' polynomial in m - 1 evaluated with the fused
    multiply-adds LLVM forms, and e·ln 2 added back in two parts.  As
    there, denormals count as 0 (XLA CPU runs denormals-are-zero), 0
    gives -inf, +inf gives +inf and a negative input NaN."""
    x = x.float()
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    xc = torch.where(f(_MIN_NORM) >= x, f(_MIN_NORM), x)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < f(_SQRTHF)
    e = e - low.float()
    z = (m - 1.0) + torch.where(low, m, f(0.0))
    z2 = z * z
    z3 = z2 * z
    p = _LOG_P
    a = fma(z, fma(z, p[0], p[1]), p[2])
    b = fma(z, fma(z, p[3], p[4]), p[5])
    c = fma(z, fma(z, p[6], p[7]), p[8])
    y = fma(z3, fma(z3, fma(z3, a, b), c), e * f(_LOG_Q1))
    out = fma(_LOG_Q2, e, fma(-0.5, z2, z) + y)
    out = torch.where(x.abs() < _MIN_NORM, f(float("-inf")), out)
    out = torch.where(x == float("inf"), f(float("inf")), out)
    return torch.where((x <= -_MIN_NORM) | torch.isnan(x), f(float("nan")),
                       out)
