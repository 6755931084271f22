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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["blocked_cumsum", "fma", "SCAN_BLOCK"]

SCAN_BLOCK = 16


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
