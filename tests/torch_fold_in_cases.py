"""Inputs for the fold-in tests shared by the CPU and the card tests."""
import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.samplers import lsearch_guarded
from repro_torch.numerics import SCAN_BLOCK, blocked_cumsum


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
