"""Threefry-2x32 keys and draws, bit-equal to ``jax.random`` (jax 0.9.0,
``jax_threefry_partitionable=True``, its default).

The JAX package draws every fold-in random number from counter-mode
``fold_in`` chains (``repro/core/heldout.py``).  The port reproduces those
bits exactly, so a document folded in by either package under the same
key runs the same chain.  A key is a ``(..., 2)`` tensor holding the two
uint32 words of ``jax.random.key_data``.  Words are stored in int64 and
masked to 32 bits after every add and shift: torch's uint32 coverage is
thin, and int64 runs the same code on the CPU and on CUDA tensors.

Ported from ``jax/_src/prng.py`` (``threefry_seed``, ``threefry_2x32``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py`` (``_uniform``, ``_randint``, ``_gumbel`` in its
default "low" mode, ``categorical`` with replacement).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.numerics import xla_log

__all__ = ["key", "key_data", "wrap_key_data", "fold_in", "split",
           "uniform", "randint", "token_uniforms", "gumbel", "categorical"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of counter ``(x0, x1)`` under key
    ``(k0, k1)`` (20 rounds); int64 tensors or ints holding uint32
    values, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``: key data ``[0, seed mod 2**32]``.  Seeds
    outside ``[-2**31, 2**32)`` raise (jax silently truncates them)."""
    seed = int(seed)
    if not -2**31 <= seed < 2**32:
        raise ValueError(f"seed must lie in [-2**31, 2**32), got {seed}")
    return torch.tensor([0, seed & _M32], dtype=torch.int64,
                        device=resolve(device))


def key_data(keys: torch.Tensor) -> np.ndarray:
    """The uint32 words of ``keys``, as ``jax.random.key_data`` gives."""
    return keys.cpu().numpy().astype(np.uint32)


def wrap_key_data(data, device=None) -> torch.Tensor:
    """Keys from ``(..., 2)`` uint32 words (``jax.random.wrap_key_data``)."""
    words = np.asarray(data, np.uint32)
    if words.ndim < 1 or words.shape[-1] != 2:
        raise ValueError(f"key data must have shape (..., 2); got "
                         f"{words.shape}")
    return torch.as_tensor(words.astype(np.int64), device=resolve(device))


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``, broadcast over ``keys[..., 0]`` and
    ``data`` (an int or an integer tensor; taken mod 2**32 as jax's
    uint32 cast does)."""
    d = torch.as_tensor(data, device=keys.device).to(torch.int64) & _M32
    h0, h1 = _threefry2x32(keys[..., 0], keys[..., 1], 0, d)
    return torch.stack(torch.broadcast_tensors(h0, h1), dim=-1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)`` per key: ``(..., num, 2)``.  Under the
    partitionable threefry, subkey ``i`` hashes counter ``(0, i)``, which
    is ``fold_in(k, i)``."""
    idx = torch.arange(int(num), device=keys.device)
    return fold_in(keys.unsqueeze(-2), idx)


def _bits32(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` per key, shape ``keys.shape[:-1] +
    shape``: element ``i`` (row-major) is the xor of the two words of the
    hash of counter ``(0, i)`` (the partitionable iota counters; every
    shape here has fewer than 2**32 elements, so the high word is 0)."""
    shape = tuple(int(n) for n in shape)
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2**32:
        raise ValueError(f"shape {shape} has 2**32 or more elements")
    k = keys.reshape(*keys.shape[:-1], *([1] * len(shape)), 2)
    ctr = torch.arange(n, device=keys.device, dtype=torch.int64)
    h0, h1 = _threefry2x32(k[..., 0], k[..., 1], 0, ctr.reshape(shape))
    return h0 ^ h1


def uniform(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` per key (f32 in ``[0, 1)``): the
    top 23 bits as a mantissa with exponent 0, minus 1."""
    mant = (_bits32(keys, shape) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def randint(keys: torch.Tensor, maxval: int, shape=()) -> torch.Tensor:
    """``jax.random.randint(k, shape, 0, maxval, jnp.int32)`` per key.

    jax splits each key in two (``split`` hashes counters ``(0, 0)`` and
    ``(0, 1)``, which is ``fold_in`` by 0 and 1), draws 32 bits per
    element from each half, and folds the 64 bits into ``[0, maxval)``
    with a span / multiplier reduction in wrapping uint32 arithmetic."""
    span = int(maxval)
    if not 1 <= span < 2**31:
        raise ValueError(f"randint needs 1 <= maxval < 2**31, got {span}")
    higher = _bits32(fold_in(keys, 0), shape)
    lower = _bits32(fold_in(keys, 1), shape)
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    offset = ((((higher % span) * mult) & _M32) + lower % span) & _M32
    return (offset % span).to(torch.int32)


def token_uniforms(keys: torch.Tensor, uids: torch.Tensor) -> torch.Tensor:
    """One uniform per token id, ``uniform(fold_in(k, uid))``, batched:
    ``keys`` ``(W, 2)`` and ``uids`` ``(W, ...)`` give ``(W, ...)`` f32.
    The counter-mode draws of ``repro/core/nomad.py:_token_uniforms``,
    with the workers' keys as a batch dimension."""
    k = keys.reshape(keys.shape[0], *([1] * (uids.ndim - 1)), 2)
    return uniform(fold_in(k, uids))


_TINY = float(np.finfo(np.float32).tiny)


def gumbel(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel(k, shape)`` per key (f32, mode "low"):
    ``-log(-log(u))`` of a uniform on [tiny, 1), each log XLA CPU's
    (``numerics.xla_log``).  The uniform is ``uniform``'s scaled by
    ``1 - tiny`` (1.0 in f32) and shifted by tiny, floored at tiny."""
    tiny = torch.tensor(_TINY, dtype=torch.float32, device=keys.device)
    u = torch.maximum(tiny, uniform(keys, shape) + tiny)
    return -xla_log(-xla_log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` along the last axis, for
    one key and f32 logits: ``argmax(gumbel(key, logits.shape) +
    logits)``, ties to the lower index as ``jnp.argmax`` breaks them."""
    if key.shape != (2,):
        raise ValueError(f"categorical takes one key, got shape "
                         f"{tuple(key.shape)}")
    g = gumbel(key.to(logits.device), logits.shape)
    return torch.argmax(g + logits.float(), dim=-1)
