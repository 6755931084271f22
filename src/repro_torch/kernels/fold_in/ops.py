"""Public fold-in op: draw precompute, shape checks, and the device
dispatch between the CUDA kernel and its plain version.

:func:`fold_in_fused` is a drop-in for ``core/heldout.py:fold_in_batch``,
bit-equal per document.  :func:`fold_in_draws` computes every draw before
the kernel runs, by the counter-mode chains ``fold_in_batch`` derives in
its loop (the same ``fold_in``/``randint``/``uniform`` call sites, so the
bits agree), and the kernel replays the chain on plain arrays.
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.core.heldout import _ROLE_INIT, _ROLE_SWEEP
from repro_torch.kernels.fold_in.fold_in import check_fits, fold_in_cuda
from repro_torch.kernels.fold_in.ref import fold_in_kernel_ref

__all__ = ["fold_in_draws", "fold_in_fused"]


def fold_in_draws(doc_keys: torch.Tensor, L: int, T: int, sweeps: int):
    """The kernel's draws, on ``doc_keys``' device: ``z0`` (D, L) int32
    and ``u`` (D, sweeps, L) f32.

    Position ``p``'s initial topic comes from ``fold_in(fold_in(dk, 0),
    p)`` and sweep ``k``'s uniform from ``fold_in(fold_in(fold_in(dk, 1),
    k), p)``: pure functions of the key bits, so taking them out of the
    sweep loop changes nothing.
    """
    dev = doc_keys.device
    pos = torch.arange(L, device=dev)
    ik = rng.fold_in(doc_keys, _ROLE_INIT)
    z0 = rng.randint(rng.fold_in(ik[:, None], pos), T)
    sk = rng.fold_in(doc_keys, _ROLE_SWEEP)
    ks = rng.fold_in(sk[:, None], torch.arange(int(sweeps), device=dev))
    u = rng.uniform(rng.fold_in(ks[:, :, None], pos))
    return z0, u


def fold_in_fused(word_ids: torch.Tensor, valid: torch.Tensor,
                  phi: torch.Tensor, alpha, doc_keys: torch.Tensor,
                  sweeps: int = 20) -> torch.Tensor:
    """Fold-in of a padded ``(D, L)`` batch through the fold-in kernel:
    ``(D, T)`` int32 counts, bit-equal per row to ``fold_in_batch``.

    On a CUDA ``phi`` it launches the CUDA kernel (or raises, e.g.
    ``ValueError`` when ``(L, T)`` exceeds the kernel's shared memory:
    use ``inner_mode="scan"`` or a smaller length bucket).  On a CPU
    ``phi`` it runs the plain version, :func:`fold_in_kernel_ref`.
    """
    if word_ids.ndim != 2 or word_ids.shape != valid.shape:
        raise ValueError(
            f"word_ids/valid must be matching (D, L) arrays; got "
            f"{tuple(word_ids.shape)} and {tuple(valid.shape)}")
    if doc_keys.shape[0] != word_ids.shape[0]:
        raise ValueError(
            f"doc_keys carries {doc_keys.shape[0]} keys for "
            f"{word_ids.shape[0]} rows")
    if sweeps < 1:
        raise ValueError(
            f"fold_in_fused needs sweeps >= 1, got {sweeps} (sweeps=0 is "
            f"the init counts — use fold_in_batch)")
    D, L = word_ids.shape
    T = phi.shape[1]
    dev = phi.device
    on_card = dev.type == "cuda"
    if on_card:
        check_fits(L, T)
    z0, u = fold_in_draws(doc_keys.to(dev), L, T, int(sweeps))
    words = word_ids.to(dev, torch.int32)
    v = valid.to(dev, torch.int32)
    if on_card:
        return fold_in_cuda(words.contiguous(), v.contiguous(), z0,
                            u.reshape(D, int(sweeps) * L), float(alpha),
                            phi.to(torch.float32).contiguous())
    return fold_in_kernel_ref(words, v, z0, u, alpha, phi)
