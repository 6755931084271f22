"""The φ-frozen fold-in kernel of the serving path.

    csrc/fold_in.cu — the hand-written CUDA kernel (sm_90a)
    fold_in.py      — its launch wrapper and launch counter
    ops.py          — draw precompute and the device dispatch
    ref.py          — the plain PyTorch version on the same draws
"""
from repro_torch.kernels.fold_in.ops import (fold_in_draws,  # noqa: F401
                                             fold_in_fused)
from repro_torch.kernels.fold_in.ref import fold_in_kernel_ref  # noqa: F401
