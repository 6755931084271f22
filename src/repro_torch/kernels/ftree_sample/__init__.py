"""Batched F+tree sampling (paper Alg. 1, many draws from one tree).

    csrc/ftree_sample.cu — the hand-written CUDA kernel (sm_90a)
    ftree_sample.py      — its launch wrapper and launch counter
    ops.py               — the device dispatch
    ref.py               — the plain PyTorch version
"""
from repro_torch.kernels.ftree_sample.ops import ftree_sample  # noqa: F401
from repro_torch.kernels.ftree_sample.ref import (  # noqa: F401
    ftree_sample_ref)
