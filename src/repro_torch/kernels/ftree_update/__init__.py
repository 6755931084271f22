"""Batched F+tree maintenance (paper Alg. 2, many updates to one tree).

    csrc/ftree_update.cu — the hand-written CUDA kernel (sm_90a)
    ftree_update.py      — its launch wrapper and launch counter
    ops.py               — the device dispatch
    ref.py               — the plain PyTorch version
"""
from repro_torch.kernels.ftree_update.ops import (  # noqa: F401
    ftree_update_batch)
from repro_torch.kernels.ftree_update.ref import (  # noqa: F401
    ftree_update_ref)
