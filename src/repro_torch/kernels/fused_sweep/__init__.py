"""The fused F+LDA sweep of the trainer's path.

    csrc/fused_sweep.cu — the hand-written CUDA kernel (sm_90a)
    fused_sweep.py      — its launch wrapper and launch counter
    ops.py              — the device dispatch
    ref.py              — the plain PyTorch version (the chain oracle),
                          r-mode resolution and sub-ranges
    rbucket.py          — the compacted r-bucket vector and side tables
"""
from repro_torch.kernels.fused_sweep.ops import (  # noqa: F401
    fused_sweep_ragged, fused_sweep_tokens, sweep_streams)
