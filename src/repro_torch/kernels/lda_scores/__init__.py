"""The CGS conditional and inverse-CDF draw of the vectorized inner mode.

    csrc/lda_scores.cu — the hand-written CUDA kernel (sm_90a), rows and
                         pass forms
    lda_scores.py      — its launch wrapper and launch counters
    ops.py             — the device dispatch and the vectorized pass
    ref.py             — the plain PyTorch version
"""
from repro_torch.kernels.lda_scores.ops import (  # noqa: F401
    lda_scores_draw, lda_scores_pass, vectorized_pass)
from repro_torch.kernels.lda_scores.ref import (  # noqa: F401
    lda_scores_draw_ref, lda_scores_pass_ref)
