"""PyTorch and CUDA port of the F+Nomad LDA system for NVIDIA Hopper.

Mirrors the module paths of the JAX package ``repro`` (the reference,
left unchanged beside it).  Ported so far: the trainer, a corpus →
``data/sharding.py:build_layout(layout="ragged")`` →
:class:`repro_torch.core.nomad.NomadLDA` → the hand-written CUDA
fused-sweep kernel (``kernels/fused_sweep``) → a φ snapshot; and the
serving path, φ snapshot → :class:`repro_torch.serve.lda_engine.LdaEngine`
→ the hand-written CUDA fold-in kernel (``kernels/fold_in``).

Entry points run on CUDA unless the caller passes ``device="cpu"``; on a
machine without CUDA they raise instead of falling back.  All randomness
comes from explicit threefry keys (:mod:`repro_torch.rng`), bit-equal to
``jax.random``.
"""
