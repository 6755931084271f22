"""Training launcher (``repro/launch/train.py``).

LDA (the paper):

    python -m repro_torch.launch.train lda --workers 8 --sweeps 40 \\
        --topics 64 --docs 1000 --ckpt /path/to/lda.npz [--device cpu]

Builds a synthetic corpus and its nomad layout, trains ``NomadLDA`` with
``--workers`` lock-step workers on one device (CUDA unless ``--device``
says otherwise), prints the log-likelihood and tokens a second every ten
sweeps, and saves ``z``, ``n_td``, ``n_wt`` and ``n_t`` with
:func:`repro_torch.train.checkpoint.save` (the reference's file format).
``--multi-pod`` is refused: one device has no pod axis.

The model zoo:

    python -m repro_torch.launch.train lm --arch qwen3-8b --steps 100 \\
        --smoke [--device cpu]

Trains ``--arch`` (its ``.smoke()`` config with ``--smoke``) from seed 0
with AdamW at lr 3e-4, B = 4, S = 128, and prints the loss every 20
steps.  The batches are the reference's: a text batch is a ramp
``(start + 7·i) mod V`` whose starts come from ``rng.randint`` under the
reference's keys (``key(1)``, split each step), so they equal the
reference's bit for bit; labels and tokens of the audio and vision archs
too.  Their frames and patches are standard normal draws from a torch
generator, the reference's law but not its bits.
"""
import argparse
import os
import sys
import tempfile
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["lda", "lm"])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--sweeps", type=int, default=40)
    ap.add_argument("--topics", type=int, default=64)
    ap.add_argument("--docs", type=int, default=1000)
    ap.add_argument("--sync", default="stoken",
                    choices=["stoken", "stale", "allreduce"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt.npz"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.multi_pod:
        raise SystemExit("--multi-pod needs a pod axis across devices; the "
                         "port runs its ring on one device")
    if args.mode == "lda":
        _run_lda(args)
    else:
        _run_lm(args)


def _run_lda(args):
    from repro_torch.core.nomad import NomadLDA
    from repro_torch.data import synthetic
    from repro_torch.data.sharding import build_layout
    from repro_torch.train import checkpoint

    T = args.topics
    corpus, _, _ = synthetic.make_corpus(
        num_docs=args.docs, vocab_size=4096, num_topics=T,
        mean_doc_len=80.0, seed=0)
    layout = build_layout(corpus, n_workers=args.workers, T=T)
    lda = NomadLDA(layout=layout, alpha=50.0 / T, beta=0.01,
                   sync_mode=args.sync, inner_mode="fused",
                   device=args.device)
    arrays = lda.init_arrays(seed=0)
    print(f"[lda] {corpus.num_tokens:,} tokens, {args.workers} workers on "
          f"{lda.dev}, sync={args.sync}")
    t0 = time.perf_counter()
    for it in range(args.sweeps):
        arrays = lda.sweep(arrays, seed=it)
        if (it + 1) % 10 == 0 or it == args.sweeps - 1:
            ll = lda.log_likelihood(arrays)
            rate = corpus.num_tokens * (it + 1) / (time.perf_counter() - t0)
            print(f"[lda] sweep {it + 1:4d} ll {ll:,.0f} ({rate:,.0f} "
                  f"tok/s on {lda.dev})")
    checkpoint.save(args.ckpt, {k: arrays[k]
                                for k in ("z", "n_td", "n_wt", "n_t")})
    print(f"[lda] checkpoint: {args.ckpt}")


def lm_batch(cfg, key, B: int, S: int, gen=None) -> dict:
    """The reference launcher's batch for ``cfg``'s modality from key
    ``key`` (an ``rng`` key): integers from ``rng.randint`` (the
    reference's bits), frames and patches normal from ``gen``."""
    from repro_torch import rng
    dev = key.device

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(dev)
    if cfg.modality == "audio_frames":
        return {"frames": normal(B, S, cfg.frontend_dim),
                "labels": rng.randint(key, cfg.vocab_size, (B, S))}
    if cfg.modality == "image_patches":
        return {"tokens": rng.randint(key, cfg.vocab_size, (B, S)),
                "patches": normal(B, cfg.frontend_tokens, cfg.frontend_dim)}
    start = rng.randint(key, cfg.vocab_size, (B, 1)).long()
    ramp = torch.arange(S, device=dev)[None, :] * 7
    return {"tokens": ((start + ramp) % cfg.vocab_size).to(torch.int32)}


def _run_lm(args):
    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    state = init_train_state(cfg, 0, device=args.device)
    dev = state.params.embed.device
    n = sum(p.numel() for p in state.params.parameters())
    print(f"[lm] {cfg.name}: {n / 1e6:.1f}M params on {dev}")
    step = make_train_step(cfg, lr=3e-4, remat=False)
    key = rng.key(1, dev)
    gen = torch.Generator().manual_seed(1)
    B, S = 4, 128
    for it in range(args.steps):
        key, k1 = rng.split(key)
        state, metrics = step(state, lm_batch(cfg, k1, B, S, gen))
        if (it + 1) % 20 == 0 or it == args.steps - 1:
            print(f"[lm] step {it + 1:4d} loss "
                  f"{float(metrics['loss']):.4f}")


if __name__ == "__main__":
    main()
