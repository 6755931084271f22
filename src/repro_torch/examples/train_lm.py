"""Train a small LM with the port's training path (``examples/train_lm.py``).

    python -m repro_torch.examples.train_lm [--steps 200] [--device cpu]

The reduced qwen3 of the reference's script (its smoke config with 4
layers, d_model 256, d_ff 1024, vocab 2048), weights from seed 0, on the
reference's ramp batches ``(start + 7·i) mod V`` (the starts from
``rng.randint`` under the reference's keys, so the batches are its
bits).  Prints the loss every 25 steps, asserts that it fell, and saves
the params with ``train/checkpoint.py:save`` in the reference's format.
"""
import argparse
import dataclasses
import os
import tempfile
import time

from repro_torch import rng
from repro_torch.configs import get_config
from repro_torch.launch.train import lm_batch
from repro_torch.train import checkpoint
from repro_torch.train.train_step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt.npz"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).smoke()
    cfg = dataclasses.replace(cfg, num_layers=4, d_model=256, d_ff=1024,
                              vocab_size=2048)
    state = init_train_state(cfg, 0, device=args.device)
    dev = state.params.embed.device
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"arch {cfg.name}: {n_params / 1e6:.1f}M params on {dev}")
    step = make_train_step(cfg, lr=3e-4, remat=False)

    key = rng.key(1, dev)
    t0 = time.time()
    first = last = None
    for it in range(args.steps):
        key, k1 = rng.split(key)
        state, metrics = step(state, lm_batch(cfg, k1, args.batch,
                                              args.seq))
        if first is None:
            first = float(metrics["loss"])
        last = float(metrics["loss"])
        if (it + 1) % 25 == 0:
            print(f"step {it + 1:4d}  loss {last:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
    print(f"loss {first:.3f} -> {last:.3f} in {time.time() - t0:.0f}s")
    checkpoint.save(args.ckpt, state.params)
    print(f"checkpoint at {args.ckpt}")
    if not last < first:
        raise SystemExit("training must reduce loss")


if __name__ == "__main__":
    main()
