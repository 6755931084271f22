"""Batched serving with the port's engine (``examples/serve_lm.py``).

    python -m repro_torch.examples.serve_lm [--device cpu]

Serves a randomly initialised qwen3-8b smoke model: batched
variable-length prompts, prefill and greedy decode with per-sequence
cache offsets.  The weights come from a seeded ``torch.Generator``, not
from the reference's key, so the tokens are not the reference script's.
"""
import argparse
import time

from repro_torch.configs import get_config
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import generate


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA)")
    args = p.parse_args(argv)
    cfg = get_config("qwen3-8b").smoke()
    params = init_params(cfg, 0, device=args.device)
    prompts = [
        [11, 42, 7, 3, 99],
        [5, 6],
        [1, 2, 3, 4, 5, 6, 7, 8],
        [250],
    ]
    t0 = time.time()
    out = generate(params, cfg, prompts, max_new_tokens=8,
                   device=args.device)
    dt = time.time() - t0
    n_tok = sum(len(o) for o in out)
    for prompt, o in zip(prompts, out):
        print(f"prompt {prompt} -> {o}")
    print(f"{n_tok} tokens in {dt:.1f}s "
          f"(batch={len(prompts)}, variable lengths, one shared cache)")


if __name__ == "__main__":
    main()
