#!/usr/bin/env python3
"""Time ``NomadLDA(inner_mode="vectorized")`` sweeps of one source tree on
one NVIDIA GPU, at ``chip_smoke.py``'s width.

    python3 tools/time_vectorized.py [--tree DIR]

``DIR`` is the root of a checkout of this repository (this one by
default); its own ``chip_smoke.py``, sources and kernels are used, the
kernels built into its own ``build/kernels/``.  Builds the smoke's
30,000-document corpus and ragged layout and runs the smoke's
``_vec_train``: 3 vectorized sweeps by CUDA events and the host clock,
then one under ``torch.profiler`` (the ``lda_scores`` kernel's device
time, the other kernels' time and launches, the device's busy share),
one JSON line each.  To compare two trees, run it for each in turns
(A, B, B, A) in one session on one card.  Exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(
        pathlib.Path(__file__).resolve().parents[1]))
    tree = pathlib.Path(ap.parse_args().tree).resolve()
    if not torch.cuda.is_available():
        print("time_vectorized.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"tree {tree}; {gpu}")
    cs._build.library()
    corpus = cs.nytimes_corpus(np.random.default_rng(cs.SEED),
                               cs._zipf_cdf())
    lay = cs.build_layout(corpus, n_workers=cs.W, T=cs.T, n_blocks=cs.B,
                          layout="ragged")
    cs._vec_train(f"ragged, vectorized, {tree.name}", lay, gpu,
                  profile=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
