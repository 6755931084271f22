"""Time the batched F+tree sample kernel (``kernels/ftree_sample/csrc/
ftree_sample.cu``) alone, beside the wrapper call ``chip_smoke.py`` times.

    python tools/time_ftree_sample.py [--reps 20]

For N ∈ {2^20, 2^24} draws and T ∈ {1024, 16,384} leaves (a tree over
seeded mixed-magnitude leaves, a tenth of them 0), prints one JSON line
a case with:

* ``wrapper_ms``: CUDA events around ``reps`` back-to-back calls of
  ``ftree_sample_cuda``, over ``reps`` (the wrapper's checks, the
  launcher's host calls and the kernel, as ``chip_smoke.py`` measures);
* ``profiler_ms``: the kernel's own device time a launch under
  ``torch.profiler`` (CUPTI), ``null`` where the profiler sees none;
* ``graph_ms``: CUDA events around the replay of a CUDA graph of
  ``reps`` captured launches, over ``reps`` (no host work between them);
* ``bound_ms``: the larger of the bytes (the tree, the uniforms and the
  draws, each once) over 3.35 TB/s and ``N·(1 + 4·log2 T)`` f32
  operations over 67 TFLOP/s, and each time's share of it;
* a check that the draws equal the plain version's.

Needs a CUDA device; the first line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import ftree  # noqa: E402
from repro_torch.kernels.ftree_sample import ftree_sample_ref  # noqa: E402
from repro_torch.kernels.ftree_sample.ftree_sample import (  # noqa: E402
    ftree_sample_cuda)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # f32 outside the tensor cores
KERNEL = "ftree_sample_kernel"


def _tree(T: int, gen) -> torch.Tensor:
    p = torch.rand(T, generator=gen, device="cuda") * 10.0 ** torch.randint(
        -4, 2, (T,), generator=gen, device="cuda").float()
    p[torch.rand(T, generator=gen, device="cuda") < 0.1] = 0.0
    return ftree.build(p)


def _events_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profiler_ms(fn, reps: int):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [a for a in prof.key_averages() if KERNEL in a.key]
    n = sum(a.count for a in rows)
    us = sum(a.self_device_time_total for a in rows)
    return us / 1e3 / n if n and us > 0 else None


def _graph_ms(F, u, reps: int) -> float:
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ftree_sample_cuda(F, u)                       # warm, off capture
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            ftree_sample_cuda(F, u)
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, 1) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_ftree_sample.py needs a CUDA device", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(gpu)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for N in (1 << 20, 1 << 24):
        for T in (1024, 16_384):
            F = _tree(T, gen)
            u = torch.rand(N, generator=gen, device="cuda")
            got = ftree_sample_cuda(F, u)
            equal = bool(torch.equal(got, ftree_sample_ref(F, u)))
            call = lambda: ftree_sample_cuda(F, u)    # noqa: E731
            t_bytes = (8 * N + 8 * T) / HBM_BYTES_PER_S * 1e3
            t_ops = N * (1 + 4 * int(math.log2(T))) / F32_OPS_PER_S * 1e3
            bound = max(t_bytes, t_ops)
            res = {"N": N, "T": T,
                   "wrapper_ms": _events_ms(call, args.reps),
                   "profiler_ms": _profiler_ms(call, args.reps),
                   "graph_ms": _graph_ms(F, u, args.reps),
                   "bound_ms": bound,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "equal_to_plain": equal, "gpu": gpu}
            for key in ("wrapper_ms", "profiler_ms", "graph_ms"):
                if res[key]:
                    res[f"bound_share_{key[:-3]}"] = bound / res[key]
            print(json.dumps(res))
            if not equal:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
