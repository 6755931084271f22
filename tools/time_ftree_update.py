"""Time the batched F+tree update kernel (``kernels/ftree_update/csrc/
ftree_update.cu``) of one source tree alone, on the same inputs whatever
the tree.

    python3 tools/time_ftree_update.py [--tree DIR] [--reps 10]

``--tree DIR`` times the package under ``DIR/src`` (built into
``DIR/build/kernels``); the default is this checkout.  For T ∈ {1024,
65,536, 2^20} leaves (a tree over seeded leaves, a third of them 0, made
by this script) and K = 2^20 updates, prints one JSON line a case:

* ``path``: the updates the batched F+tree path makes (``chip_smoke.py``'s
  ``_batched_phase``): the leaves of 2^20 seeded draws from the tree's
  own distribution (by ``searchsorted`` on its leaves' cumsum, so no
  kernel makes them), each delta 1;
* ``real``: uniform leaves, a quarter of them on leaf T/2, and normal
  deltas, as ``tests/test_torch_gpu.py`` makes them.

Each line has ``wrapper_ms`` (CUDA events around ``reps`` back-to-back
calls of ``ftree_update_cuda``, over ``reps``, as ``chip_smoke.py``
measures), ``graph_ms`` (a launch inside a CUDA graph of ``reps``
launches), ``bound_ms`` (the tree read and written and the updates read,
each once, over 3.35 TB/s; K·(log2 T + 1) adds over 67 TFLOP/s; the
larger), a ``checksum`` of the new tree's bits, which two trees must
share, and whether it equals the plain version on the CPU (which adds
each node's deltas in k order, as the kernel does).  A case the tree
refuses prints its error instead.  To compare trees, run it for each in
turns (A, B, B, A) in one call, one process a tree.

Needs a CUDA device; the first line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import pathlib
import subprocess
import sys

import torch

_HERE = pathlib.Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # f32 outside the tensor cores
K = 1 << 20
TOPICS = (1024, 65_536, 1 << 20)


def _leaves(T: int, gen) -> torch.Tensor:
    p = torch.rand(T, generator=gen, device="cuda")
    p[torch.rand(T, generator=gen, device="cuda") < 0.3] = 0.0
    return p


def _tree(p: torch.Tensor) -> torch.Tensor:
    """A heap-layout F+tree (2T,) over leaves ``p``, by pairwise sums."""
    levels = [p]
    while levels[-1].numel() > 1:
        levels.append(levels[-1][0::2] + levels[-1][1::2])
    return torch.cat([torch.zeros(1, device=p.device)] + levels[::-1])


def _cases(T: int, gen) -> dict:
    p = _leaves(T, gen)
    F = _tree(p)
    cdf = torch.cumsum(p.double(), 0)
    u = torch.rand(K, generator=gen, device="cuda", dtype=torch.float64)
    draws = torch.searchsorted(cdf, u * cdf[-1], right=True)
    draws = draws.clamp(max=T - 1).to(torch.int32)
    ts = torch.randint(T, (K,), generator=gen, device="cuda",
                       dtype=torch.int32)
    ts[:K // 4] = T // 2
    return {"path": (F, draws, torch.ones(K, device="cuda")),
            "real": (F, ts, torch.randn(K, generator=gen, device="cuda"))}


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


def _graph_ms(fn, reps: int) -> float:
    """A launch's time inside a CUDA graph of ``reps`` launches."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                          # warm, off capture
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, 1) / reps


def _checksum(F: torch.Tensor) -> int:
    bits = F.view(torch.int32).long()
    w = torch.arange(1, F.numel() + 1, device=F.device) % 65_521
    return int((bits * w).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(_HERE))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_ftree_update.py needs a CUDA device", file=sys.stderr)
        return 1
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels.ftree_update import ftree_update_ref
    fu = importlib.import_module(
        "repro_torch.kernels.ftree_update.ftree_update")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"tree {tree}; {gpu}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for T in TOPICS:
        for name, (F, ts, d) in _cases(T, gen).items():
            res = {"case": name, "K": K, "T": T, "tree": tree.name,
                   "gpu": gpu}
            try:
                got = fu.ftree_update_cuda(F, ts, d)
            except (ValueError, RuntimeError) as err:
                print(json.dumps({**res, "refused": str(err)}))
                continue
            res["checksum"] = _checksum(got)
            want = ftree_update_ref(F.cpu(), ts.cpu(), d.cpu())
            res["equal_to_plain"] = bool(torch.equal(got.cpu(), want))
            ok &= res["equal_to_plain"]
            call = lambda: fu.ftree_update_cuda(F, ts, d)   # noqa: E731
            t_bytes = (8 * K + 16 * T) / HBM_BYTES_PER_S * 1e3
            t_ops = K * (int(math.log2(T)) + 1) / F32_OPS_PER_S * 1e3
            res.update(wrapper_ms=_events_ms(call, args.reps),
                       graph_ms=_graph_ms(call, args.reps),
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else
                       "operations")
            print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
