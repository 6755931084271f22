"""Time the batched F+tree sample kernel (``kernels/ftree_sample/csrc/
ftree_sample.cu``) of one source tree alone, beside the wrapper call
``chip_smoke.py`` times, on the same inputs whatever the tree.

    python3 tools/time_ftree_sample.py [--tree DIR] [--reps 20] [--ablate]

``--tree DIR`` times the package under ``DIR/src`` (built into
``DIR/build/kernels``); the default is this checkout.  For N ∈ {2^20,
2^24} draws and T ∈ {1024, 16,384, 65,536} leaves (a tree over seeded
mixed-magnitude leaves, a tenth of them 0, made by this script), prints
one JSON line a case with:

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
* ``checksum`` of the draws, which two trees must share, and whether
  they equal the tree's plain version's.

A case the tree refuses prints its error instead.  ``--ablate`` also
builds the tree's ``ftree_sample.cu`` with ``-DFTREE_ABLATE=k`` into
``DIR/build/ablate/`` (k = 1 skips the walk, 2 the fill, 3 the uniforms'
loads; k = 0 is the kernel as it is) and prints each one's ``graph_ms``
a case, and ``ptxas``' registers and shared memory.  To compare trees,
run it for each in turns (A, B, B, A) in one call.

Needs a CUDA device; the first line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import subprocess
import sys

import torch

_HERE = pathlib.Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # f32 outside the tensor cores
KERNEL = "ftree_sample_kernel"
CASES = [(N, T) for N in (1 << 20, 1 << 24) for T in (1024, 16_384, 65_536)]
ABLATIONS = {0: "kernel", 1: "no walk", 2: "no fill", 3: "no uniform loads"}


def _tree(T: int, gen) -> torch.Tensor:
    """A heap-layout F+tree (2T,) over seeded leaves, by pairwise sums."""
    p = torch.rand(T, generator=gen, device="cuda") * 10.0 ** torch.randint(
        -4, 2, (T,), generator=gen, device="cuda").float()
    p[torch.rand(T, generator=gen, device="cuda") < 0.1] = 0.0
    levels = [p]
    while levels[-1].numel() > 1:
        levels.append(levels[-1][0::2] + levels[-1][1::2])
    return torch.cat([torch.zeros(1, device="cuda")] + levels[::-1])


def _checksum(z: torch.Tensor) -> int:
    w = torch.arange(1, z.numel() + 1, device=z.device) % 65_521
    return int((z.long() * w).sum())


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


def _ablated(tree: pathlib.Path) -> dict:
    """``tree``'s ``ftree_sample.cu`` built once for each ablation."""
    from torch.utils import cpp_extension
    cu = tree / "src/repro_torch/kernels/ftree_sample/csrc/ftree_sample.cu"
    out = tree / "build/ablate"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = str(pathlib.Path(cpp_extension.CUDA_HOME or "/usr/local/cuda")
               / "bin" / "nvcc")
    sos = {k: out / f"libftree_sample_{k}.so" for k in ABLATIONS}
    procs = {k: subprocess.Popen(
        [nvcc, "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
         f"-DFTREE_ABLATE={k}", "-Xptxas=-v", "-Xcompiler", "-fPIC",
         "-shared", "-o", str(so), str(cu)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for k, so in sos.items()}
    libs = {}
    for k, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for FTREE_ABLATE={k}:\n{log}")
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(json.dumps({"ablation": ABLATIONS[k], "ptxas": ptxas}))
        lib = ctypes.CDLL(str(sos[k]))
        lib.ftree_sample_launch.restype = ctypes.c_int
        lib.ftree_sample_launch.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        libs[k] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(_HERE))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_ftree_sample.py needs a CUDA device", file=sys.stderr)
        return 1
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels.ftree_sample import ftree_sample_ref
    from repro_torch.kernels.ftree_sample.ftree_sample import (
        ftree_sample_cuda)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"tree {tree}; {gpu}")
    libs = _ablated(tree) if args.ablate else {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for N, T in CASES:
        F = _tree(T, gen)
        u = torch.rand(N, generator=gen, device="cuda")
        res = {"N": N, "T": T, "tree": tree.name, "gpu": gpu}
        try:
            got = ftree_sample_cuda(F, u)
        except (ValueError, RuntimeError) as err:
            print(json.dumps({**res, "refused": str(err)}))
            continue
        res["checksum"] = _checksum(got)
        res["equal_to_plain"] = bool(torch.equal(got,
                                                 ftree_sample_ref(F, u)))
        ok &= res["equal_to_plain"]
        call = lambda: ftree_sample_cuda(F, u)        # noqa: E731
        t_bytes = (8 * N + 8 * T) / HBM_BYTES_PER_S * 1e3
        t_ops = N * (1 + 4 * int(math.log2(T))) / F32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        res.update(wrapper_ms=_events_ms(call, args.reps),
                   profiler_ms=_profiler_ms(call, args.reps),
                   graph_ms=_graph_ms(call, args.reps), bound_ms=bound,
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        for key in ("wrapper_ms", "profiler_ms", "graph_ms"):
            if res[key]:
                res[f"bound_share_{key[:-3]}"] = bound / res[key]
        if libs:
            z = torch.empty_like(got)

            def ablated(lib):
                err = lib.ftree_sample_launch(
                    F.data_ptr(), u.data_ptr(), z.data_ptr(), N, T,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"ablated launch: cudaError_t {err}")

            res["ablations_graph_ms"] = {
                ABLATIONS[k]: _graph_ms(lambda: ablated(lib), args.reps)
                for k, lib in libs.items()}
        print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
