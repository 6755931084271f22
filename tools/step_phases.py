#!/usr/bin/env python3
"""Time the phases of the fused-sweep kernel's per-token step on the
heaviest stream of a nomad round, with ``clock64`` probes, on one NVIDIA
GPU, at ``chip_smoke.py``'s width (T = 1024, W = 132, the NYTimes-shaped
corpus).

    python3 tools/step_phases.py [--tree DIR] [--rounds N] [--sparse]

``DIR`` is the root of a checkout (this one by default).  The script
builds that checkout's ``fused_sweep.cu`` with ``-DSTEP_PROBES``, which
turns on the ``PHASE`` probes the kernel carries after each phase of its
step, with ``nvcc`` into ``DIR/build/step_phases/``, and launches it
through the checkout's own wrapper on the first ``N`` rounds of a dense
(or, with ``--sparse``, sparse, ``r_cap = T``) r-mode ragged sweep from
the initial arrays.  Thread 0 of the CTA with the most valid tokens adds
the cycles between probes to one counter a phase.  One JSON line a round:
the kernel's time by CUDA events, the heavy stream's valid tokens and
rebuilds, and each phase's cycles a token and share; the cycles are
turned into microseconds at the rate of that CTA's cycles over the
launch's time.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

# The kernel's counters (fused_sweep.cu, kProbe*): phases 0 .. 7, then
# valid tokens, rebuilds and the total.
_VALID, _REBUILDS, _TOTAL = 8, 9, 10
_PHASES = ["rebuild", "row copy, decrement", "compaction",
           "products, scan", "count le", "draw", "increment",
           "events, metadata"]


def _build_probed(tree: pathlib.Path, argtypes: list):
    from torch.utils import cpp_extension
    cu = tree / "src/repro_torch/kernels/fused_sweep/csrc/fused_sweep.cu"
    out = tree / "build/step_phases"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libfused_sweep_probed.so"
    nvcc = str(pathlib.Path(cpp_extension.CUDA_HOME or "/usr/local/cuda")
               / "bin" / "nvcc")
    subprocess.run([nvcc, "-O3", "-std=c++17",
                    "-gencode=arch=compute_90a,code=sm_90a", "-DSTEP_PROBES",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(so),
                    str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    for name, types in (("fused_sweep_launch", argtypes),
                        ("fused_sweep_smem_bytes", [ctypes.c_int] * 4),
                        ("fused_sweep_scratch_bytes", [ctypes.c_int] * 4),
                        ("fused_sweep_placement", [ctypes.c_int] * 4),
                        ("step_probe", [ctypes.c_int, ctypes.c_void_p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, types
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(
        pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sparse", action="store_true")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    if not torch.cuda.is_available():
        print("step_phases.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"tree {tree}; {gpu}")
    lib = _build_probed(tree, cs._build._LAUNCHERS["fused_sweep_launch"])
    cs._build.library = lambda: lib          # the wrapper's calls go here
    corpus = cs.nytimes_corpus(np.random.default_rng(cs.SEED),
                               cs._zipf_cdf())
    lay = cs.build_layout(corpus, n_workers=cs.W, T=cs.T, n_blocks=cs.B,
                          layout="ragged")
    model = cs.NomadLDA(layout=lay, alpha=cs.ALPHA, beta=cs.BETA,
                        inner_mode="fused", device="cuda")
    a = model.init_arrays(cs.SEED)
    T, W = lay.T, lay.W
    u = torch.rand((W, lay.stream_len), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))
    host = (ctypes.c_ulonglong * 16)()
    for r in range(args.rounds):
        w = torch.arange(W, device="cuda")
        valid = a["tok_valid"][w, (w + r) % W].sum(1)
        heavy = int(valid.argmax())
        if lib.step_probe(heavy, None) != 0:
            raise RuntimeError("step_probe failed")
        z, n_td, n_wt = (a[k].clone() for k in ("z", "n_td", "n_wt"))
        tables = {}
        if args.sparse:
            tpc, cnt = cs.rbucket.build_side_table(n_td.view(-1, T), T)
            tables = dict(topics=tpc, counts=cnt)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        cs.fs_mod.sweep_streams_cuda(
            a["tok_doc"], a["tok_wrd"], a["tok_valid"], a["tok_bound"], z, u,
            a["cell_of_tile"], n_td.view(-1, T), n_wt.view(-1, T),
            a["n_t"].expand(W, T).contiguous(), r=r, k=lay.k, tile=lay.tile,
            tile_start=0, num_tiles=lay.n_tiles, I_max=lay.I_max,
            J_max=lay.J_max, alpha=cs.ALPHA, beta=cs.BETA,
            beta_bar=model.beta_bar, cap=T, kernel="fused_sweep_ragged",
            **tables)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        if lib.step_probe(heavy, ctypes.addressof(host)) != 0:
            raise RuntimeError("step_probe failed")
        acc = list(host)
        tokens, cycles = acc[_VALID], acc[_TOTAL]
        per_us = cycles / (ms * 1e3)                   # cycles a microsecond
        phases = {name: {"cycles_a_token": acc[i] / tokens,
                         "us_a_token": acc[i] / tokens / per_us,
                         "share": acc[i] / cycles}
                  for i, name in enumerate(_PHASES)}
        phases[_PHASES[0]]["rebuilds"] = acc[_REBUILDS]
        print(json.dumps({"round": r, "sparse": args.sparse,
                          "kernel_ms": ms, "heavy_cta": heavy,
                          "valid_tokens": tokens, "cycles": cycles,
                          "cycles_a_us": per_us,
                          "us_a_token": ms * 1e3 / tokens,
                          "phases": phases, "counters": acc, "gpu": gpu}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
