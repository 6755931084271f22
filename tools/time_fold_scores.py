#!/usr/bin/env python3
"""Time the fold-in and ``lda_scores`` kernels of one source tree on one
NVIDIA GPU, on the same inputs whatever the tree, at ``chip_smoke.py``'s
width (J = 102,660 words, the NYTimes-shaped corpus).

    python3 tools/time_fold_scores.py [--tree DIR] [--reps N] [--probes]
                                      [--only fold_in|lda_scores] [--ptxas]

``DIR`` is the root of a checkout of this repository (this one by
default): its package and kernel sources are used, the kernels built into
its own ``build/kernels/``.  The inputs are made by this script's
``chip_smoke.py``, so two trees see the same ones:

* the fold-in kernel (``_fold_batch``, 20 sweeps, a random φ of J rows
  from a seeded generator) on 64 documents of L = 512 at T = 1024, on one
  full document of L = 4096 (the serving path's bucket of its 4,000-token
  outlier) at T = 1024, on 64 × 512 at T = 4096, 16,384 and 1000 (not a
  multiple of 256), at T = 1024 with φ not 16-byte aligned, on 8 × 128
  at T = 65,536 (the deep layout), and on one full document of L =
  65,536 at T = 1024 and of L = 16,384 at T = 4096 (the long placement:
  the per-token arrays in device memory);
* the ``lda_scores`` pass form on what the vectorized trainer's first
  two launches get (``_pass_inputs``: round 0, cells 0 and 1, from the
  initial arrays of the smoke's ragged layout), and the rows form on
  65,536 of those tokens (``_rows_inputs``).

Each case runs once untimed, then ``N`` times, each launch through the
tree's wrapper timed by CUDA events.  One JSON line a case with the runs,
their median, µs a step of the longest document (fold-in) or µs a token
(``lda_scores``), and a checksum of the output, which two trees must
share, or the error of a launch the tree's wrapper or kernel refuses.
With ``--ptxas`` it first compiles the tree's ``fold_in.cu`` alone with
``nvcc -Xptxas -v`` and prints, for each instantiation of its kernel, the
registers, spills and (by ``cuobjdump -sass``) the non-coherent global
loads (``LDG...CONSTANT``, the read-only path).  With
``--probes`` it also builds the tree's ``fold_in.cu`` with
``-DSTEP_PROBES`` (the kernel's ``PHASE`` probes, empty otherwise) into
``DIR/build/probes/`` and prints the phases of the longest document's
step at T = 1024 and 4096 and of the long placement's (L = 65,536 at T
= 1024, 16,384 at 4096): cycles and µs a step, the cycles turned into
time at that CTA's cycles over the launch's time.  ``--only`` times one
kernel's cases and skips the other's.  To compare trees, run
it for each in turns (A, B, B, A) on one card, one after another.  Exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

_HERE = pathlib.Path(__file__).resolve().parents[1]
# The fold-in kernel's probe counters (fold_in.cu, kProbe*): phases 0 .. 4,
# then steps and the total.
_PHASES = ["ring wait", "level 0", "upper levels", "counts", "update"]
_STEPS, _TOTAL = 8, 10
#: (label, T, D, L, φ 16-byte aligned) of each fold-in case.
_FOLD_CASES = (("64 x 512", 1024, 64, 512, True),
               ("one doc, L=4096", 1024, 1, 4096, True),
               ("64 x 512", 4096, 64, 512, True),
               ("64 x 512", 16384, 64, 512, True),
               ("64 x 512", 1000, 64, 512, True),
               ("64 x 512, phi unaligned", 1024, 64, 512, False),
               ("8 x 128, deep", 65536, 8, 128, True),
               ("one doc, L=65536, long", 1024, 1, 65536, True),
               ("one doc, L=16384, long", 4096, 1, 16384, True))


def _import(tree: pathlib.Path):
    """``tree``'s package under this checkout's ``chip_smoke`` module."""
    sys.path.insert(0, str(tree / "src"))
    import repro_torch  # noqa: F401
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  _HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)           # repro_torch is tree's already
    return cs


def _runs(fn, reps: int):
    """``fn``'s output and its device time in ms, ``reps`` runs after one
    untimed, each by CUDA events."""
    out = fn()
    ms = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return out, ms


def _checksum(x: torch.Tensor) -> int:
    w = torch.arange(1, x.shape[-1] + 1, device=x.device)
    return int((x.long() * w).sum())


def _probed(tree: pathlib.Path, argtypes: list):
    """``tree``'s fold-in kernel built with ``-DSTEP_PROBES``."""
    from torch.utils import cpp_extension
    cu = tree / "src/repro_torch/kernels/fold_in/csrc/fold_in.cu"
    out = tree / "build/probes"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libfold_in_probed.so"
    nvcc = str(pathlib.Path(cpp_extension.CUDA_HOME or "/usr/local/cuda")
               / "bin" / "nvcc")
    subprocess.run([nvcc, "-O3", "-std=c++17",
                    "-gencode=arch=compute_90a,code=sm_90a", "-DSTEP_PROBES",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(so),
                    str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    for name, types in (("fold_in_launch", argtypes),
                        ("step_probe", [ctypes.c_int, ctypes.c_void_p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, types
    return lib


def _ptxas(tree: pathlib.Path) -> None:
    """Registers, spills and non-coherent loads of each instantiation of
    ``tree``'s fold-in kernel, one JSON line each."""
    from torch.utils import cpp_extension
    cu = tree / "src/repro_torch/kernels/fold_in/csrc/fold_in.cu"
    out = tree / "build/ptxas"
    out.mkdir(parents=True, exist_ok=True)
    cubin = out / "fold_in.cubin"
    bin_dir = pathlib.Path(cpp_extension.CUDA_HOME or "/usr/local/cuda") \
        / "bin"
    log = subprocess.run(
        [str(bin_dir / "nvcc"), "-O3", "-std=c++17",
         "-gencode=arch=compute_90a,code=sm_90a", "-Xptxas=-v", "-cubin",
         "-o", str(cubin), str(cu)], capture_output=True, text=True,
        check=True).stderr
    sass = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    nc, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            nc[name] = 0
        elif name and "LDG" in line and "CONSTANT" in line:
            nc[name] += 1
    name, spills = None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "registers" in line:
            if "fold_in_kernelI" in name:
                # fold_in_kernel's template bits: kWide, kDeep, kHuge(, kLong)
                bits = name.split("fold_in_kernelI")[1].split("EEEv")[0]
                print(json.dumps({
                    "ptxas": "fold_in_kernel", "tree": tree.name,
                    "template": bits.replace("ELb", ",").replace("Lb", ""),
                    "registers": int(line.split("Used ")[1].split()[0]),
                    "spills": spills, "nc_loads": nc.get(name)}))
            name = None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(_HERE))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--only", choices=("fold_in", "lda_scores"))
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    if not torch.cuda.is_available():
        print("time_fold_scores.py needs a CUDA device", file=sys.stderr)
        return 1
    if args.ptxas:
        _ptxas(tree)
    cs = _import(tree)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"tree {tree}; {gpu}")
    cs._build.library()
    dev, label = cs.DEV, dict(tree=tree.name, gpu=gpu)
    cdf = cs._zipf_cdf()

    def fold_case(T: int, D: int, L: int, aligned: bool = True):
        flat = torch.rand((cs.J * T + 1,), device=dev,
                          generator=torch.Generator(dev).manual_seed(T))
        phi = (flat[:-1] if aligned else flat[1:]).view(cs.J, T)
        b = cs._fold_batch(phi, cdf, np.random.default_rng(T + L), D, L)
        fn = lambda: cs.fold_in_mod.fold_in_cuda(  # noqa: E731
            b["w"], b["v"], b["z0"], b["u_flat"], cs.ALPHA, phi)
        return fn, int(b["lens"].max()) * cs.SWEEPS

    for name, T, D, L, aligned in _FOLD_CASES:
        if args.only == "lda_scores":
            break
        fn, steps = fold_case(T, D, L, aligned)
        case = {"case": f"fold_in {name}", "T": T, "D": D, "L": L,
                "sweeps": cs.SWEEPS, "longest_steps": steps}
        try:
            out, ms = _runs(fn, args.reps)
        except (RuntimeError, ValueError) as err:   # a launch the tree
            # refuses (ValueError: its wrapper's check_fits)
            print(json.dumps({**case, "error": str(err), **label}))
            continue
        finally:
            del fn
            torch.cuda.empty_cache()
        med = statistics.median(ms)
        print(json.dumps({**case, "median_ms": med,
                          "us_a_step": med * 1e3 / steps, "ms": ms,
                          "checksum": _checksum(out), **label}))

    if args.only != "fold_in":
        corpus = cs.nytimes_corpus(np.random.default_rng(cs.SEED), cdf)
        lay = cs.build_layout(corpus, n_workers=cs.W, T=cs.T, n_blocks=cs.B,
                              layout="ragged")
        model = cs.NomadLDA(layout=lay, alpha=cs.ALPHA, beta=cs.BETA,
                            inner_mode="vectorized", device=dev)
        a = model.init_arrays(cs.SEED)
        T = lay.T
        tabs = (a["n_td"].view(-1, T), a["n_wt"].view(-1, T),
                a["n_t"].expand(cs.W, T).contiguous())
        kw = dict(alpha=cs.ALPHA, beta=cs.BETA, beta_bar=model.beta_bar)
        cases = []
        for cell in (0, 1):
            rows, z, u = cs._pass_inputs(model, a, cell)
            cases.append((f"lda_scores pass, round 0, cell {cell}",
                          z.numel(), lambda rows=rows, z=z, u=u: cs.ls_mod
                          .lda_scores_pass_cuda(*rows, z, u, *tabs, **kw)))
        ntd, nwt, n_t, u = cs._rows_inputs(
            lay, a, torch.Generator(dev).manual_seed(cs.SEED))
        cases.append(("lda_scores rows", ntd.shape[0], lambda: cs.ls_mod
                      .lda_scores_cuda(ntd, nwt, n_t, u, **kw)[0]))
        for name, n, fn in cases:
            out, ms = _runs(fn, args.reps)
            med = statistics.median(ms)
            print(json.dumps({"case": name, "T": T, "tokens": n,
                              "median_ms": med, "us_a_token": med * 1e3 / n,
                              "ms": ms, "checksum": _checksum(out[None]),
                              **label}))

    if args.probes:
        lib = _probed(tree, cs._build._LAUNCHERS["fold_in_launch"])
        cs._build.library = lambda: lib          # the wrapper's calls go here
        host = (ctypes.c_ulonglong * 16)()
        for name, T, D, L, _ in _FOLD_CASES[:3:2] + _FOLD_CASES[-2:]:
            fn, _ = fold_case(T, D, L)
            if lib.step_probe(0, None) != 0:     # document 0 is full
                raise RuntimeError("step_probe failed")
            _, ms = _runs(fn, 1)
            if lib.step_probe(0, ctypes.addressof(host)) != 0:
                raise RuntimeError("step_probe failed")
            acc = list(host)
            steps, cycles = acc[_STEPS], acc[_TOTAL]
            per_us = cycles / (ms[0] * 1e3)             # cycles a µs
            phases = {p: {"cycles_a_step": acc[i] / steps,
                          "us_a_step": acc[i] / steps / per_us,
                          "share": acc[i] / cycles}
                      for i, p in enumerate(_PHASES)}
            print(json.dumps({"probes": f"fold_in {name}", "T": T,
                              "kernel_ms": ms[0], "steps": steps,
                              "cycles": cycles, "cycles_a_us": per_us,
                              "us_a_step": ms[0] * 1e3 / steps,
                              "phases": phases, "counters": acc, **label}))
            del fn
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
