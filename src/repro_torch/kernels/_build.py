"""Builds the port's CUDA kernels from the sources in the checkout, once
per process, at first use, into ``build/kernels/`` at the checkout root
(listed in ``.gitignore``).

Every ``kernels/*/csrc/*.cu`` exports a plain C launcher that returns the
launch's ``cudaError_t`` (and ``fold_in.cu`` and ``fused_sweep.cu`` also
the size of their shared memory and scratch, ``fold_in_smem_bytes``,
``fold_in_scratch_bytes``, ``fused_sweep_smem_bytes``,
``fused_sweep_scratch_bytes`` and ``fused_sweep_placement``).  The route is
``torch.utils.cpp_extension.load`` over those sources plus
``csrc/bindings.cpp``, a pybind11 module that passes pointers as
integers and so includes none of PyTorch's headers, which keeps the build
short.  Where ``ninja`` is missing, ``load`` cannot
run, and ``nvcc`` builds the same sources into a shared library that
``ctypes`` loads, one ``nvcc`` per source, all started together.  Both
are compiled for ``sm_90a``.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
import subprocess

_KERNELS = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                  ctypes.c_float)
# C signatures of the exported functions (each returns an int), for the
# ctypes route.
_LAUNCHERS = {
    "fold_in_launch": [_P] * 7 + [_F] + [_I] * 5 + [_P],
    "fold_in_smem_bytes": [_I] * 2,
    "fold_in_scratch_bytes": [_I] * 2,
    "fused_sweep_launch": [_P] * 15 + [_I] * 16 + [_F] * 3 + [_P],
    "fused_sweep_smem_bytes": [_I] * 4,
    "fused_sweep_scratch_bytes": [_I] * 4,
    "fused_sweep_placement": [_I] * 4,
    "lda_scores_launch": [_P] * 11 + [_I, _L, _I] + [_F] * 3 + [_I, _P],
    "ftree_sample_launch": [_P, _P, _P, _L, _I, _P],
    "ftree_update_launch": [_P, _P, _P, _P, _I, _I, _P],
}


@functools.cache
def library():
    """The built launchers: an extension module, or a ctypes library."""
    from torch.utils import cpp_extension

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sorted(_KERNELS.glob("*/csrc/*.cu"))]
    if cpp_extension.is_ninja_available():
        return cpp_extension.load(
            name="repro_torch_kernels",
            sources=[str(_KERNELS / "csrc" / "bindings.cpp"), *cu],
            build_directory=str(BUILD_DIR), extra_cflags=["-O2"],
            extra_cuda_cflags=NVCC_FLAGS, verbose=False)
    so = BUILD_DIR / "librepro_torch_kernels.so"
    nvcc = str(pathlib.Path(cpp_extension.CUDA_HOME or "/usr/local/cuda")
               / "bin" / "nvcc")
    objs = [BUILD_DIR / (pathlib.Path(src).parent.parent.name + ".o")
            for src in cu]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xcompiler", "-fPIC",
                               "-c", src, "-o", str(obj)])
             for src, obj in zip(cu, objs)]        # one nvcc per source
    if any([p.wait() != 0 for p in procs]):
        raise RuntimeError("nvcc failed on a kernel source")
    subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(so),
                    *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _LAUNCHERS.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
    return lib


def launch(name: str, *args) -> None:
    """Call launcher ``name`` and raise if the launch was refused (a
    refused launch never runs, and a later synchronize does not say so)."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")
