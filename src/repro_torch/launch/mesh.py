"""The production meshes of the dry-run, and the card's constants that
the roofline divides by (``repro/launch/mesh.py``).

The reference fakes 512 XLA host devices; here a *fake* process group
of n ranks stands in for them (:func:`fake_world`).  It moves no data:
the dry-run runs rank 0's share of a step on shape-only tensors, and
every collective it makes is recorded, not performed.

Meshes: one pod is 16×16 = 256 devices (``("data", "model")``), two
pods 2×16×16 = 512 (``("pod", "data", "model")``); the LDA ring is flat,
(256,) ``("worker",)`` or (2, 256) ``("pod", "worker")``.

Functions, not module-level objects: importing this module creates no
process group.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["HW", "fake_world", "make_production_mesh", "make_lda_mesh"]


class HW:
    """NVIDIA H100 80GB HBM3 (SXM), at its full 700 W power limit.  NVIDIA's
    data sheet, dense rates without sparsity."""
    CARD = "NVIDIA H100 80GB HBM3"
    POWER_LIMIT_W = 700
    #: f32 FLOP/s outside the tensor cores (data sheet "FP32"); the zoo
    #: runs f32 with TF32 off, so this is the rate of its products.
    PEAK_FLOPS_F32 = 67e12
    #: dense bf16 FLOP/s on the tensor cores (data sheet "BF16 Tensor Core",
    #: 1,979e12 with sparsity).
    PEAK_FLOPS_BF16 = 989e12
    #: HBM3 bytes/s (data sheet "GPU memory bandwidth").
    HBM_BW = 3.35e12
    #: HBM bytes (data sheet "GPU memory": 80 GB).
    HBM_BYTES = 80e9
    #: bytes/s a GPU for the collective term: one 400 Gb/s InfiniBand NIC
    #: a GPU (the DGX H100's ConnectX-7 ports), since a 16-way model axis
    #: spans two 8-GPU nodes.  Within a node NVLink 4 gives 450e9 B/s a
    #: direction (900e9 both ways); the slowest hop sets the term.
    LINK_BW = 50e9

    @classmethod
    def peak_flops(cls, dtype: str) -> float:
        """The compute term's rate for a report made in ``dtype``
        (``"f32"`` or ``"bf16"``)."""
        return {"f32": cls.PEAK_FLOPS_F32, "bf16": cls.PEAK_FLOPS_BF16}[dtype]


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks, this process rank 0, for the
    length of the ``with``; destroyed on exit, also on an exception."""
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "dry-run needs its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape: tuple, axes: tuple, device_type: str) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"mesh {shape} needs a world of {n} ranks, have "
                           f"{have} (open one with fake_world({n}))")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_lda_mesh(*, multi_pod: bool = False,
                  device_type: str = "cuda") -> DeviceMesh:
    """The flat worker ring of Nomad LDA (DESIGN.md §4); the pod axis is
    kept so the ring's cross-pod hop stays explicit."""
    if multi_pod:
        return _mesh((2, 256), ("pod", "worker"), device_type)
    return _mesh((256,), ("worker",), device_type)
