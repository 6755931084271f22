"""Roofline analysis of the dry-run's reports (``repro/roofline/
analysis.py``), against the H100 (``launch/mesh.HW``):

    compute    = flops_per_device / peak FLOP/s of the report's dtype
                 (67e12 f32 outside the tensor cores, 989e12 bf16 dense)
    memory     = bytes_per_device / HBM rate (3.35e12 B/s)
    collective = collective_bytes_per_device / link rate (50e9 B/s)

The counts are per device (``roofline/hlo_cost.py``).  MODEL_FLOPS =
6·N·D (train) / 2·N·D (inference) with N = *active* params; the ratio
MODEL_FLOPS / (chips · flops_per_device) says how much of the counted
compute is useful (remat'd training legitimately sits below 1).

The fused sweep's bound model (:func:`sweep_work`) lives here too: the
card check (``chip_smoke.py``) bounds its kernels by it and the dry-run's
LDA report is made of it.
"""
from __future__ import annotations

import glob
import json
import math
import os

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch.mesh import HW

__all__ = ["model_flops", "roofline_terms", "load_reports", "build_table",
           "bytes_ops_bound", "sweep_work", "sweep_bound"]

REPORTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "reports",
    "dryrun_torch")


def model_flops(arch: str, shape: str) -> float:
    if arch.startswith("lda"):
        return 0.0
    cfg = get_config(arch)
    spec = INPUT_SHAPES[shape]
    n_active = cfg.active_param_count()
    if spec["kind"] == "train":
        return 6.0 * n_active * spec["global_batch"] * spec["seq_len"]
    if spec["kind"] == "prefill":
        return 2.0 * n_active * spec["global_batch"] * spec["seq_len"]
    return 2.0 * n_active * spec["global_batch"]


def roofline_terms(flops_dev: float, bytes_dev: float,
                   coll_bytes_dev: float, dtype: str = "f32") -> dict:
    """Seconds of each term; the compute term at ``dtype``'s rate."""
    return {
        "compute": flops_dev / HW.peak_flops(dtype),
        "memory": bytes_dev / HW.HBM_BW,
        "collective": coll_bytes_dev / HW.LINK_BW,
    }


def load_reports(reports_dir: str | None = None) -> list[dict]:
    out = []
    for path in sorted(glob.glob(
            os.path.join(reports_dir or REPORTS, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def build_table(reports: list[dict], mesh_filter: str | None = None):
    """Markdown roofline table rows from dry-run reports."""
    rows = []
    for rep in reports:
        if mesh_filter and rep.get("mesh") != mesh_filter:
            continue
        if "skipped" in rep:
            rows.append((rep["arch"], rep["shape"], rep["mesh"], "SKIP",
                         rep["skipped"]))
            continue
        if "error" in rep:
            rows.append((rep["arch"], rep["shape"], rep["mesh"], "ERROR",
                         rep["error"][:80]))
            continue
        t = rep["roofline_seconds"]
        mf = model_flops(rep["arch"], rep["shape"])
        useful = mf / (rep["flops_per_device"] * rep["chips"]) \
            if rep["flops_per_device"] else 0.0
        rows.append((
            rep["arch"], rep["shape"], rep["mesh"], rep["bottleneck"],
            f"compute={t['compute']:.2e} memory={t['memory']:.2e} "
            f"collective={t['collective']:.2e} useful={useful:.2f}"))
    return rows


def bytes_ops_bound(nbytes: float, ops: float) -> tuple:
    """The larger of the bytes over the HBM rate and the f32 operations
    over the f32 rate, in ms, and which one it is."""
    t_bytes = nbytes / HW.HBM_BW * 1e3
    t_ops = ops / HW.PEAK_FLOPS_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def sweep_work(valid: int, bounds: int, slots: int, docs: int, words: int,
               cap: int, sparse: bool, T: int) -> tuple:
    """(bytes, operations) a fused sweep needs, from its data: the token
    stream read once and ``z`` written (24 + 4 B a slot), each touched
    ``n_td`` and ``n_wt`` row read and written once (and the side-table
    rows in sparse mode); per valid token the compaction (T compares, or
    4·cap table ops), products, scan and pick (3·cap) and 2·(log2 T + 1)
    path adds, per boundary 3·T for the rebuild.  A paged sweep needs the
    same: its slab copies are the kernel's way of moving the touched
    rows, and the rows around them that no token touches are not part of
    the work."""
    row = 4 * T
    nbytes = (28 * slots + 2 * row * (docs + words)
              + (2 * 8 * cap * docs if sparse else 0))
    per_token = (4 * cap if sparse else T) + 3 * cap + 2 * (
        int(math.log2(T)) + 1)
    return nbytes, valid * per_token + bounds * 3 * T


def sweep_bound(valid: int, bounds: int, slots: int, docs: int, words: int,
                cap: int, sparse: bool, T: int) -> tuple:
    """The least time for a sweep's work on the card, in ms, and what
    bounds it (:func:`sweep_work`, :func:`bytes_ops_bound`)."""
    return bytes_ops_bound(*sweep_work(valid, bounds, slots, docs, words,
                                       cap, sparse, T))
