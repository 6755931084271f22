"""Nomad sweep exactness matrix of the port (``repro/launch/lda_matrix_check.py``).

Usage:  python -m repro_torch.launch.lda_matrix_check [n_devices]
            [n_sweeps] [full|smoke] [--device DEV]

``n_devices`` is the ring's W: the W workers run in lock step on one
device (CUDA unless ``--device`` says otherwise).  The twin sweeps every
combination of the reference, in its order: ``sync_mode`` ∈ {stoken,
stale, allreduce} × ``inner_mode`` ∈ {scan, fused, vectorized} × ``B`` ×
``ring_mode`` ∈ {barrier, pipelined} × ``layout`` ∈ {dense, ragged} ×
``doc_tile`` ∈ {None, I_max//3, 8}, with the untiled twin of every
grouped layout and the ``r_mode="sparse"`` twin of every exact inner
mode.  After each run it rebuilds the count tables from ``z``.  Five
invariants:

* the global counts equal the rebuild from ``z``;
* ``vs_barrier``: the pipelined ring equals the barrier ring (``z``,
  ``n_wt``, ``n_t``);
* ``vs_dense``: the ragged stream equals the dense cell grid;
* ``vs_untiled``: on a ``doc_tile`` layout, the paged run (fused mode
  pages ``(doc_tile, T)`` slabs of ``n_td`` through shared memory) equals
  the unpaged run of the same layout;
* ``vs_rdense``: the sparse r-bucket run equals the dense one.

``B`` runs {W, 2W, 4W} ungrouped and {W, 4W} on the doc-tile axis.
``smoke`` runs the reference's slice: both layouts, ``doc_tile`` ∈ {None,
3}, fused, pipelined, stoken at B = 2W, with the untiled twin and (on
ungrouped layouts) the sparse twin.  Its ``slab_smem`` entries give each
grouped layout's ``ntd_slab_bytes`` and ``ntd_whole_bytes``, as the
reference's ``slab_vmem`` does, and ``fused_smem_bytes``: the shared
memory one CTA of the paged CUDA build takes for that slab
(``kernels/fused_sweep/fused_sweep.py:fused_sweep_smem_bytes``, read from
the built kernel, so ``null`` where the device is not CUDA).

Prints one JSON report, ``{"combos": [...], "all_exact": bool, ...}``,
and exits non-zero unless ``all_exact``.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

__all__ = ["run_matrix", "main"]

_PAIRS = ("vs_barrier", "vs_dense", "vs_untiled", "vs_rdense")


def _diff(entry: dict, prefix: str, a, b) -> None:
    """Record mismatch counts between two runs' (canonical z, global n_wt,
    n_t) triples under ``{prefix}_{field}_mismatch`` keys."""
    za, wta, ta = a
    zb, wtb, tb = b
    entry[f"{prefix}_z_mismatch"] = int((za != zb).sum())
    entry[f"{prefix}_n_wt_mismatch"] = int(np.abs(wta - wtb).sum())
    entry[f"{prefix}_n_t_mismatch"] = int(
        np.abs(ta.astype(np.int64) - tb.astype(np.int64)).sum())


def _exact(c: dict) -> bool:
    return (c["n_td_mismatch"] == 0 and c["n_wt_mismatch"] == 0
            and c["n_t_mismatch"] == 0 and c["tokens_preserved"]
            and all(c.get(f"{p}_{f}_mismatch", 0) == 0
                    for p in _PAIRS for f in ("z", "n_wt", "n_t")))


def run_matrix(n_dev: int, n_sweeps: int, subset: str = "full", *,
               device=None) -> dict:
    """Run the matrix on ``device`` (``None`` means CUDA) → the report."""
    if subset not in ("full", "smoke"):
        raise ValueError(f"unknown subset {subset!r} (full|smoke)")
    from repro_torch._device import resolve
    from repro_torch.core.nomad import NomadLDA
    from repro_torch.data import synthetic
    from repro_torch.data.sharding import build_layout, counts_from_layout
    from repro_torch.kernels.fused_sweep.fused_sweep import (
        fused_sweep_smem_bytes)

    dev = resolve(device)
    T = 8
    alpha, beta = 50.0 / T, 0.01
    smoke = subset == "smoke"
    corpus, _, _ = synthetic.make_corpus(
        num_docs=32 if smoke else 64, vocab_size=96, num_topics=T,
        mean_doc_len=12.0, seed=5)

    def run(layout, sync_mode, inner_mode, ring_mode, doc_page,
            r_mode="dense"):
        lda = NomadLDA(layout=layout, alpha=alpha, beta=beta,
                       sync_mode=sync_mode, inner_mode=inner_mode,
                       ring_mode=ring_mode, doc_tile=doc_page,
                       r_mode=r_mode, device=dev)
        arrays = lda.init_arrays(seed=0)
        for it in range(n_sweeps):
            arrays = lda.sweep(arrays, seed=it)
        n_td, n_wt, n_t = lda.global_counts(arrays)
        z = arrays["z"].cpu().numpy()
        td_ref, wt_ref, t_ref = counts_from_layout(layout, z, T)
        entry = {
            "B": layout.B, "k": layout.k, "layout": layout.kind,
            "doc_tile": layout.doc_tile or None,
            "paged": doc_page is not None,
            "sync_mode": sync_mode,
            "inner_mode": inner_mode,
            "ring_mode": ring_mode,
            "r_mode": r_mode,
            "pad_fraction": layout.pad_fraction,
            "n_td_mismatch": int(np.abs(n_td - td_ref).sum()),
            "n_wt_mismatch": int(np.abs(n_wt - wt_ref).sum()),
            "n_t_mismatch": int(np.abs(n_t - t_ref).sum()),
            "tokens_preserved":
                int(n_t.sum()) == int(corpus.num_tokens),
        }
        return entry, (layout.extract_canonical(z), n_wt, n_t)

    def layouts_for(b_mult, dt):
        kw = dict(doc_tile=dt) if dt else {}
        dense = build_layout(corpus, n_workers=n_dev, T=T,
                             n_blocks=b_mult * n_dev,
                             **(dict(kw, doc_blk=16) if dt else {}))
        ragged = build_layout(corpus, n_workers=n_dev, T=T,
                              n_blocks=b_mult * n_dev, layout="ragged",
                              **kw)
        return {"dense": dense, "ragged": ragged}

    combos = []
    if smoke:
        cases = [(2, dt) for dt in (None, 3)]
        sync_modes, inner_modes = ("stoken",), ("fused",)
        ring_modes = ("pipelined",)
    else:
        cases = [(m, None) for m in (1, 2, 4)]
        i_max = layouts_for(1, None)["dense"].I_max
        for dt in (max(i_max // 3, 1), 8):
            cases += [(m, dt) for m in (1, 4)]
        sync_modes = ("stoken", "stale", "allreduce")
        inner_modes = ("scan", "fused", "vectorized")
        ring_modes = ("barrier", "pipelined")

    slab_report = []
    for b_mult, dt in cases:
        layouts = layouts_for(b_mult, dt)
        if dt:
            for kind, lay in layouts.items():
                slab_report.append({
                    "B": lay.B, "layout": kind, "doc_tile": dt,
                    "ntd_slab_bytes": lay.ntd_slab_bytes,
                    "ntd_whole_bytes": lay.ntd_whole_bytes,
                    "fused_smem_bytes": (
                        fused_sweep_smem_bytes(T, T, doc_rows=dt)
                        if dev.type == "cuda" else None),
                })
        for sync_mode in sync_modes:
            for inner_mode in inner_modes:
                per_run = {}
                for kind in ("dense", "ragged"):
                    layout = layouts[kind]
                    if dt:
                        # the untiled twin: the same grouped layout with
                        # the whole shard resident
                        _, per_run[kind, "untiled"] = run(
                            layout, sync_mode, inner_mode, "barrier", None)
                    for ring_mode in ring_modes:
                        entry, res = run(layout, sync_mode, inner_mode,
                                         ring_mode, dt if dt else None)
                        per_run[kind, ring_mode] = res
                        combos.append(entry)
                        if ring_mode == "pipelined" and \
                                "barrier" in ring_modes:
                            _diff(entry, "vs_barrier",
                                  per_run[kind, "barrier"],
                                  per_run[kind, "pipelined"])
                        if kind == "ragged":
                            _diff(entry, "vs_dense",
                                  per_run["dense", ring_mode],
                                  per_run["ragged", ring_mode])
                        if dt:
                            _diff(entry, "vs_untiled",
                                  per_run[kind, "untiled"],
                                  per_run[kind, ring_mode])
                        if inner_mode != "vectorized" and \
                                not (smoke and dt):
                            sentry, sres = run(
                                layout, sync_mode, inner_mode, ring_mode,
                                dt if dt else None, r_mode="sparse")
                            combos.append(sentry)
                            _diff(sentry, "vs_rdense",
                                  per_run[kind, ring_mode], sres)

    return {"n_devices": n_dev, "n_sweeps": n_sweeps, "subset": subset,
            "device": str(dev), "combos": combos, "slab_smem": slab_report,
            "all_exact": all(_exact(c) for c in combos)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_devices", nargs="?", type=int, default=8,
                   help="the ring's W (lock-step workers on one device)")
    p.add_argument("n_sweeps", nargs="?", type=int, default=2)
    p.add_argument("subset", nargs="?", default="full",
                   choices=["full", "smoke"])
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    report = run_matrix(args.n_devices, args.n_sweeps, args.subset,
                        device=args.device)
    print(json.dumps(report))
    return 0 if report["all_exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
