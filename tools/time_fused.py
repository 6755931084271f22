#!/usr/bin/env python3
"""Time the fused-sweep kernel of one source tree on one NVIDIA GPU, on
the same inputs whatever the tree, at ``chip_smoke.py``'s width (T = 1024,
W = 132, the NYTimes-shaped corpus).

    python3 tools/time_fused.py [--tree DIR] [--reps N] [--topics T]
                                [--docs N] [--stream-only]

``DIR`` is the root of a checkout of this repository (this one by
default): its package and kernel sources are used, the kernels built into
its own ``build/kernels/``.
The inputs are made by this script's ``chip_smoke.py``, so two trees see
the same ones: the single stream (``_stream_args``: 1,000 and 3,000
word-sorted tokens, about one word switch a token), round 0's ragged
streams cut to 3 and 8 tiles, cell queues cut to 64 and 160 slots a
cell, the three paged forms on those cuts (``_paged_cut``: slabs of 4
rows), and whole rounds 0 and 1 of the ragged layout; each in dense and
sparse r-mode (``r_cap = T``).  Each case runs once untimed, then ``N``
times on fresh copies of its tables, each launch through the tree's
wrapper timed by CUDA events.  One JSON line a case with the runs,
their median and the median over the heaviest stream's valid tokens (µs a
token step).  ``--topics`` sets T (the layout's, α = 50/T; 1024 by
default, 4096 the reference's larger T).  ``--docs`` builds the layout
from the corpus's first N documents, their words numbered densely, as
``chip_smoke.py``'s phase (l) does at large T (the full corpus's n_wt
passes the card there); ``--stream-only`` times the single-stream cases
alone.  To compare trees, run it for each in turns (A, B, B, A) on one
card, one after another.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

_HERE = pathlib.Path(__file__).resolve().parents[1]


def _import(tree: pathlib.Path):
    """``tree``'s package under this checkout's ``chip_smoke`` module."""
    sys.path.insert(0, str(tree / "src"))
    import repro_torch  # noqa: F401
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  _HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)           # repro_torch is tree's already
    return cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(_HERE))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--topics", type=int, default=1024)
    ap.add_argument("--docs", type=int, default=0)
    ap.add_argument("--stream-only", action="store_true")
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    if not torch.cuda.is_available():
        print("time_fused.py needs a CUDA device", file=sys.stderr)
        return 1
    cs = _import(tree)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"tree {tree}; {gpu}")
    cs._build.library()
    corpus = cs.nytimes_corpus(np.random.default_rng(cs.SEED),
                               cs._zipf_cdf())
    if args.docs:
        corpus = cs._first_docs(corpus, args.docs, dense_words=True)
    lay = cs.build_layout(corpus, n_workers=cs.W, T=args.topics,
                          n_blocks=cs.B, layout="ragged")
    T, W, dev = lay.T, lay.W, cs.DEV
    alpha = 50.0 / T
    model = cs.NomadLDA(layout=lay, alpha=alpha, beta=cs.BETA,
                        inner_mode="fused", device=cs.DEV)
    a = model.init_arrays(cs.SEED)
    tables = (a["n_td"].view(-1, T), a["n_wt"].view(-1, T), a["n_t"])
    label = dict(tree=tree.name, T=T, gpu=gpu)

    def run(case: str, toks: dict, n_td, n_wt, n_t, *, r: int, k: int,
            tile: int, I_max: int, J_max: int, beta_bar: float,
            kernel: str, doc_rows: int = 0):
        Wc, C, S = toks["tok_doc"].shape
        u = torch.rand((Wc, S), device=dev,
                       generator=torch.Generator(dev).manual_seed(0))
        paging = {}
        if "dto" in toks:
            paging = dict(dto=toks["dto"], dtile=S // toks["dto"].shape[-1],
                          doc_rows=doc_rows)
        w = torch.arange(Wc, device=dev)
        valid = (toks["tok_valid"][w, (w + r) % C] != 0).sum(1)
        n_valid, heavy = int(valid.sum()), max(int(valid.max()), 1)
        for sparse in (False, True):
            ms = []
            for rep in range(args.reps + 1):
                z, td, wt = toks["z"].clone(), n_td.clone(), n_wt.clone()
                nt = n_t.clone()
                side = {}
                if sparse:
                    tpc, cnt = cs.rbucket.build_side_table(td, T)
                    side = dict(topics=tpc, counts=cnt)
                torch.cuda.synchronize()
                _, t = cs._timed(lambda: cs.fs_mod.sweep_streams_cuda(
                    toks["tok_doc"], toks["tok_wrd"], toks["tok_valid"],
                    toks["tok_bound"], z, u, toks["cot"], td, wt, nt, r=r,
                    k=k, tile=tile, tile_start=0,
                    num_tiles=toks["cot"].shape[-1], I_max=I_max,
                    J_max=J_max, alpha=alpha, beta=cs.BETA,
                    beta_bar=beta_bar, cap=T, kernel=kernel, **side,
                    **paging))
                if rep:
                    ms.append(t)
            print(json.dumps({"case": case, "kernel": kernel,
                              "r_mode": "sparse" if sparse else "dense",
                              "streams": Wc, "slots": S,
                              "valid_tokens": n_valid,
                              "heaviest_valid": heavy,
                              "median_ms": statistics.median(ms),
                              "us_a_step": statistics.median(ms) * 1e3
                              / heavy, "ms": ms, **label}))

    for n in (cs.STREAM_TOKENS, 3 * cs.STREAM_TOKENS):
        s = cs._stream_args(a, lay, np.random.default_rng(n), n)
        toks = {key: x.view(1, 1, n) for key, x in zip(
            ("tok_doc", "tok_wrd", "tok_valid", "tok_bound", "z"), s[:5])}
        toks["cot"] = torch.zeros((1, 1, 1), dtype=torch.int32, device=dev)
        run(f"stream {n} tokens", toks, s[6], s[7], s[8].view(1, T), r=0,
            k=1, tile=n, I_max=s[6].shape[0], J_max=s[7].shape[0],
            beta_bar=cs.BETA * cs.J, kernel="fused_sweep")
    if args.stream_only:
        return 0
    kw = dict(r=0, k=1, I_max=lay.I_max, J_max=lay.J_max,
              beta_bar=model.beta_bar, doc_rows=cs.T4_SLAB_ROWS)
    for tiles, slots in ((cs.ROUND_TILES, cs.CELL_SLOTS), (8, 160)):
        rag = cs._ragged_cut(lay, a, np.zeros(W, np.int64), tiles)
        cells = cs._cells_cut(lay, a, slots)
        one = {key: v[:1] for key, v in rag.items()}
        for name, cut, tile in (
                ("fused_sweep_ragged", rag, lay.tile),
                ("fused_sweep_cells", cells, slots),
                ("fused_sweep_ragged", cs._paged_cut(rag, lay.I_max),
                 lay.tile),
                ("fused_sweep_cells", cs._paged_cut(cells, lay.I_max),
                 slots),
                ("fused_sweep", cs._paged_cut(one, lay.I_max), lay.tile)):
            Wc = cut["tok_doc"].shape[0]
            paged = "paged " if "dto" in cut else ""
            run(f"{paged}{tiles} tiles / {slots} slots", cut,
                tables[0][:Wc * lay.I_max], tables[1],
                tables[2].repeat(Wc, 1), tile=tile, kernel=name, **kw)
    for r in range(2):
        run(f"whole round {r}", {key: a[key] for key in (
            "tok_doc", "tok_wrd", "tok_valid", "tok_bound", "z")} | {
                "cot": a["cell_of_tile"]}, *tables[:2],
            tables[2].expand(W, T).contiguous(), r=r, k=lay.k,
            tile=lay.tile, I_max=lay.I_max, J_max=lay.J_max,
            beta_bar=model.beta_bar, kernel="fused_sweep_ragged")
    return 0


if __name__ == "__main__":
    sys.exit(main())
