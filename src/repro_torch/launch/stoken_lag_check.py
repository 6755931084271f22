"""s-token staleness check (``repro/launch/stoken_lag_check.py``).

    python -m repro_torch.launch.stoken_lag_check --device cpu \\
        [--workers 8] [--inner-mode fused] [--n-blocks 16]

``sync_mode="stoken"`` lets every worker sample against a stale copy of
the global topic counts (the paper's Alg. 4); the copy is refreshed every
``W`` rounds, and what it knows of any other worker is at most ``W−1``
ring rounds old when it is received (DESIGN.md §4).

One sweep runs with ``NomadLDA(collect_lag=True)``, which records for
each round and worker ``n_t_local`` after the round's sync and the
cumulative ``delta_mine``, for both ring modes × both layouts, and
:func:`lag_report` checks in numpy:

* **the fold schedule, exactly.**  The s token visits workers in ring
  order (the holder in round ``ρ`` is ``(−ρ) mod W``), so worker ``w``'s
  copy after round ``r`` equals ``n_t0 + delta_mine[r, w] + Σ_{w'≠w}
  delta_mine[ρ'', w']`` with ``ρ'' = r_h − ((w'−w) mod W)`` and ``r_h``
  the worker's last hold round (terms with ``ρ'' < 0`` drop);
* **the staleness bound.**  The L1 gap between the copy and the exact
  counts is at most twice the tokens of the cell sweeps the copy has not
  seen, counted from the schedule and ``layout.cell_sizes``; the unseen
  window is ≤ ``W−1`` rounds at a fold and ≤ ``2(W−1)`` between folds;
* **ring-mode and layout equivalence.**  The pipelined ring's trace equals
  the barrier ring's, the ragged layout's the dense one's.

Prints one JSON report as the last stdout line; exits non-zero unless
every check passes.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def lag_report(lag, n_t0, cell_sizes, k: int) -> dict:
    """The fold-schedule and staleness checks on one sweep's ``(W, W, 2,
    T)`` lag trace (rounds, workers, [n_t_local, delta_mine], topics),
    the sweep's starting ``n_t0`` and the layout's ``(W, B)``
    ``cell_sizes`` with ``k = B / W`` blocks a chunk."""
    lag = np.asarray(lag).astype(np.int64)
    n_t0 = np.asarray(n_t0).astype(np.int64)
    R, W = lag.shape[:2]
    if R != W:
        raise ValueError(f"a sweep's trace has W rounds; got {lag.shape}")
    local, delta = lag[:, :, 0], lag[:, :, 1]
    exact = n_t0 + delta.sum(axis=1)                        # (R, T)
    ws = np.arange(W)
    # rounds r < W: a worker's last hold is its first, (−w) mod W
    r_h = (-ws) % W                                         # (W,)
    held = np.arange(R)[:, None] >= r_h[None, :]            # (R, W)
    dist = (ws[None, :] - ws[:, None]) % W                  # (w, w')
    other = dist > 0
    rho = r_h[:, None] - dist                               # (w, w')
    seen = other & (rho >= 0)
    # what worker w's copy holds of the others once it has held the token
    S = np.where(seen[:, :, None],
                 delta[np.clip(rho, 0, None), ws[None, :]], 0).sum(axis=1)
    expected = n_t0 + delta + held[:, :, None] * S[None]
    fold_schedule_exact = bool((local == expected).all())

    # tokens of worker w' in round ρ, and their prefix sums over ρ
    chunk = np.asarray(cell_sizes).reshape(W, W, k).sum(axis=2)
    rt = np.take_along_axis(chunk, (ws[:, None] + np.arange(R)) % W, axis=1)
    cum = np.concatenate([np.zeros((W, 1), np.int64),
                          np.cumsum(rt, axis=1)], axis=1)    # (W, R + 1)
    lo = np.where(held[:, :, None], np.maximum(rho + 1, 0)[None], 0)
    r_idx = np.arange(R)[:, None, None]
    window = np.where(other[None], r_idx - lo + 1, 0)        # (R, w, w')
    missing = np.where(other[None],
                       cum[ws[None, None, :], r_idx + 1]
                       - cum[ws[None, None, :], lo], 0).sum(axis=2)
    at_fold = held & (np.arange(R)[:, None] == r_h[None, :])
    lag_l1 = np.abs(local - exact[:, None]).sum(axis=2)     # (R, W)
    bound = 2 * missing            # one token move: ±1 at two topics
    fold_window_max = int(window[at_fold].max(initial=0))
    window_max = int(window.max())
    return {
        "fold_schedule_exact": fold_schedule_exact,
        "lag_within_bound": bool((lag_l1 <= bound).all()),
        "lag_nonzero": bool((lag_l1 > 0).any()),
        "lag_max_l1": int(lag_l1.max()),
        "bound_max_l1": int(bound.max()),
        # unseen windows, in rounds per source worker (k cells each)
        "fold_window_rounds_max": fold_window_max,
        "fold_window_rounds_bound": W - 1,
        "window_rounds_max": window_max,
        "window_rounds_bound": 2 * (W - 1),
        "documented_bound_ok": (fold_window_max <= W - 1
                                and window_max <= 2 * (W - 1)),
    }


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--inner-mode", default="fused",
                   choices=["scan", "fused", "vectorized"])
    p.add_argument("--n-blocks", type=int, default=0, help="0 → 2·workers")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA)")
    return p.parse_args(argv)


def run_check(args) -> dict:
    from repro_torch.core.nomad import NomadLDA
    from repro_torch.data import synthetic
    from repro_torch.data.sharding import build_layout

    T, W = 16, args.workers
    corpus, _, _ = synthetic.make_corpus(
        num_docs=120, vocab_size=256, num_topics=T, mean_doc_len=30.0, seed=3)
    traces = {}
    for kind in ("dense", "ragged"):
        layout = build_layout(corpus, n_workers=W, T=T,
                              n_blocks=args.n_blocks or 2 * W, layout=kind)
        for ring_mode in ("barrier", "pipelined"):
            lda = NomadLDA(layout=layout, alpha=50.0 / T, beta=0.01,
                           sync_mode="stoken", inner_mode=args.inner_mode,
                           ring_mode=ring_mode, collect_lag=True,
                           device=args.device)
            arrays = lda.init_arrays(seed=0)
            n_t0 = arrays["n_t"].cpu().numpy()
            traces[kind, ring_mode] = lda.sweep(arrays, seed=0)["lag"].cpu(
                ).numpy()
    same = lambda a, b: bool(np.array_equal(traces[a], traces[b]))
    report = {"workers": W, "inner_mode": args.inner_mode,
              "n_blocks": layout.B, "k": layout.k,
              "ring_modes_identical": same(("dense", "barrier"),
                                           ("dense", "pipelined")),
              "layout_modes_identical": all(
                  same(("dense", rm), ("ragged", rm))
                  for rm in ("barrier", "pipelined"))}
    report.update(lag_report(traces["dense", "barrier"], n_t0,
                             layout.cell_sizes, layout.k))
    report["all_ok"] = all(report[k] for k in (
        "ring_modes_identical", "layout_modes_identical",
        "fold_schedule_exact", "lag_within_bound", "lag_nonzero",
        "documented_bound_ok"))
    return report


def main(argv=None) -> None:
    report = run_check(_parse(sys.argv[1:] if argv is None else argv))
    print(json.dumps(report))
    if not report["all_ok"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
