"""Chaos harness (``repro/launch/chaos_check.py``): the failure model of
DESIGN.md §11 replayed from a seeded :class:`repro_torch.fault.FaultPlan`.

Trainer story (extends ``resume_check``): run the ring with a rotating
checkpoint directory while the fault injector corrupts the newest slot
and then kills the process (``os._exit(137)``, the real preemption); the
resume must fall back to the previous valid slot and the finished chain's
digest must equal an uninterrupted run's.  Phases::

    --phase straight   run ``--sweeps`` uninterrupted, print chain digest
    --phase train      checkpoint every sweep into ``--ckpt`` (a rotation
                       directory), corrupt the slot written at sweep
                       ``--kill-at`` (``--corrupt-newest``), then die hard
    --phase resume     resume from the newest valid slot, run to
                       ``--sweeps``, print chain digest + fallback story
    --phase matrix     the same comparison in process across damage kinds
                       {none, corrupt, truncate}, soft kills
    --phase recovery   timed: the uninterrupted run against the whole
                       kill + corrupt-newest-slot + fallback-resume path,
                       back to back in one process

Serving story (``--phase serve``): a publisher thread feeds an
:class:`~repro_torch.serve.lda_engine.LdaEngine` a scripted mix of good,
corrupt, stale-generation and format-skewed snapshots while reader
threads flood it with queries behind admission control.  The audit: every
answer folded against an accepted ``(generation, digest)``, every bad
publish refused with the right typed error, overload shed rather than
queued (``max_pending_seen`` ≤ the bound, shed > 0, degraded > 0), the
accepted queries' p99 within ``--p99-ratio`` × their median, and
transient fetch failures retried through :func:`fetch_snapshot`'s
backoff.

    python -m repro_torch.launch.chaos_check --device cpu --phase matrix

Prints a JSON report as the last stdout line; exits non-zero unless every
check passes.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

from repro_torch.launch.resume_check import _build, chain_digest


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phase", default="matrix",
                   choices=["straight", "train", "resume", "matrix",
                            "recovery", "serve"])
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--sync-mode", default="stoken")
    p.add_argument("--inner-mode", default="fused",
                   choices=["scan", "fused", "vectorized"])
    p.add_argument("--n-blocks", type=int, default=0, help="0 → workers")
    p.add_argument("--ring-mode", default="barrier")
    p.add_argument("--layout", default="dense", choices=["dense", "ragged"])
    p.add_argument("--doc-tile", type=int, default=0)
    p.add_argument("--r-mode", default="dense", choices=["dense", "sparse"])
    p.add_argument("--sweeps", type=int, default=5)
    p.add_argument("--kill-at", type=int, default=3,
                   help="train phase: die after this many sweeps")
    p.add_argument("--ckpt", default="",
                   help="rotation directory (train/resume phases)")
    p.add_argument("--keep", type=int, default=3,
                   help="rotation slots kept")
    p.add_argument("--corrupt-newest", action="store_true",
                   help="train phase: corrupt the newest slot before dying")
    p.add_argument("--fault-seed", type=int, default=0)
    p.add_argument("--fast", action="store_true",
                   help="serve/matrix: smaller schedule")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA)")
    # serve-phase knobs
    p.add_argument("--flood-threads", type=int, default=8)
    p.add_argument("--flood-queries", type=int, default=20,
                   help="queries per flood thread")
    p.add_argument("--max-pending", type=int, default=2)
    p.add_argument("--degrade-pending", type=int, default=1)
    p.add_argument("--p99-ratio", type=float, default=80.0,
                   help="serve: the accepted queries' p99 may be at most "
                        "this many times their median")
    return p.parse_args(argv)


def _trainer_plan(args):
    """The seeded trainer fault schedule: corrupt the slot written at
    sweep ``kill_at`` (``chain.write`` fires once a checkpoint, so with
    ``checkpoint_every=1`` the write index is the sweep index), then a
    hard kill."""
    from repro_torch.fault import FaultPlan, FaultSpec
    specs = [FaultSpec("kill", "trainer.sweep", at=args.kill_at - 1,
                       hard=True)]
    if args.corrupt_newest:
        specs.insert(0, FaultSpec("corrupt", "chain.write",
                                  at=args.kill_at - 1, nbytes=4))
    return FaultPlan(specs, seed=args.fault_seed)


def _kw(args) -> dict:
    return dict(layout_kind=args.layout, ring_mode=args.ring_mode,
                r_mode=args.r_mode)


# ---------------------------------------------------------------------------
# Trainer phases (kill + corruption → rotation fallback → bit-exact)
# ---------------------------------------------------------------------------
def _run_straight(args) -> dict:
    lda = _build(args, **_kw(args))
    arrays, done = lda.run(args.sweeps, init_seed=0)
    return {"phase": "straight", "sweeps": done,
            "digest": chain_digest(lda, arrays)}


def _run_train(args) -> dict:
    lda = _build(args, ckpt_every=1, ckpt_path=args.ckpt, **_kw(args))
    lda.checkpoint_keep = args.keep
    # hard kill: this call never returns past sweep kill_at - 1
    lda.run(args.sweeps, init_seed=0, fault_plan=_trainer_plan(args))
    return {"phase": "train", "error": "plan did not kill the run",
            "all_ok": False}


def _resume_from(args, ckpt: str) -> dict:
    """Resume a rotation directory to ``--sweeps``: the digest and the
    fallback story."""
    from repro_torch.train.checkpoint import CheckpointRotation
    rot = CheckpointRotation(ckpt, keep=args.keep)
    slots = [s for s, _ in rot.slots()]
    _, _, chosen = rot.load_latest_valid()
    lda = _build(args, resume_from=ckpt, **_kw(args))
    lda.checkpoint_keep = args.keep
    arrays, done = lda.run(args.sweeps)
    return {"sweeps": done, "digest": chain_digest(lda, arrays),
            "slots": slots, "last_good": rot.last_good(),
            "resumed_from_step": chosen, "fell_back": chosen < max(slots)}


def _run_resume(args) -> dict:
    return {"phase": "resume", **_resume_from(args, args.ckpt)}


def _soft_kill_run(args, ckpt: str, damage: str):
    """Train into ``ckpt`` under a plan that damages the slot written at
    ``--kill-at`` (``damage``: none, corrupt, truncate) and then kills
    the run by exception → ``(killed, plan)``."""
    from repro_torch.fault import FaultPlan, FaultSpec, InjectedKill
    specs = [FaultSpec("kill", "trainer.sweep", at=args.kill_at - 1)]
    if damage == "corrupt":
        specs.insert(0, FaultSpec("corrupt", "chain.write",
                                  at=args.kill_at - 1, nbytes=4))
    elif damage == "truncate":
        specs.insert(0, FaultSpec("truncate", "chain.write",
                                  at=args.kill_at - 1, frac=0.5))
    plan = FaultPlan(specs, seed=args.fault_seed)
    lda = _build(args, ckpt_every=1, ckpt_path=ckpt, **_kw(args))
    lda.checkpoint_keep = args.keep
    try:
        lda.run(args.sweeps, init_seed=0, fault_plan=plan)
    except InjectedKill:
        return True, plan
    return False, plan


def _run_matrix(args) -> dict:
    """In-process kill + damage → fallback resume → bit-exact, across
    damage kinds.  Soft kills (``InjectedKill``) stand in for the process
    phases' SIGKILL; the checkpoint state on disk is the same."""
    ref = _run_straight(args)["digest"]
    damages = (("none", "corrupt") if args.fast
               else ("none", "corrupt", "truncate"))
    combos, ok = [], True
    for damage in damages:
        tmpd = tempfile.mkdtemp(prefix=f"chaos-{damage}-")
        try:
            killed, plan = _soft_kill_run(args, tmpd, damage)
            res = _resume_from(args, tmpd)
        finally:
            shutil.rmtree(tmpd, ignore_errors=True)
        combo_ok = (killed and res["digest"] == ref
                    and res["fell_back"] == (damage != "none"))
        ok &= combo_ok
        combos.append({"damage": damage, "killed": killed,
                       "slots": res["slots"],
                       "resumed_from_step": res["resumed_from_step"],
                       "fell_back": res["fell_back"],
                       "exact": res["digest"] == ref, "ok": combo_ok,
                       "fault_log": [list(e) for e in plan.log]})
    return {"phase": "matrix", "straight_digest": ref, "combos": combos,
            "all_ok": ok}


def _run_recovery(args) -> dict:
    """Wall clock of an uninterrupted ``--sweeps`` run against the whole
    kill path: train with a rotating checkpoint directory, corrupt the
    newest slot, die at ``--kill-at``, rebuild, fall back to the previous
    valid slot and finish.  An untimed straight leg runs first (the
    kernels' first launch, the allocator's warm-up), then both timed legs
    back to back in this process."""
    def straight():
        lda = _build(args, **_kw(args))
        arrays, _ = lda.run(args.sweeps, init_seed=0)
        return chain_digest(lda, arrays)       # its copies wait for the card

    ref = straight()
    t0 = time.perf_counter()
    ref2 = straight()
    straight_sec = time.perf_counter() - t0

    tmpd = tempfile.mkdtemp(prefix="chaos-recovery-")
    try:
        t0 = time.perf_counter()
        killed, _ = _soft_kill_run(args, tmpd, "corrupt")
        res = _resume_from(args, tmpd)
        recovery_sec = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmpd, ignore_errors=True)
    exact = res["digest"] == ref and ref2 == ref
    return {"phase": "recovery", "sweeps": args.sweeps,
            "kill_at": args.kill_at, "straight_sec": straight_sec,
            "recovery_sec": recovery_sec,
            "overhead_ratio": recovery_sec / max(straight_sec, 1e-9),
            "slots": res["slots"],
            "resumed_from_step": res["resumed_from_step"],
            "fell_back": res["fell_back"], "killed": killed,
            "exact": exact,
            "all_ok": killed and exact and res["fell_back"]}


# ---------------------------------------------------------------------------
# Serving phase (bad publishes + query flood behind admission control)
# ---------------------------------------------------------------------------
def _run_serve(args) -> dict:
    from repro_torch import fault, rng
    from repro_torch.fault import FaultPlan, FaultSpec
    from repro_torch.launch.serve_check import _build_trainer, _doc_pool
    from repro_torch.serve.lda_engine import (EngineOverloadedError,
                                              FormatVersionError, LdaEngine,
                                              PhiSnapshot,
                                              SnapshotCorruptError,
                                              StaleGenerationError,
                                              TopicQuery, fetch_snapshot)

    lda, corpus = _build_trainer(args)
    dev = lda.dev

    # the publish schedule, trained first: one good snapshot a sweep
    n_good = 3 if args.fast else 5
    arrays = lda.init_arrays(seed=0)
    snaps = [lda.export_phi_snapshot(arrays, sweep=0)]
    for s in range(n_good):
        arrays = lda.sweep(arrays, seed=s)
        snaps.append(lda.export_phi_snapshot(arrays, sweep=s + 1))

    engine = LdaEngine(snapshot=snaps[0], sweeps=8, tile=4, max_batch=8,
                       max_pending=args.max_pending,
                       degrade_pending=args.degrade_pending,
                       degraded_sweeps=2, device=dev)
    accepted = {1: snaps[0].digest}     # generation -> digest
    pub_lock = threading.Lock()
    rejected = {"corrupt": 0, "stale": 0, "format": 0, "unexpected": 0}
    r = np.random.default_rng(args.fault_seed)

    def tampered(snap):
        """One φ value flipped, the meta's digest kept: the mid-flight
        corruption publish must refuse."""
        phi = np.array(snap.phi)
        j, t = r.integers(phi.shape[0]), r.integers(phi.shape[1])
        phi[j, t] += 0.125
        return PhiSnapshot(phi=phi, meta=dict(snap.meta))

    def skewed(snap):
        meta = dict(snap.meta)
        meta["format_version"] = meta["format_version"] + 1
        return PhiSnapshot(phi=snap.phi, meta=meta)

    pub_errors = []

    def publisher():
        try:
            for i, snap in enumerate(snaps[1:], start=1):
                # a scripted bad publish before every good one
                bad_kind = ("corrupt", "stale", "format")[i % 3]
                try:
                    if bad_kind == "corrupt":
                        engine.publish(tampered(snap))
                    elif bad_kind == "stale":
                        engine.publish(snaps[i - 1])   # sweep regresses
                    else:
                        engine.publish(skewed(snap))
                    rejected["unexpected"] += 1        # it was accepted
                except SnapshotCorruptError:
                    rejected["corrupt"] += 1
                except StaleGenerationError:
                    rejected["stale"] += 1
                except FormatVersionError:
                    rejected["format"] += 1
                gen = engine.publish(snap)
                with pub_lock:
                    accepted[gen] = snap.digest
                time.sleep(0.02)
        except Exception as e:
            pub_errors.append(repr(e))

    pool = _doc_pool(corpus, 8)
    docs = tuple(pool[2:5])
    # the first query of both sweep counts (full and degraded) runs
    # before the flood, so the flood measures serving alone
    engine.query(TopicQuery(docs=docs))
    engine.query(TopicQuery(docs=docs, sweeps=engine.degraded_sweeps))

    answers, reader_errors = [], []
    sheds = [0] * args.flood_threads
    ans_lock = threading.Lock()

    def reader(tid):
        try:
            for i in range(args.flood_queries):
                try:
                    res = engine.query(TopicQuery(
                        docs=docs, key=rng.key(tid * 1000 + i, dev)))
                except EngineOverloadedError:
                    sheds[tid] += 1
                    continue
                with ans_lock:
                    answers.append({"generation": res.generation,
                                    "digest": res.digest,
                                    "latency_s": res.latency_s,
                                    "degraded": res.degraded})
        except Exception as e:
            reader_errors.append(repr(e))

    pub = threading.Thread(target=publisher, daemon=True)
    readers = [threading.Thread(target=reader, args=(t,), daemon=True)
               for t in range(args.flood_threads)]
    pub.start()
    for th in readers:
        th.start()
    pub.join()
    for th in readers:
        th.join()

    # ---- audit ----------------------------------------------------------
    invalid_gen = sum(1 for a in answers
                      if accepted.get(a["generation"]) != a["digest"])
    stats = engine.stats()
    lat = sorted(a["latency_s"] for a in answers)
    p50 = lat[len(lat) // 2] if lat else 0.0
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))] if lat else 0.0
    p99_ok = p99 <= args.p99_ratio * max(p50, 1e-9)

    # fetch retry: the first two attempts fail by plan, the third
    # succeeds; bounded backoff turns transient damage into a result
    fetch_dir = tempfile.mkdtemp(prefix="chaos-fetch-")
    try:
        fetch_path = os.path.join(fetch_dir, "phi.npz")
        snaps[-1].save(fetch_path)
        plan = FaultPlan([FaultSpec("fail", "serve.fetch", at=0, count=2)],
                         seed=args.fault_seed)
        with fault.install(plan):
            fetched = fetch_snapshot(fetch_path, retries=3, backoff_s=1e-4)
    finally:
        shutil.rmtree(fetch_dir, ignore_errors=True)
    fetch_ok = fetched.digest == snaps[-1].digest and len(plan.log) == 2

    total_shed = sum(sheds)
    ok = (invalid_gen == 0
          and not pub_errors and not reader_errors
          and rejected["corrupt"] > 0 and rejected["stale"] > 0
          and rejected["format"] > 0 and rejected["unexpected"] == 0
          and stats["rejected_publishes"] >= sum(
              rejected[k] for k in ("corrupt", "stale", "format"))
          and total_shed > 0 and stats["shed"] == total_shed
          and stats["degraded"] > 0
          and stats["max_pending_seen"] <= args.max_pending
          and stats["pending"] == 0
          and len(accepted) == n_good + 1
          and fetch_ok and p99_ok)
    return {"phase": "serve", "publishes_accepted": len(accepted),
            "publishes_rejected": rejected, "queries": len(answers),
            "shed": total_shed, "stats": stats,
            "generations_seen": sorted({a["generation"] for a in answers}),
            "invalid_generation_answers": invalid_gen,
            "degraded_answers": sum(a["degraded"] for a in answers),
            "latency_p50_s": p50, "latency_p99_s": p99, "p99_ok": p99_ok,
            "fetch_retry_ok": fetch_ok,
            "publisher_error": pub_errors[0] if pub_errors else None,
            "reader_error": reader_errors[0] if reader_errors else None,
            "device": str(dev), "all_ok": ok}


PHASES = {"straight": _run_straight, "train": _run_train,
          "resume": _run_resume, "matrix": _run_matrix,
          "recovery": _run_recovery, "serve": _run_serve}


def main(argv=None) -> None:
    args = _parse(sys.argv[1:] if argv is None else argv)
    if args.phase in ("train", "resume") and not args.ckpt:
        raise SystemExit("--ckpt is required for train/resume phases")
    report = PHASES[args.phase](args)
    print(json.dumps(report))
    if not report.get("all_ok", True):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
