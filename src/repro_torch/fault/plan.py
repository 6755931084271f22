"""Deterministic fault injection: a seeded, declarative fault schedule
(DESIGN.md §11).

At the paper's scale — multi-machine, multi-day runs — worker failure
and partial writes are the common case, not the exception (Glint,
PAPERS.md).  This module makes every such failure *reproducible in CI*
without real crashes: a :class:`FaultPlan` is a list of
:class:`FaultSpec` events, each naming a **site** (a string the runtime
fires at well-defined points, e.g. ``"trainer.sweep"`` after sweep ``s``
or ``"chain.write"`` after a checkpoint file lands), an index window
(``at``/``count``) and a fault ``kind``:

====================  ====================================================
kind                  effect when the site fires inside the window
====================  ====================================================
``"kill"``            preemption: ``hard=True`` → ``os._exit(137)`` (the
                      real SIGKILL story, for subprocess harnesses);
                      ``hard=False`` → raise :class:`InjectedKill`
``"stall"``           worker stall: sleep ``delay_s`` seconds
``"corrupt"``         flip ``nbytes`` bytes of the file at ``path``
                      (offsets drawn from the plan's seeded RNG)
``"truncate"``        truncate the file at ``path`` to ``frac`` of its
                      size (a torn / partial write surfacing later)
``"fail"``            raise :class:`SnapshotCorruptError` (a transient
                      fetch/read failure, for retry logic)
``"drop"``            returned to the caller, which skips the action
                      (e.g. a dropped publish)
``"delay"``           sleep ``delay_s``, then let the action proceed
                      (a delayed publish)
====================  ====================================================

Everything is deterministic: byte offsets and values come from
``np.random.default_rng([seed, crc32(site), index])``, so the same plan
replays the same damage bit-for-bit.  Sites the plan does not mention
cost one dict lookup (and zero when no plan is installed at all).

Sites fired by the runtime today (callers pass ``index`` where a
meaningful global ordinal exists, else the plan's per-site counter):

* ``"trainer.sweep"``   — ``NomadLDA.run``, after sweep ``s`` (and after
  its checkpoint write, so kill-after-checkpoint is expressible);
  ``index`` = global sweep number.
* ``"trainer.publish"`` — before a scheduled φ publish; ``index`` =
  global sweep number.  ``drop``/``delay`` apply.
* ``"chain.write"``     — after a chain-checkpoint file is durably
  written; counter-indexed, ``path`` = the file.
* ``"phi.write"``       — same, for φ snapshots.
* ``"serve.fetch"``     — each attempt inside
  ``repro_torch.serve.lda_engine.fetch_snapshot``; counter-indexed across
  calls (so ``at=0, count=2`` fails the first two attempts overall).

Install a plan for a scope with :func:`install` (re-entrant context
manager); runtime hooks call :func:`fire`, which is a no-op without an
installed plan.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
import zlib

import numpy as np

from repro_torch.fault.errors import InjectedKill, SnapshotCorruptError

__all__ = ["FaultSpec", "FaultPlan", "install", "active", "fire"]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: ``kind`` at ``site`` for event indices in
    ``[at, at + count)``.  See the module docstring for kind semantics."""
    kind: str
    site: str
    at: int
    count: int = 1
    hard: bool = False       # kill: os._exit(137) instead of InjectedKill
    nbytes: int = 1          # corrupt: bytes to flip
    frac: float = 0.5        # truncate: fraction of the file kept
    delay_s: float = 0.0     # stall / delay: seconds slept

    _KINDS = ("kill", "stall", "corrupt", "truncate", "fail", "drop",
              "delay")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {self._KINDS}")
        if self.at < 0 or self.count < 1:
            raise ValueError(f"need at >= 0, count >= 1; got at={self.at}, "
                             f"count={self.count}")
        if not 0.0 <= self.frac < 1.0:
            raise ValueError(f"truncate frac must be in [0, 1), got "
                             f"{self.frac}")

    def matches(self, site: str, index: int) -> bool:
        return self.site == site and self.at <= index < self.at + self.count


class FaultPlan:
    """A seeded schedule of :class:`FaultSpec` events.

    Thread-safe: per-site counters and the event log are lock-guarded,
    so a serving engine's reader threads and a trainer thread can fire
    sites concurrently.  ``log`` records every applied event as
    ``(site, index, kind)`` for harness reporting.
    """

    def __init__(self, specs=(), *, seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self.log: list[tuple[str, int, str]] = []
        self._sites = frozenset(s.site for s in self.specs)

    def _rng(self, site: str, index: int) -> np.random.Generator:
        return np.random.default_rng(
            [self.seed, zlib.crc32(site.encode()), index])

    def next_index(self, site: str) -> int:
        """Advance and return ``site``'s event counter (0-based)."""
        with self._lock:
            idx = self._counters.get(site, 0)
            self._counters[site] = idx + 1
            return idx

    def _corrupt_file(self, path: str, spec: FaultSpec, index: int) -> None:
        size = os.path.getsize(path)
        if size == 0:
            return
        rng = self._rng(spec.site, index)
        offs = rng.integers(0, size, size=max(1, spec.nbytes))
        with open(path, "r+b") as f:
            for off in offs:
                f.seek(int(off))
                b = f.read(1)
                f.seek(int(off))
                # XOR with a nonzero byte: a guaranteed flip
                f.write(bytes([b[0] ^ int(rng.integers(1, 256))]))

    def _truncate_file(self, path: str, spec: FaultSpec) -> None:
        size = os.path.getsize(path)
        os.truncate(path, int(size * spec.frac))

    def fire(self, site: str, *, index: int | None = None,
             path: str | None = None) -> tuple[str, ...]:
        """Fire ``site``; apply every scheduled fault whose window covers
        the event index.  Returns the applied kinds (``"drop"`` is only
        reported — honoring it is the caller's contract).  Raises for
        ``kill`` (:class:`InjectedKill`, or ``os._exit(137)`` when hard)
        and ``fail`` (:class:`SnapshotCorruptError`)."""
        if site not in self._sites:
            # still count it: indices must not depend on the spec list
            if index is None:
                self.next_index(site)
            return ()
        if index is None:
            index = self.next_index(site)
        applied = []
        for spec in self.specs:
            if not spec.matches(site, index):
                continue
            applied.append(spec.kind)
            with self._lock:
                self.log.append((site, index, spec.kind))
            if spec.kind == "stall" or spec.kind == "delay":
                time.sleep(spec.delay_s)
            elif spec.kind == "corrupt":
                if path is None:
                    raise ValueError(
                        f"corrupt fault at {site}[{index}] needs a path")
                self._corrupt_file(path, spec, index)
            elif spec.kind == "truncate":
                if path is None:
                    raise ValueError(
                        f"truncate fault at {site}[{index}] needs a path")
                self._truncate_file(path, spec)
            elif spec.kind == "fail":
                raise SnapshotCorruptError(
                    f"injected failure at {site}[{index}]")
            elif spec.kind == "kill":
                if spec.hard:            # the real preemption story:
                    os._exit(137)        # no teardown, no atexit, SIGKILL
                raise InjectedKill(site, index)
        return tuple(applied)


# ---------------------------------------------------------------------------
# Installed-plan hooks: zero-cost when nothing is installed.
# ---------------------------------------------------------------------------
_ACTIVE: FaultPlan | None = None
_INSTALL_LOCK = threading.Lock()


class _Install:
    """Re-entrant installer: restores whatever plan was active before."""

    def __init__(self, plan: FaultPlan | None):
        self._plan = plan
        self._prev: FaultPlan | None = None

    def __enter__(self) -> FaultPlan | None:
        global _ACTIVE
        with _INSTALL_LOCK:
            self._prev = _ACTIVE
            _ACTIVE = self._plan
        return self._plan

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        with _INSTALL_LOCK:
            _ACTIVE = self._prev


def install(plan: FaultPlan | None) -> _Install:
    """``with install(plan): ...`` — make ``plan`` the process-wide
    active plan for the block (``None`` disables injection inside).
    The runtime's :func:`fire` hooks consult the active plan only."""
    return _Install(plan)


def active() -> FaultPlan | None:
    return _ACTIVE


def fire(site: str, *, index: int | None = None,
         path: str | None = None) -> tuple[str, ...]:
    """Module-level hook the runtime calls at injection sites.  A no-op
    (and near-free) when no plan is installed."""
    plan = _ACTIVE
    if plan is None:
        return ()
    return plan.fire(site, index=index, path=path)
