"""Typed failure-path exceptions shared by the checkpoint store, the
serving engine and the fault-injection layer (DESIGN.md §11).

The hierarchy deliberately stays inside the builtin families the happy
path already raised (``ValueError`` / ``RuntimeError``), so pre-existing
callers that catch broadly keep working while recovery code can now
discriminate:

* :class:`SnapshotCorruptError` — the bytes are damaged: truncated file,
  flipped payload byte, missing meta key, digest mismatch.  Retryable
  when the source may heal (a publisher mid-write); fatal for a specific
  checkpoint slot, which is what rotation fallback skips past.
* :class:`FormatVersionError` — the bytes are intact but from a writer
  this build does not understand.  Never retried: time does not fix a
  version skew.
* :class:`StaleGenerationError` — a structurally valid snapshot that
  would move the serving engine *backwards* (its source generation is
  ≤ the live buffer's).  The publish is refused; the live buffer keeps
  serving.
* :class:`EngineOverloadedError` — admission control shed the query
  because the bounded queue is full.  The caller should back off; the
  engine stays healthy by design.
"""
from __future__ import annotations

__all__ = ["SnapshotCorruptError", "SnapshotDigestError",
           "FormatVersionError", "StaleGenerationError",
           "EngineOverloadedError", "InjectedKill"]


class SnapshotCorruptError(ValueError):
    """A checkpoint / φ snapshot whose bytes cannot be trusted:
    truncated archive, flipped payload byte, missing meta, digest
    mismatch.  ``ValueError`` ancestry keeps pre-typed callers working."""


class SnapshotDigestError(SnapshotCorruptError):
    """*Proven-permanent* corruption: the file parsed end to end but its
    content contradicts its own metadata (payload digest mismatch,
    shape-vs-meta skew).  Writers rename atomically (``_atomic_savez``),
    so a complete parse rules out the mid-write race that makes plain
    :class:`SnapshotCorruptError` worth retrying — retry logic must fail
    fast on this subclass (rotation fallback still skips the slot: the
    ``SnapshotCorruptError`` ancestry is what it catches)."""


class FormatVersionError(ValueError):
    """Structurally intact bytes from an unknown format version —
    permanent for this build, so retry logic must not retry it."""


class StaleGenerationError(ValueError):
    """A publish that would regress the serving engine's source
    generation (digest + monotonic-generation guard, DESIGN.md §11)."""


class EngineOverloadedError(RuntimeError):
    """Admission control shed this query: the bounded queue was full.
    Back off and retry; the engine is healthy and still serving."""


class InjectedKill(RuntimeError):
    """Raised by a soft ``kill`` fault (``FaultSpec(kind="kill",
    hard=False)``): the deterministic, in-process stand-in for a
    preemption.  Carries the site/index it fired at."""

    def __init__(self, site: str, index: int):
        super().__init__(f"injected kill at {site}[{index}]")
        self.site = site
        self.index = index
