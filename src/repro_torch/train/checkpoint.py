"""The φ half of the checkpoint store (``repro/train/checkpoint.py``).

:func:`save_phi` / :func:`load_phi` write and read the format-versioned φ
snapshot that the serving engine folds against.  The file format is the
reference's, byte for byte in its arrays and meta: an npz holding ``phi``
and a JSON meta under ``__phi_meta__`` (format version, geometry, content
digest, per-payload sha256).  A snapshot written by either package loads
in the other with the same digest.

Writes are atomic (temp file + ``os.replace``) and durable (the file and
its directory are fsynced).  Damage surfaces as
:class:`~repro_torch.fault.SnapshotCorruptError`, an unknown format version
as :class:`~repro_torch.fault.FormatVersionError`.  The chain half
(``save_chain``, ``load_chain``, ``CheckpointRotation``) is ported with
the trainer.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np

from repro_torch.fault import fire as _fault_fire
from repro_torch.fault.errors import (FormatVersionError,
                                      SnapshotCorruptError,
                                      SnapshotDigestError)

__all__ = ["save_phi", "load_phi", "phi_digest", "PHI_FORMAT_VERSION",
           "SnapshotCorruptError", "FormatVersionError"]

PHI_FORMAT_VERSION = 1
_PHI_META_KEY = "__phi_meta__"


def _fsync_dir(d: str) -> None:
    """fsync a directory so a completed ``os.replace`` survives a host
    crash (the rename itself lives in the directory's metadata)."""
    fd = os.open(d, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _array_digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _atomic_savez(path: str, payload: dict, meta: dict,
                  meta_key: str, *, fault_site: str | None = None) -> str:
    """Write ``payload`` + JSON ``meta`` as one npz, atomically AND
    durably: the write goes to a temp file in the destination directory,
    is fsynced, ``os.replace``d into place, and the directory is fsynced
    — so readers only ever see a complete file and a host crash at any
    point keeps either the old entry or the new one, never neither.
    Per-payload sha256 digests are stamped into meta
    (``payload_sha256``), verified by the loaders.  Returns the final
    path (``.npz`` appended if missing).  ``fault_site`` names the
    injection site fired *after* the durable write — the hook the fault
    layer uses to model bit rot / partial writes surfacing later."""
    if meta_key in payload:
        raise ValueError(f"state may not use the reserved key {meta_key!r}")
    if not path.endswith(".npz"):
        path = path + ".npz"
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    meta = dict(meta)
    meta["payload_sha256"] = {k: _array_digest(np.asarray(v))
                              for k, v in payload.items()}
    payload = dict(payload)
    payload[meta_key] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), np.uint8)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if fault_site is not None:
        _fault_fire(fault_site, path=path)
    return path


def _verify_payload_digests(path: str, state: dict, meta: dict) -> None:
    """Check every loaded array against the per-key sha256 stamped at
    write time (absent in pre-§11 checkpoints: nothing to verify)."""
    want = meta.get("payload_sha256") or {}
    for k, arr in state.items():
        exp = want.get(k)
        if exp is not None and _array_digest(arr) != exp:
            raise SnapshotDigestError(
                f"{path}: payload {k!r} sha256 digest mismatch — corrupt "
                f"or truncated entry")


def phi_digest(phi: np.ndarray) -> str:
    """Content digest of a φ table — the torn-read/corruption detector the
    serving engine threads through every answer."""
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(phi, np.float32)).tobytes()
    ).hexdigest()


def save_phi(path: str, phi: np.ndarray, meta: dict) -> str:
    """Atomically + durably write a φ snapshot (``(J, T)`` f32 table +
    ``meta``) → the final path.  ``format_version`` and the integrity
    ``digest`` are stamped here; ``meta`` must be JSON-able.
    """
    phi = np.asarray(phi, np.float32)
    if phi.ndim != 2:
        raise ValueError(f"phi must be a (J, T) table; got shape {phi.shape}")
    meta = dict(meta)
    meta["format_version"] = PHI_FORMAT_VERSION
    meta["J"], meta["T"] = int(phi.shape[0]), int(phi.shape[1])
    meta["digest"] = phi_digest(phi)
    return _atomic_savez(path, {"phi": phi}, meta, _PHI_META_KEY,
                         fault_site="phi.write")


def load_phi(path: str) -> tuple[np.ndarray, dict]:
    """Read a φ snapshot; refuses unknown format versions
    (:class:`FormatVersionError`) and damaged tables — truncated archive,
    digest mismatch, meta/shape skew — as :class:`SnapshotCorruptError`.
    A serving fleet must never fold against a φ it cannot prove it
    understands, and retry logic needs to tell transient damage (a
    publisher mid-write: retry) from version skew (never retry)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        with np.load(path) as data:
            if _PHI_META_KEY not in data:
                raise SnapshotCorruptError(f"{path} is not a φ snapshot "
                                           f"(no {_PHI_META_KEY})")
            meta = json.loads(bytes(data[_PHI_META_KEY].tobytes()).decode())
            ver = meta.get("format_version")
            if ver != PHI_FORMAT_VERSION:
                raise FormatVersionError(
                    f"φ snapshot format v{ver} unsupported (this build "
                    f"reads v{PHI_FORMAT_VERSION})")
            phi = np.asarray(data["phi"], np.float32)
    except (SnapshotCorruptError, FormatVersionError):
        raise
    except Exception as e:      # BadZipFile, zlib/OSError, bad JSON, ...
        raise SnapshotCorruptError(
            f"unreadable φ snapshot {path}: {e!r}") from e
    # Past this point the archive parsed end to end — writers rename
    # atomically, so content-vs-meta contradictions are permanent damage
    # (SnapshotDigestError), not a publisher mid-write worth retrying.
    if phi.shape != (meta.get("J"), meta.get("T")):
        raise SnapshotDigestError(
            f"φ snapshot shape {phi.shape} does not match its meta "
            f"({meta.get('J')}, {meta.get('T')})")
    got = phi_digest(phi)
    if meta.get("digest") not in (None, got):
        raise SnapshotDigestError("φ snapshot digest mismatch — corrupt "
                                  "or hand-edited table")
    return phi, meta
