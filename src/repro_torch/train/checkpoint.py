"""Checkpointing (``repro/train/checkpoint.py``): numpy ``.npz`` stores,
in the reference's file format, so a file written by either package loads
in the other with equal arrays and meta.

Three stores live here:

* :func:`save` / :func:`restore` — a nested dict, list or tuple of tensors
  and numpy arrays flattened to path keys (``a/b/0``, a named tuple's
  field as ``.name``), bf16 stored as f32; ``restore`` rebuilds the
  structure of a template.  A zoo model goes as the reference's weight
  dict, so either package reads the other's file.

* :func:`save_chain` / :func:`load_chain` — the format-versioned LDA chain
  store: ``state`` (a flat ``str → ndarray`` dict: ``z`` in canonical
  order, compact count tables, r-bucket side tables, …) plus ``meta`` (a
  JSON-able dict carrying the format version, the RNG counter for the
  next sweep and every chain-affecting knob, so a mismatched resume fails
  loudly instead of forking the chain).  :class:`CheckpointRotation`
  keeps the last ``keep`` slots plus a last-good pointer, and
  ``load_latest_valid`` walks the slots newest-first past damaged ones:
  the fallback ``NomadLDA.run`` resumes from bit for bit.

* :func:`save_phi` / :func:`load_phi` — the format-versioned φ snapshot
  the serving engine folds against: an npz holding ``phi`` and a JSON
  meta under ``__phi_meta__`` (format version, geometry, content digest).

Writes are atomic (temp file + ``os.replace``) and durable (the file and
its directory are fsynced); every payload array gets a sha256 in meta,
verified on load.  Damage (truncation, flipped bytes, missing meta)
surfaces as :class:`~repro_torch.fault.SnapshotCorruptError`, an unknown
format version as :class:`~repro_torch.fault.FormatVersionError`, a
missing file as ``FileNotFoundError``.  A chain write fires the
``"chain.write"`` fault site, a φ write ``"phi.write"``.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.fault import fire as _fault_fire
from repro_torch.fault.errors import (FormatVersionError,
                                      SnapshotCorruptError,
                                      SnapshotDigestError)

__all__ = ["save", "restore", "save_chain", "load_chain", "save_phi",
           "load_phi", "phi_digest", "CheckpointRotation",
           "CHAIN_FORMAT_VERSION", "PHI_FORMAT_VERSION",
           "SnapshotCorruptError", "FormatVersionError"]

CHAIN_FORMAT_VERSION = 1
PHI_FORMAT_VERSION = 1
_META_KEY = "__chain_meta__"
_PHI_META_KEY = "__phi_meta__"


def _leaves(tree, path=()):
    """``(path, leaf)`` pairs in ``jax.tree_util``'s order: dict keys
    sorted, sequences by index, a named tuple's fields by name; ``None``
    has no leaves."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _flatten(tree) -> dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:   # npz has no bf16: lossless
                leaf = leaf.float()
            arr = leaf.numpy()
        else:
            arr = np.asarray(leaf)
            if arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)
        flat[key] = arr
    return flat


def _is_model(tree) -> bool:
    from repro_torch.models.transformer import Transformer
    return isinstance(tree, Transformer)


def save(path: str, tree) -> None:
    """``tree`` as path keys in an npz.  A zoo model (``Transformer``) is
    saved as the reference's weight dict, so the reference's
    ``restore(path, params)`` reads it."""
    if _is_model(tree):
        from repro_torch.convert import params_to_reference
        tree = params_to_reference(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))


def _rebuild(like, path, data):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, path + (str(k),), data)
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, path + (f".{n}",), data)
                            for n, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, path + (str(i),), data)
                          for i, v in enumerate(like))
    key = "/".join(path)
    arr = data[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: stored shape {arr.shape}, template "
                         f"{tuple(like.shape)}")
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(like.device, like.dtype)
    return arr.astype(np.asarray(like).dtype)


def restore(path: str, like):
    """Restore into the structure of ``like`` (shape/dtype template):
    tensors come back on the template's device and in its dtype.  For a
    zoo model, a new model of ``like``'s config, dtype and device holding
    the file's weights (the reference's file or :func:`save`'s)."""
    model = like if _is_model(like) else None
    if model is not None:
        from repro_torch.convert import params_to_reference
        like = params_to_reference(model)
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        tree = _rebuild(like, (), data)
    if model is None:
        return tree
    from repro_torch.convert import params_from_reference
    return params_from_reference(tree, model.cfg, model.embed.device,
                                 model.embed.dtype)


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


def save_chain(path: str, state: dict[str, np.ndarray], meta: dict) -> str:
    """Atomically + durably write a chain checkpoint (``state`` arrays +
    ``meta``) → the final path.  ``meta`` must be JSON-able;
    ``format_version`` and per-payload digests are stamped here."""
    meta = dict(meta)
    meta["format_version"] = CHAIN_FORMAT_VERSION
    return _atomic_savez(path, {k: np.asarray(v) for k, v in state.items()},
                         meta, _META_KEY, fault_site="chain.write")


def load_chain(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """Read a chain checkpoint.  Damage of any shape (truncated archive,
    flipped payload byte, missing ``__chain_meta__``, per-payload digest
    mismatch) raises :class:`SnapshotCorruptError`; an unknown
    ``format_version`` raises :class:`FormatVersionError`; a missing file
    stays ``FileNotFoundError``.  Rotation fallback skips the first kind
    of slot and hard-stops on the second."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        with np.load(path) as data:
            if _META_KEY not in data:
                raise SnapshotCorruptError(
                    f"{path} is not a chain checkpoint (no {_META_KEY})")
            meta = json.loads(bytes(data[_META_KEY].tobytes()).decode())
            ver = meta.get("format_version")
            if ver != CHAIN_FORMAT_VERSION:
                raise FormatVersionError(
                    f"chain checkpoint format v{ver} unsupported (this "
                    f"build reads v{CHAIN_FORMAT_VERSION})")
            # read every member inside the guard: a truncated zip member
            # fails here, not at first use
            state = {k: np.asarray(data[k]) for k in data.files
                     if k != _META_KEY}
    except (SnapshotCorruptError, FormatVersionError):
        raise
    except Exception as e:      # BadZipFile, zlib/OSError, bad JSON, ...
        raise SnapshotCorruptError(
            f"unreadable chain checkpoint {path}: {e!r}") from e
    _verify_payload_digests(path, state, meta)
    return state, meta


class CheckpointRotation:
    """A directory of rotating chain-checkpoint slots with a last-good
    pointer.

    Layout: ``root/slot-{step:08d}.npz`` (``step`` = the chain's
    ``next_seed`` at the checkpoint, i.e. sweeps completed) plus
    ``root/LAST_GOOD`` (a JSON pointer ``{"step": ..., "slot": ...}``,
    atomically replaced and fsynced after every slot write).  The newest
    ``keep`` slots are retained; older ones are pruned, except a slot the
    pointer still names.

    The pointer is advisory: damage may land after a durable write (bit
    rot, a torn mirror copy), so :meth:`load_latest_valid` never trusts
    it.  It walks the slots newest-first and returns the first one
    :func:`load_chain` fully validates.  Only when every slot is damaged
    does it raise :class:`SnapshotCorruptError`; a
    :class:`FormatVersionError` always propagates (every slot was written
    by the same build, so walking on cannot fix a version skew).
    """

    POINTER = "LAST_GOOD"

    def __init__(self, root: str, *, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.root = root
        self.keep = int(keep)

    def slot_path(self, step: int) -> str:
        return os.path.join(self.root, f"slot-{int(step):08d}.npz")

    def slots(self) -> list[tuple[int, str]]:
        """All present slots as ``(step, path)``, ascending by step."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            if name.startswith("slot-") and name.endswith(".npz"):
                try:
                    out.append((int(name[5:-4]),
                                os.path.join(self.root, name)))
                except ValueError:
                    continue
        return sorted(out)

    def last_good(self) -> int | None:
        """The advisory pointer's step (``None`` if absent/unreadable)."""
        try:
            with open(os.path.join(self.root, self.POINTER)) as f:
                return int(json.load(f)["step"])
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return None

    def _promote(self, step: int) -> None:
        """Atomically + durably point ``LAST_GOOD`` at ``step``."""
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".ptr.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"step": int(step),
                           "slot": os.path.basename(self.slot_path(step))},
                          f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.root, self.POINTER))
            _fsync_dir(self.root)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _prune(self) -> None:
        slots = self.slots()
        if len(slots) <= self.keep:
            return
        pinned = self.last_good()
        for step, path in slots[:-self.keep]:
            if step == pinned:
                continue
            try:
                os.unlink(path)
            except OSError:
                pass

    def save(self, state: dict[str, np.ndarray], meta: dict, *,
             step: int) -> str:
        """Write slot ``step`` (atomic + durable), promote the pointer,
        prune old slots → the slot path.  The ``"chain.write"`` fault site
        (inside :func:`save_chain`) lands on the slot after its durable
        write: the damage-after-success window rotation exists to
        survive."""
        os.makedirs(self.root, exist_ok=True)
        path = save_chain(self.slot_path(step), state, meta)
        self._promote(step)
        self._prune()
        return path

    def load_latest_valid(self) -> tuple[dict[str, np.ndarray], dict, int]:
        """→ ``(state, meta, step)`` of the newest slot that validates,
        skipping corrupt or truncated ones.  Raises ``FileNotFoundError``
        when there are no slots at all, :class:`SnapshotCorruptError` when
        every slot is damaged and :class:`FormatVersionError` on the first
        version skew."""
        slots = self.slots()
        if not slots:
            raise FileNotFoundError(
                f"no checkpoint slots in {self.root!r}")
        skipped = []
        for step, path in reversed(slots):
            try:
                state, meta = load_chain(path)
                return state, meta, step
            except FormatVersionError:
                raise
            except (SnapshotCorruptError, FileNotFoundError) as e:
                skipped.append(f"slot {step}: {e}")
        raise SnapshotCorruptError(
            f"every checkpoint slot in {self.root!r} is damaged: "
            + "; ".join(skipped))


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
