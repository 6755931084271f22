"""Online fold-in topic inference (``repro/serve/lda_engine.py``), on the
card.

Serving owns a frozen posterior-mean φ table; the trainer owns the chain.
Three pieces:

* :class:`PhiSnapshot` — an immutable, format-versioned φ table plus the
  hyperparameters and integrity digest needed to fold against it, built
  from trained counts by :func:`snapshot_from_counts` or loaded from the
  ``train/checkpoint.py:save_phi`` store (files cross-load with the JAX
  package's).
* :func:`pack_docs` — ragged → padded: variable-length documents become a
  ``(D, L)`` tile (rows and columns bucketed to powers of two) plus a
  validity mask.  Padded positions are inert under the fold-in's
  counter-mode RNG contract.
* :class:`LdaEngine` — double-buffered θ service.  ``publish`` moves φ to
  the engine's device *off* the serving path and installs it with one
  reference swap (generation counter + content digest); ``query`` pins
  the buffer with a single attribute read, so a reader never sees a torn
  table.  By default the fold-in runs through the CUDA fold-in kernel
  (``inner_mode="fused"``); ``"scan"`` runs the plain ``fold_in_batch``.

Failure model: ``publish`` is the integrity gate — a corrupt table raises
:class:`SnapshotCorruptError`, a version skew :class:`FormatVersionError`,
a snapshot that would move the engine backwards
:class:`StaleGenerationError`; the live buffer keeps serving through all
three.  ``query`` runs behind admission control: ``max_pending`` sheds
excess load (:class:`EngineOverloadedError`), and ``degrade_pending``
caps fold-in sweeps before shedding starts.  :func:`fetch_snapshot` is the
reader-side loader: bounded retry with exponential backoff around
transient damage, never around version skew or proven corruption.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch import rng
from repro_torch._device import resolve
from repro_torch.core.heldout import (_phi_hat, doc_fold_key, fold_in_batch,
                                      theta_from_counts)
from repro_torch.fault import fire as _fault_fire
from repro_torch.fault.errors import (EngineOverloadedError,
                                      FormatVersionError,
                                      SnapshotCorruptError,
                                      SnapshotDigestError,
                                      StaleGenerationError)
from repro_torch.kernels.fold_in import fold_in_fused
from repro_torch.train.checkpoint import (PHI_FORMAT_VERSION, load_phi,
                                          phi_digest, save_phi)

__all__ = ["PhiSnapshot", "snapshot_from_counts", "pack_docs",
           "TopicQuery", "TopicResult", "LdaEngine", "fetch_snapshot",
           "SnapshotCorruptError", "FormatVersionError",
           "StaleGenerationError", "EngineOverloadedError"]


def _pow2_ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# Snapshots
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PhiSnapshot:
    """A frozen φ table: ``phi`` is ``(J, T)`` f32 on the host, ``meta``
    carries ``format_version``/``alpha``/``beta``/``J``/``T``/``digest``
    (and any trainer-side extras, e.g. the sweep it was exported at)."""
    phi: np.ndarray
    meta: dict

    @property
    def alpha(self) -> float:
        return float(self.meta["alpha"])

    @property
    def beta(self) -> float:
        return float(self.meta["beta"])

    @property
    def digest(self) -> str:
        return self.meta["digest"]

    def save(self, path: str) -> None:
        save_phi(path, self.phi, self.meta)

    @classmethod
    def load(cls, path: str) -> "PhiSnapshot":
        phi, meta = load_phi(path)
        return cls(phi=phi, meta=meta)


def snapshot_from_counts(n_wt, n_t, *, alpha: float, beta: float,
                         extra_meta: dict | None = None) -> PhiSnapshot:
    """Freeze trained counts into a snapshot: φ̂ = (n_wt+β)/(n_t+Jβ),
    computed on the host with the reference's f32 rounding."""
    phi = _phi_hat(torch.as_tensor(np.asarray(n_wt)),
                   torch.as_tensor(np.asarray(n_t)), beta).numpy()
    meta = dict(extra_meta or {})
    meta.update(format_version=PHI_FORMAT_VERSION,
                alpha=float(alpha), beta=float(beta),
                J=int(phi.shape[0]), T=int(phi.shape[1]),
                digest=phi_digest(phi))
    return PhiSnapshot(phi=phi, meta=meta)


def fetch_snapshot(path: str, *, retries: int = 3, backoff_s: float = 0.05,
                   max_backoff_s: float = 1.0,
                   sleep=time.sleep) -> PhiSnapshot:
    """Load a φ snapshot with bounded retry + exponential backoff.

    Retried: ``FileNotFoundError`` (not published yet) and plain
    :class:`SnapshotCorruptError` (a publisher mid-write — transient by
    assumption), up to ``retries`` extra attempts, backoff doubling from
    ``backoff_s`` and capped at ``max_backoff_s``.  Never retried:
    :class:`FormatVersionError` (a deployment bug) and
    :class:`SnapshotDigestError` (a fully parsed file that contradicts its
    own meta is permanent damage).  Each attempt fires the
    ``"serve.fetch"`` fault site."""
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    delay = backoff_s
    for attempt in range(retries + 1):
        try:
            _fault_fire("serve.fetch", path=path)
            return PhiSnapshot.load(path)
        except (FormatVersionError, SnapshotDigestError):
            raise
        except (FileNotFoundError, SnapshotCorruptError):
            if attempt == retries:
                raise
            sleep(delay)
            delay = min(delay * 2, max_backoff_s)
    raise AssertionError("unreachable")


# ---------------------------------------------------------------------------
# Ragged → padded batching
# ---------------------------------------------------------------------------
def pack_docs(docs, *, tile: int = 8):
    """Pack variable-length documents into a padded ``(D_pad, L)`` tile.

    ``L`` is the longest document rounded up to a multiple of ``tile`` and
    then to a power-of-two tile count; ``D_pad`` is the doc count rounded
    to a power of two, so a handful of shapes covers all requests.
    Returns ``(word_ids, valid, n_real)`` as numpy arrays; padded
    positions and rows are all-False in ``valid`` and carry word id 0.
    """
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    docs = [np.asarray(d, np.int32).reshape(-1) for d in docs]
    if not docs:
        raise ValueError("pack_docs got an empty document list")
    n_real = len(docs)
    l_max = max(d.size for d in docs)
    n_tiles = _pow2_ceil(max(-(-l_max // tile), 1))
    L = n_tiles * tile
    D = _pow2_ceil(n_real)
    word_ids = np.zeros((D, L), np.int32)
    valid = np.zeros((D, L), bool)
    for i, d in enumerate(docs):
        word_ids[i, :d.size] = d
        valid[i, :d.size] = True
    return word_ids, valid, n_real


# ---------------------------------------------------------------------------
# Request / response types
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TopicQuery:
    """``docs``: variable-length token-id documents (empty docs allowed —
    their θ is the uniform α prior).  ``key``: base RNG key
    (:func:`repro_torch.rng.key`); document ``i`` of the query runs stream
    ``doc_fold_key(key, i)``, so a query is bit-reproducible by the serial
    ``fold_in`` under the same key.  ``sweeps`` overrides the engine
    default."""
    docs: tuple
    key: object = None
    sweeps: int | None = None


@dataclasses.dataclass(frozen=True)
class TopicResult:
    """θ rows for the query's documents plus the provenance needed to
    audit which snapshot answered (generation + digest) and the load
    story under admission control."""
    theta: np.ndarray        # (len(docs), T) f32, rows sum to 1
    n_td: np.ndarray         # (len(docs), T) int32 fold-in counts
    generation: int
    digest: str
    latency_s: float
    batch_shape: tuple       # padded (D_pad, L) actually swept
    sweeps_used: int = 0     # fold-in sweeps this answer ran
    degraded: bool = False   # True → sweeps were capped under overload
    shed_total: int = 0      # engine-lifetime queries shed so far
    degraded_total: int = 0  # engine-lifetime degraded answers so far


@dataclasses.dataclass(frozen=True)
class _Buffer:
    """One published φ buffer.  Immutable: a reader that grabbed this
    object sees a consistent (phi, alpha, generation, digest) forever,
    regardless of later publishes."""
    phi: torch.Tensor        # (J, T) f32 on the engine's device
    alpha: float
    generation: int
    digest: str
    meta: dict
    source: int | None = None  # trainer-side generation (meta sweep), the
                               #   monotonicity guard's comparison key


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------
def _theta(word_ids, valid, phi, alpha, doc_keys, sweeps, inner_mode):
    if inner_mode == "fused":
        n_td = fold_in_fused(word_ids, valid, phi, alpha, doc_keys, sweeps)
    else:
        n_td = fold_in_batch(word_ids, valid, phi, alpha, doc_keys, sweeps)
    return n_td, theta_from_counts(n_td, alpha)


def _bucket_len(n: int, tile: int) -> int:
    """The padded row length ``pack_docs`` would give a lone ``n``-token
    document — the pow-2 length bucket ``query`` groups by."""
    return _pow2_ceil(max(-(-n // tile), 1)) * tile


class LdaEngine:
    """Double-buffered fold-in θ service on one device.

    ``device=None`` means CUDA, and the engine raises if there is none;
    pass ``device="cpu"`` for the plain path on the CPU.

    Thread-safety contract: ``publish`` may run concurrently with any
    number of ``query`` calls.  Publishers serialize on a lock; readers
    take no lock — they pin the current :class:`_Buffer` with one
    reference read, so a concurrent publish can reorder *which* snapshot
    answered but never mix two snapshots inside one answer.

    Admission control: ``max_pending`` bounds concurrent in-flight queries
    (excess raises :class:`EngineOverloadedError`); above
    ``degrade_pending`` answers run with sweeps capped at
    ``degraded_sweeps``.  Both default to ``None`` (off).

    ``inner_mode``: ``"fused"`` (default) runs the fold-in kernel —
    CUDA on the card, its plain version on the CPU; ``"scan"`` runs the
    plain ``fold_in_batch``.  Both are bit-equal per document.  Queries
    are length-bucketed: docs whose pow-2 padded length exceeds 4x the
    batch's median bucket run in their own sub-batch, so one long outlier
    cannot inflate every row's padded work.
    """

    def __init__(self, snapshot: PhiSnapshot | None = None, *,
                 sweeps: int = 20, tile: int = 8, max_batch: int = 64,
                 default_key=None, max_pending: int | None = None,
                 degrade_pending: int | None = None,
                 degraded_sweeps: int = 4, inner_mode: str = "fused",
                 device=None):
        if sweeps < 1:
            raise ValueError(f"sweeps must be >= 1, got {sweeps}")
        if inner_mode not in ("scan", "fused"):
            raise ValueError(
                f"inner_mode must be 'scan' or 'fused', got {inner_mode!r}")
        if max_batch < 1 or max_batch & (max_batch - 1):
            raise ValueError(
                f"max_batch must be a power of two (shape bucketing), "
                f"got {max_batch}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if degrade_pending is not None and degrade_pending < 1:
            raise ValueError(
                f"degrade_pending must be >= 1, got {degrade_pending}")
        if degraded_sweeps < 1:
            raise ValueError(
                f"degraded_sweeps must be >= 1, got {degraded_sweeps}")
        self.device = resolve(device)
        self.sweeps = int(sweeps)
        self.tile = int(tile)
        self.max_batch = int(max_batch)
        self.inner_mode = inner_mode
        self.max_pending = max_pending
        self.degrade_pending = degrade_pending
        self.degraded_sweeps = int(degraded_sweeps)
        self._default_key = (rng.key(0, self.device) if default_key is None
                             else default_key.to(self.device))
        self._publish_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._buf: _Buffer | None = None
        self._queries = 0
        self._pending = 0
        self._shed = 0
        self._degraded = 0
        self._rejected_publishes = 0
        self._max_pending_seen = 0
        if snapshot is not None:
            self.publish(snapshot)

    # -- publish side ------------------------------------------------------
    def _reject(self, exc: Exception):
        with self._stats_lock:
            self._rejected_publishes += 1
        raise exc

    def publish(self, snapshot: PhiSnapshot) -> int:
        """Install a new φ buffer on the engine's device; returns its
        generation.

        The integrity gate — refuses, leaving the live buffer serving:
        format-version mismatches (:class:`FormatVersionError`);
        digest-mismatched tables (:class:`SnapshotCorruptError`); geometry
        changes against the live buffer (``ValueError``); and, when both
        the live and the candidate meta carry a trainer-side ordinal
        (``sweep``, else ``generation``), a candidate at or behind the
        live one (:class:`StaleGenerationError`).

        The copy to the device finishes *before* the swap, so readers
        never wait on it.
        """
        ver = snapshot.meta.get("format_version")
        if ver != PHI_FORMAT_VERSION:
            self._reject(FormatVersionError(
                f"refusing φ snapshot format v{ver}; this engine serves "
                f"v{PHI_FORMAT_VERSION}"))
        phi = np.asarray(snapshot.phi, np.float32)
        if phi.ndim != 2:
            self._reject(SnapshotCorruptError(
                f"φ must be (J, T); got shape {phi.shape}"))
        digest = phi_digest(phi)
        if snapshot.meta.get("digest") not in (None, digest):
            self._reject(SnapshotCorruptError(
                "φ snapshot digest mismatch — refusing to serve a corrupt "
                "table"))
        src = snapshot.meta.get("sweep", snapshot.meta.get("generation"))
        src = None if src is None else int(src)
        phi_dev = torch.tensor(phi, device=self.device)
        if phi_dev.is_cuda:
            torch.cuda.synchronize(self.device)
        with self._publish_lock:
            cur = self._buf
            if cur is not None and cur.phi.shape != phi_dev.shape:
                self._reject(ValueError(
                    f"φ geometry change {tuple(cur.phi.shape)} → "
                    f"{phi.shape}; drain and restart the engine to resize"))
            if (cur is not None and cur.source is not None
                    and src is not None and src <= cur.source):
                self._reject(StaleGenerationError(
                    f"φ snapshot source generation {src} would regress the "
                    f"live buffer's {cur.source}; refusing to move readers "
                    f"backwards"))
            gen = 1 if cur is None else cur.generation + 1
            self._buf = _Buffer(phi=phi_dev, alpha=snapshot.alpha,
                                generation=gen, digest=digest,
                                meta=dict(snapshot.meta), source=src)
        return gen

    @property
    def generation(self) -> int:
        buf = self._buf
        return 0 if buf is None else buf.generation

    # -- query side --------------------------------------------------------
    def _admit(self) -> bool:
        """Count this query in → whether it must run degraded.  Raises
        :class:`EngineOverloadedError` (shedding) when ``max_pending``
        concurrent queries are already in flight."""
        with self._stats_lock:
            pending = self._pending + 1
            if self.max_pending is not None and pending > self.max_pending:
                self._shed += 1
                raise EngineOverloadedError(
                    f"engine overloaded: {self._pending} queries in flight "
                    f"(max_pending={self.max_pending}); query shed — back "
                    f"off and retry")
            self._pending = pending
            self._max_pending_seen = max(self._max_pending_seen, pending)
            degraded = (self.degrade_pending is not None
                        and pending > self.degrade_pending)
            if degraded:
                self._degraded += 1
            return degraded

    def query(self, q: TopicQuery) -> TopicResult:
        buf = self._buf          # the one atomic read; pins the snapshot
        if buf is None:
            raise RuntimeError("LdaEngine has no published snapshot yet")
        t0 = time.perf_counter()
        docs = [np.asarray(d, np.int32).reshape(-1) for d in q.docs]
        if not docs:
            raise ValueError("TopicQuery carries no documents")
        J, T = buf.phi.shape
        for i, d in enumerate(docs):
            if d.size and (int(d.min()) < 0 or int(d.max()) >= J):
                raise ValueError(
                    f"doc {i}: word ids out of range [0, {J}): "
                    f"[{d.min()}, {d.max()}]")
        key = (self._default_key if q.key is None
               else q.key.to(self.device))
        sweeps = self.sweeps if q.sweeps is None else int(q.sweeps)
        degraded = self._admit()
        if degraded:
            sweeps = min(sweeps, self.degraded_sweeps)
        try:
            theta_out = np.empty((len(docs), T), np.float32)
            ntd_out = np.empty((len(docs), T), np.int32)
            shapes = []
            # Length-bucketed sub-batches: one outlier document must not
            # inflate L for every co-batched row (padded work is D_pad·L
            # per sweep).  Splitting is not free either — every group is
            # its own kernel launch — so only true outliers split off:
            # docs whose pow-2 length bucket stays within 4x the batch's
            # median bucket run as one group, and each bucket past the
            # cutoff runs on its own.  Row RNG is keyed by the doc's
            # *query* index, so the grouping cannot perturb any row.
            blens = [_bucket_len(d.size, self.tile) for d in docs]
            cutoff = 4 * sorted(blens)[len(blens) // 2]
            main_L = max((b for b in blens if b <= cutoff), default=0)
            by_bucket: dict[int, list[int]] = {}
            for i, b in enumerate(blens):
                by_bucket.setdefault(b if b > cutoff else main_L,
                                     []).append(i)
            for _, idxs in sorted(by_bucket.items()):
                for lo in range(0, len(idxs), self.max_batch):
                    chunk = idxs[lo:lo + self.max_batch]
                    word_ids, valid, n_real = pack_docs(
                        [docs[i] for i in chunk], tile=self.tile)
                    # pad rows are all-invalid; their key index is inert
                    idx = torch.as_tensor(
                        chunk + [chunk[-1]] * (word_ids.shape[0] - n_real),
                        device=self.device)
                    n_td, theta = _theta(
                        torch.from_numpy(word_ids).to(self.device),
                        torch.from_numpy(valid).to(self.device), buf.phi,
                        buf.alpha, doc_fold_key(key, idx), sweeps,
                        self.inner_mode)
                    theta_out[chunk] = theta[:n_real].cpu().numpy()
                    ntd_out[chunk] = n_td[:n_real].cpu().numpy()
                    shapes.append(word_ids.shape)
            with self._stats_lock:
                self._queries += 1
                shed_total, degraded_total = self._shed, self._degraded
        finally:
            with self._stats_lock:
                self._pending -= 1
        return TopicResult(
            theta=theta_out, n_td=ntd_out,
            generation=buf.generation, digest=buf.digest,
            latency_s=time.perf_counter() - t0,
            batch_shape=shapes[0] if len(shapes) == 1 else tuple(shapes),
            sweeps_used=sweeps, degraded=degraded,
            shed_total=shed_total, degraded_total=degraded_total)

    def stats(self) -> dict:
        """Engine-lifetime load/health counters (one consistent read)."""
        with self._stats_lock:
            return {
                "queries": self._queries,
                "pending": self._pending,
                "shed": self._shed,
                "degraded": self._degraded,
                "rejected_publishes": self._rejected_publishes,
                "max_pending_seen": self._max_pending_seen,
                "generation": self.generation,
            }
