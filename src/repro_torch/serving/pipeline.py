"""Snapshot-isolated epoch pipelining for concurrent serving.

The epoch-versioned handle (``core.handle.Index``) is one synchronous
object: a lookup issued while an ingest is mutating it observes
whatever intermediate state the mutation left.  ``EpochPipeline``
double-buffers instead:

* **lookups** run against a *pinned immutable snapshot* of epoch N —
  the frozen first-level arrays + CSR link image captured by
  ``GappedArray.pin_snapshot()`` (zero-copy: the live side pays one
  copy-on-write per pin on its first post-pin mutation, see
  ``core/gaps.py``);
* **ingest** applies to the live index, building epoch N+1 (delta
  application / refreeze proceed on the live buffers — the snapshot
  never sees them);
* ``publish()`` pins N+1 *completely* and then swaps the served
  reference in one assignment — barrier-free: there is no window in
  which a lookup can observe a half-built epoch, because the old
  snapshot stays valid until the swap and the new one is immutable
  before it.

Typed results carry the epoch they were served at (``LookupResult
.epoch``).  Bit-identity: a snapshot lookup runs the proven
``GappedArray.lookup_batch`` host path over the pinned arrays, and the
repo's backend contract (fused / pallas / oracle identical payloads,
slots, found — tests/test_kernel_lookup.py, tests/test_fused_ingest.py)
makes that bit-identical to ANY quiesced lookup at the snapshot epoch.
The same holds per shard for ``ShardedIndex`` (``ShardedSnapshot`` pins
every shard plus the router boundaries and slot bases, mirroring the
exact host route).

Durability hooks: give the pipeline an ``IngestWAL`` and every ingest
is logged *before* it is applied (write-ahead), ``publish`` fences the
epoch (fsync), and ``checkpoint()`` snapshots the live index through
``Index.save_snapshot`` with the current WAL offset — crash recovery
is ``serving.wal.recover_index``.

The module is the reference's, with one departure: it keeps the index's
key dtype (``key_dtype``: float64, or uint64 for an index on the exact
64-bit image, ``core.keys64``) through ``IndexSnapshot.lookup``, and
``ingest`` refuses keys that need that image before the WAL logs them
(``keys64.write_keys``), so nothing rounds a 64-bit key.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..core import keys64 as _k64
from ..core.results import LookupResult

__all__ = ["EpochPipeline", "IndexSnapshot", "ShardedSnapshot",
           "pin_index"]


class IndexSnapshot:
    """Pinned immutable serving snapshot of a single-device ``Index``.

    Refcounted: the pipeline holds one reference for the published
    snapshot; in-flight readers ``retain()`` before serving and
    ``release()`` after, so a concurrent ``publish()`` swapping the
    snapshot out cannot unpin the ``GapSnapshot`` (and stop its
    copy-on-write protection) under a reader mid-``lookup_batch``.
    The underlying pin drops only when the last reference goes."""

    def __init__(self, index):
        if index.gapped is None:
            raise ValueError(
                "snapshot serving needs a gapped build (gap_rho > 0); "
                "a static index has no mutation to isolate against")
        self.epoch = int(index.epoch)
        self._u64 = _k64.is_u64(index.keys)
        self._snap = index.gapped.pin_snapshot()
        self._refs = 1
        self._refs_lock = threading.Lock()

    @property
    def n_keys(self) -> int:
        return self._snap.n_keys

    def lookup(self, queries) -> LookupResult:
        queries = np.atleast_1d(np.asarray(queries) if self._u64 else
                                np.asarray(queries, np.float64))
        pay, slot, found = self._snap.lookup_batch(queries, full=True)
        return LookupResult(payloads=pay, slots=slot, found=found,
                            backend="snapshot", epoch=self.epoch)

    def retain(self) -> "IndexSnapshot":
        with self._refs_lock:
            if self._refs <= 0:
                raise RuntimeError("retain() on a released snapshot")
            self._refs += 1
        return self

    def release(self) -> None:
        with self._refs_lock:
            self._refs -= 1
            last = self._refs == 0
        if last:
            self._snap.release()


class ShardedSnapshot:
    """Pinned immutable serving snapshot of a ``ShardedIndex``: one
    ``GapSnapshot`` per shard plus the router boundaries and slot bases
    frozen at pin time, so routing and the per-shard slot offsets match
    the pinned topology even across a concurrent ``split_shard``."""

    def __init__(self, sharded):
        self.epoch = int(sharded.epoch)
        self._bounds = sharded.router.bounds.copy()
        self._bases = sharded._slot_bases().copy()
        self._snaps = [sh.gapped.pin_snapshot() for sh in sharded.shards]
        self._refs = 1
        self._refs_lock = threading.Lock()

    @property
    def n_keys(self) -> int:
        return int(sum(s.n_keys for s in self._snaps))

    def lookup(self, queries) -> LookupResult:
        queries = np.atleast_1d(np.asarray(queries, np.float64))
        n = queries.shape[0]
        # exact route against the PINNED boundaries (route-left, same
        # rule as ShardRouter.route)
        dst = (np.searchsorted(self._bounds, queries, side="right")
               if self._bounds.size else np.zeros(n, np.int64))
        pay = np.full(n, -1, np.int64)
        slot = np.full(n, -1, np.int64)
        found = np.zeros(n, bool)
        for s in np.unique(dst):
            rows = np.flatnonzero(dst == s)
            p, sl, f = self._snaps[s].lookup_batch(queries[rows],
                                                   full=True)
            pay[rows] = p
            slot[rows] = np.where(sl >= 0, sl + self._bases[s], -1)
            found[rows] = f
        return LookupResult(payloads=pay, slots=slot, found=found,
                            backend="snapshot", epoch=self.epoch)

    def retain(self) -> "ShardedSnapshot":
        with self._refs_lock:
            if self._refs <= 0:
                raise RuntimeError("retain() on a released snapshot")
            self._refs += 1
        return self

    def release(self) -> None:
        with self._refs_lock:
            self._refs -= 1
            last = self._refs == 0
        if last:
            for s in self._snaps:
                s.release()


def pin_index(index):
    """Pin the appropriate snapshot type for ``index`` (duck-typed on
    ``shards``, like ``MicroBatchQueue``)."""
    if hasattr(index, "shards"):
        return ShardedSnapshot(index)
    return IndexSnapshot(index)


class EpochPipeline:
    """Double-buffered serving front over an ``Index``/``ShardedIndex``
    (see module doc).  Duck-type compatible with the handles where it
    matters — ``lookup(queries)`` / ``ingest(keys, payloads)`` /
    ``epoch`` / ``stats`` — so ``MicroBatchQueue`` aggregates over a
    pipeline unchanged.

    * ``wal``: optional ``serving.wal.IngestWAL`` — ingests are logged
      before application, ``publish`` fences the epoch.
    * ``publish_every``: auto-publish after that many ingests (None =
      manual ``publish()`` only).
    * ``auditor`` + ``audit_every``: optional
      ``robustness.faults.InvariantAuditor`` sampled every N ingests
      (every ingest when 1 — the tests' setting).
    * ``faults``: optional ``robustness.faults.FaultInjector``; sites
      ``"pipeline.ingest"`` and ``"pipeline.publish"`` are checked on
      the way in (deterministic crash/slow/abort injection).
    * ``retrain_mdl_drift`` + ``retrain_check_every``: MDL-drift
      retrain daemon — every N ``publish()`` calls the live index is
      scored under the §3 MDL framework and a relative description-
      length growth past the threshold (vs the last retrain's baseline)
      triggers ``retrain()`` automatically, closing the PR-9 "retrain
      triggering is caller policy" loop.  The retrained epoch is served
      from the NEXT publish (same isolation as a manual retrain).

    Thread safety: ``MicroBatchQueue``'s deadline timer drives
    ``ingest``/``publish`` from a daemon thread concurrent with caller-
    thread lookups — all snapshot/stat state is guarded by ``_lock``,
    and readers serve a ``retain()``-ed snapshot so a concurrent
    publish can never unpin it mid-read.
    """

    def __init__(self, index, *, wal=None,
                 publish_every: Optional[int] = None,
                 auditor=None, audit_every: int = 0, faults=None,
                 retrain_mdl_drift: Optional[float] = None,
                 retrain_check_every: int = 1):
        self.index = index
        self.wal = wal
        self.publish_every = publish_every
        self.auditor = auditor
        self.audit_every = int(audit_every)
        self.faults = faults
        self.retrain_mdl_drift = retrain_mdl_drift
        self.retrain_check_every = max(1, int(retrain_check_every))
        # reentrant: ingest() auto-publishes, publish() may auto-retrain
        self._lock = threading.RLock()
        self._snapshot = pin_index(index)     #: guarded-by: _lock
        self._ingests_since_publish = 0       #: guarded-by: _lock
        #: guarded-by: _lock
        self._mdl_baseline = (self._mdl_score()
                              if retrain_mdl_drift is not None else None)
        #: guarded-by: _lock
        self.stats = {"publishes": 0, "snapshot_lookups": 0,
                      "live_lookups": 0, "ingests": 0, "wal_records": 0,
                      "max_lag": 0, "audits": 0, "retrains": 0,
                      "mdl_retrains": 0, "mdl_checks": 0}

    # ------------------------------------------------------------------
    def _mdl_score(self) -> Optional[float]:
        """lock-held: _lock (init runs single-owner).  Total description
        length of the live index, None when it cannot be scored (no
        ``mdl`` on the handle — e.g. a ShardedIndex)."""
        fn = getattr(self.index, "mdl", None)
        if fn is None:
            return None
        return float(fn().mdl)  # MDLReport.mdl is a property

    @property
    def epoch(self) -> int:
        """Epoch lookups are currently served at (the pinned snapshot)."""
        with self._lock:
            return self._snapshot.epoch

    @property
    def live_epoch(self) -> int:
        return int(self.index.epoch)

    @property
    def key_dtype(self) -> np.dtype:
        return getattr(self.index, "key_dtype", np.dtype(np.float64))

    @property
    def lag(self) -> int:
        """Mutations applied to the live index but not yet published.
        Live and snapshot epochs are read under the lock — one
        consistent pair, not two racing reads."""
        with self._lock:
            return int(self.index.epoch) - self._snapshot.epoch

    # ------------------------------------------------------------------
    def lookup(self, queries, *, backend: Optional[str] = None
               ) -> LookupResult:
        """Serve a lookup at the published snapshot epoch.

        When the live index is quiesced at the snapshot epoch the call
        delegates to ``index.lookup`` (device backends and their
        telemetry) — bit-identical to the snapshot by the backend
        contract; the lock is held across the delegated call so a
        concurrent ingest cannot mutate the live index mid-lookup.
        While ingest is in flight (live epoch ahead), the pinned
        snapshot serves — retained first, so a concurrent ``publish``
        releasing its reference cannot unpin it under the reader."""
        with self._lock:
            snap = self._snapshot
            if int(self.index.epoch) == snap.epoch:
                self.stats["live_lookups"] += 1
                return self.index.lookup(queries, backend=backend)
            self.stats["snapshot_lookups"] += 1
            snap.retain()
        try:
            return snap.lookup(queries)
        finally:
            snap.release()

    def ingest(self, keys, payloads):
        """Apply an ingest batch to the LIVE index (epoch N+1 under
        construction); logged to the WAL first when one is attached.
        Lookups keep serving the pinned snapshot until ``publish``.
        The lock spans log+apply, so WAL append order is apply order
        even with the deadline-timer thread ingesting concurrently."""
        if self.faults is not None:
            self.faults.check("pipeline.ingest")
        keys = np.atleast_1d(_k64.write_keys(
            keys, "EpochPipeline.ingest", self.key_dtype == np.uint64))
        payloads = np.atleast_1d(np.asarray(payloads, np.int64))
        with self._lock:
            if self.wal is not None:
                self.wal.append(keys, payloads)  # write-ahead: log, THEN apply
                self.stats["wal_records"] += 1
            rep = self.index.ingest(keys, payloads)
            self.stats["ingests"] += 1
            self.stats["max_lag"] = max(
                self.stats["max_lag"],
                int(self.index.epoch) - self._snapshot.epoch)
            self._ingests_since_publish += 1
            if (self.auditor is not None and self.audit_every
                    and self.stats["ingests"] % self.audit_every == 0):
                self.stats["audits"] += 1
                self.auditor.assert_ok(self.index, pipeline=self)
            if (self.publish_every is not None
                    and self._ingests_since_publish >= self.publish_every):
                self.publish()
            return rep

    def retrain(self, sample_rate: Optional[float] = None,
                **kwargs) -> dict:
        """Sampled refit of the LIVE index (``Index.retrain`` /
        ``ShardedIndex.retrain``) behind the snapshot: the retrain
        REPLACES the live arrays (never mutates them), so the pinned
        snapshot keeps serving its epoch bit-identically for the whole
        rebuild — epoch N+1 here is a fresh mechanism + layout instead
        of an ingest delta, the "refreeze is a dial" path.  Call
        ``publish()`` to start serving the retrained epoch."""
        with self._lock:
            rec = self.index.retrain(sample_rate=sample_rate, **kwargs)
            self.stats["retrains"] = self.stats.get("retrains", 0) + 1
            self.stats["max_lag"] = max(
                self.stats["max_lag"],
                int(self.index.epoch) - self._snapshot.epoch)
            if self._mdl_baseline is not None:
                self._mdl_baseline = self._mdl_score()
            return rec

    def _maybe_retrain_on_drift(self) -> None:
        """lock-held: _lock (publish() calls under its lock).  The MDL-
        drift daemon: score the live index every ``retrain_check_every``
        publishes; relative growth past ``retrain_mdl_drift`` triggers
        a retrain (which resets the baseline)."""
        if self.retrain_mdl_drift is None or self._mdl_baseline is None:
            return
        if self.stats["publishes"] % self.retrain_check_every != 0:
            return
        self.stats["mdl_checks"] += 1
        score = self._mdl_score()
        if score is None:
            return
        if score > self._mdl_baseline * (1.0 + self.retrain_mdl_drift):
            self.stats["mdl_retrains"] += 1
            self.retrain()

    def publish(self) -> int:
        """Pin epoch N+1 completely, then swap the served reference
        under the lock (no partially built epoch is ever observable)
        and drop the pipeline's reference to the old pin — readers that
        ``retain()``-ed it finish undisturbed; the unpin happens when
        the last reference goes.  Fences the WAL, then runs the MDL-
        drift check.  Returns the newly served epoch."""
        if self.faults is not None:
            self.faults.check("pipeline.publish")
        with self._lock:
            new = pin_index(self.index)  # fully pinned BEFORE the swap
            old, self._snapshot = self._snapshot, new
            old.release()
            self._ingests_since_publish = 0
            if self.wal is not None:
                self.wal.fence(new.epoch)
            self.stats["publishes"] += 1
            self._maybe_retrain_on_drift()
            return new.epoch

    # ------------------------------------------------------------------
    def checkpoint(self, directory, *, step: Optional[int] = None,
                   keep: int = 3) -> str:
        """Snapshot the live index to ``directory`` with the current
        WAL offset recorded — the recovery anchor for
        ``serving.wal.recover_index``.  Locked so the saved state and
        the recorded LSN are one consistent cut."""
        with self._lock:
            lsn = int(self.wal.lsn) if self.wal is not None else 0
            return self.index.save_snapshot(directory, step=step,
                                            keep=keep, wal_lsn=lsn)

    def close(self) -> None:
        with self._lock:
            self._snapshot.release()
            if self.wal is not None:
                self.wal.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
