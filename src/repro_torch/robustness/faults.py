"""Deterministic fault-injection harness + online invariant auditor.

``FaultInjector`` generalizes ``train.fault.FailureInjector`` from
step-keyed trainer schedules to (site, occurrence)-keyed schedules over
the whole serving stack.  Components expose named *sites* — the queue
checks ``"ingest"``/``"flush"``, the pipeline ``"pipeline.ingest"`` /
``"pipeline.publish"`` — and the schedule decides deterministically
which occurrence of which site fails, and how:

* ``"crash"`` — raise ``InjectedCrash`` (the tests' stand-in for
  process death: kill-and-restart recovery tests catch it, then
  recover from snapshot + WAL and prove bit-identity);
* ``"abort"`` — raise ``InjectedFault`` (a transient failure the
  admission-control retry loop is expected to absorb);
* ``"slow"``  — sleep ``slow_s`` (deadline/watchdog exercise);
* ``"torn_tail"`` — truncate the registered WAL file by
  ``torn_bytes`` (torn-write simulation at an arbitrary byte cut).

Schedules are exact and replayable: ``{(site, i): kind}`` fires on the
i-th check of ``site`` (0-based) and ``fired`` records what actually
triggered, so a test can assert the exact fault sequence.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["InjectedFault", "InjectedCrash", "FaultInjector",
           "tear_tail", "InvariantAuditor"]


class InjectedFault(RuntimeError):
    """A schedule-injected transient failure (retryable)."""


class InjectedCrash(InjectedFault):
    """A schedule-injected crash — the in-process stand-in for process
    death.  Retry loops must NOT absorb it (propagated through
    ``MicroBatchQueue``'s retry machinery), so a test catches it at the
    top, drops the live object, and exercises recovery."""


def tear_tail(path, nbytes: int) -> int:
    """Truncate ``nbytes`` off the end of ``path`` (torn-write
    simulation at an arbitrary, not record-aligned, cut).  Returns the
    resulting file size."""
    size = os.path.getsize(path)
    new = max(0, size - int(nbytes))
    with open(path, "r+b") as f:
        f.truncate(new)
    return new


class FaultInjector:
    """Deterministic (site, occurrence)-keyed fault schedule.

    >>> inj = FaultInjector({("ingest", 0): "abort",
    ...                      ("pipeline.publish", 2): "crash"})

    ``check(site)`` counts the call as one occurrence of ``site`` and
    fires the scheduled kind, if any (see module doc for kinds).  For
    ``"torn_tail"`` a WAL path must be registered (``wal_path=`` or
    ``register_wal``).

    Thread-safe: sites are checked from the caller thread and the
    queue's deadline-timer thread concurrently; occurrence counting
    stays exact under ``_lock`` (the slow-sleep itself runs unlocked —
    a fault must not serialize the stack it is perturbing)."""

    def __init__(self, schedule: Dict[Tuple[str, int], str], *,
                 slow_s: float = 0.05, torn_bytes: int = 1,
                 wal_path: Optional[str] = None):
        self.schedule = dict(schedule)
        self.slow_s = float(slow_s)
        self.torn_bytes = int(torn_bytes)
        self.wal_path = wal_path
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, int, str]] = []  #: guarded-by: _lock
        self._counts: Dict[str, int] = {}            #: guarded-by: _lock

    def register_wal(self, path) -> None:
        self.wal_path = str(path)

    def check(self, site: str) -> Optional[str]:
        with self._lock:
            i = self._counts.get(site, 0)
            self._counts[site] = i + 1
            kind = self.schedule.get((site, i))
            if kind is not None:
                self.fired.append((site, i, kind))
        if kind is None:
            return None
        if kind == "crash":
            raise InjectedCrash(f"injected crash at {site}#{i}")
        if kind == "abort":
            raise InjectedFault(f"injected abort at {site}#{i}")
        if kind == "slow":
            time.sleep(self.slow_s)
            return "slow"
        if kind == "torn_tail":
            if self.wal_path is None:
                raise ValueError("torn_tail fault needs a registered "
                                 "WAL path")
            tear_tail(self.wal_path, self.torn_bytes)
            return "torn_tail"
        raise ValueError(f"unknown fault kind {kind!r} at {site}#{i}")


class InvariantAuditor:
    """Online structural-invariant checks over ``Index`` /
    ``ShardedIndex`` (and optionally the serving pipeline's snapshot
    refcounts).  ``audit`` returns the violations found (and
    accumulates them); ``assert_ok`` raises on any.

    Checks per gapped array:
    * **slot + chain == n**: occupied first-level slots plus CSR chain
      entries must equal ``n_keys`` exactly;
    * CSR offsets monotone nondecreasing, final offset == chain total;
    * carried-key total order: ``slot_key`` nondecreasing;
    * pin refcount nonnegative.

    Plus epoch monotonicity per audited object (keyed by identity) and,
    when a pipeline is passed, served-epoch <= live-epoch and a live
    pin backing the served snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self.checks = 0                        #: guarded-by: _lock
        self.violations: List[str] = []        #: guarded-by: _lock
        self._last_epoch: Dict[int, int] = {}  #: guarded-by: _lock

    # ------------------------------------------------------------------
    def _audit_gapped(self, label: str, ga) -> List[str]:
        v = []
        n_slot = int(np.count_nonzero(np.asarray(ga.occupied, bool)))
        n_chain = int(ga.links.total)
        if n_slot + n_chain != int(ga.n_keys):
            v.append(f"{label}: slot({n_slot}) + chain({n_chain}) != "
                     f"n_keys({ga.n_keys})")
        offsets, lkeys, _ = ga.export_csr_links()
        if np.any(np.diff(offsets) < 0):
            v.append(f"{label}: CSR offsets not monotone")
        if int(offsets[-1]) != n_chain:
            v.append(f"{label}: CSR offsets[-1]={int(offsets[-1])} != "
                     f"chain total {n_chain}")
        sk = np.asarray(ga.slot_key, np.float64)
        finite = sk[np.isfinite(sk)]
        if finite.size and np.any(np.diff(finite) < 0):
            v.append(f"{label}: slot_key total order violated")
        pins = getattr(ga, "_pins", None)
        if pins is not None and pins.count < 0:
            v.append(f"{label}: negative snapshot pin count "
                     f"({pins.count})")
        return v

    def audit(self, index, pipeline=None) -> List[str]:
        v: List[str] = []
        if hasattr(index, "shards"):
            for i, sh in enumerate(index.shards):
                v += self._audit_gapped(f"shard[{i}]", sh.gapped)
        elif getattr(index, "gapped", None) is not None:
            v += self._audit_gapped("index", index.gapped)
        epoch = int(index.epoch)
        with self._lock:
            last = self._last_epoch.get(id(index))
            if last is not None and epoch < last:
                v.append(f"epoch went backwards: {last} -> {epoch}")
            self._last_epoch[id(index)] = epoch
        if pipeline is not None:
            if pipeline.epoch > epoch:
                v.append(f"served epoch {pipeline.epoch} ahead of live "
                         f"epoch {epoch}")
            snap = pipeline._snapshot
            snaps = getattr(snap, "_snaps", None)
            for g in (snaps if snaps is not None else [snap._snap]):
                if not g.pinned:
                    v.append("served snapshot lost its pin while "
                             "installed")
        with self._lock:
            self.checks += 1
            self.violations += v
        return v

    def assert_ok(self, index, pipeline=None) -> None:
        v = self.audit(index, pipeline=pipeline)
        if v:
            raise AssertionError("invariant violations: " + "; ".join(v))
