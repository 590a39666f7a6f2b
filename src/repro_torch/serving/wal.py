"""Append-only ingest write-ahead log + crash recovery.

Record framing (little-endian, self-delimiting, torn-tail tolerant)::

    [magic u32 "WAL1"] [type u8] [body_len u32] [body ...] [crc32 u32]

* ``type=1`` (BATCH): body = ``n u32`` + ``n`` f64 keys + ``n`` i64
  payloads — one ingest batch, logged BEFORE it is applied.
* ``type=2`` (FENCE): body = ``epoch i64`` — an epoch-publish marker
  (``EpochPipeline.publish``); fences force an fsync, so every record
  below the last fence is durable.

The CRC covers ``type + body_len + body``, so a record is valid iff its
frame is complete AND its checksum matches.  ``replay`` walks records
front-to-back and stops cleanly at the first incomplete or corrupt
frame — a crash mid-write (torn tail) loses at most the record being
written, never earlier history.  Writes are flushed to the OS per
record (so ``lsn`` byte offsets are exact) and ``fsync``-batched every
``sync_every`` records (durability/throughput knob; fences always
sync).

Recovery (``recover_index``) = ``Index.restore`` of the newest
checkpoint (written through ``train/checkpoint.py``'s array
serialization — same format as trainer checkpoints) + replay of every
BATCH record past the checkpoint's recorded ``wal_lsn``.  Replay calls
``Index.ingest`` with the original batches in original order, which is
bit-identical to the uninterrupted run by the repo's proven ingest
determinism contracts (see tests/test_wal_recovery.py).

This module is the reference's ``repro.serving.wal`` with the same
framing, so either package replays the other's log; ``recover_index``
takes the restored index's ``device``.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np

from ..core.keys64 import write_keys

__all__ = ["IngestWAL", "WALRecord", "replay", "truncate_torn_tail",
           "recover_index"]

_MAGIC = 0x314C4157  # "WAL1" little-endian
_HDR = struct.Struct("<IBI")  # magic, type, body_len
_CRC = struct.Struct("<I")
REC_BATCH = 1
REC_FENCE = 2


class WALRecord(NamedTuple):
    kind: str                      # "batch" | "fence"
    keys: Optional[np.ndarray]    # f64 (batch) or None
    payloads: Optional[np.ndarray]  # i64 (batch) or None
    epoch: int                     # fence epoch (-1 for batch)
    lsn: int                       # byte offset PAST this record


class IngestWAL:
    """Append-only CRC-framed ingest log (one writer, crash-tolerant).

    ``append``/``fence`` return the record's ``lsn`` — the byte offset
    just past it.  A checkpoint taken at ``wal_lsn = wal.lsn`` plus a
    replay of records with ``lsn > wal_lsn`` reconstructs the exact
    pre-crash state (write-ahead discipline: log first, apply second).

    ``sync_every`` is either a record count (fsync every N records,
    the fixed group-commit knob) or ``"adaptive"`` — load-adaptive
    group commit: when writes arrive sparsely (inter-write gap above
    ``idle_s``) every record is fsynced on the spot (durability is
    cheap when the disk is idle and there is no batch to amortize
    into); under a burst, fsyncs are TIME-batched — at most one per
    ``burst_window_s`` — so a write storm pays O(elapsed/window)
    fsyncs instead of O(records/N).  Only fsync *cadence* changes:
    framing and per-record flushes are identical, so the torn-tail
    recovery property ("kill at any byte") is unaffected.

    Thread-safe: the serving stack appends from the caller thread and
    the deadline-timer thread concurrently; every public method takes
    ``_lock`` (reentrant — ``fence`` nests ``sync``).
    """

    def __init__(self, path, sync_every: Union[int, str] = 8,
                 idle_s: float = 0.005, burst_window_s: float = 0.005):
        self.path = str(path)
        self.adaptive = sync_every == "adaptive"
        self.sync_every = (1 if self.adaptive
                           else max(1, int(sync_every)))
        self.idle_s = float(idle_s)
        self.burst_window_s = float(burst_window_s)
        self._lock = threading.RLock()
        self._f = open(self.path, "ab")   #: guarded-by: _lock
        self._since_sync = 0              #: guarded-by: _lock
        self._last_write_t = 0.0          #: guarded-by: _lock
        self._last_sync_t = 0.0           #: guarded-by: _lock
        #: guarded-by: _lock
        self.stats = {"records": 0, "fences": 0, "syncs": 0,
                      "idle_syncs": 0, "window_syncs": 0}

    @property
    def lsn(self) -> int:
        with self._lock:
            return self._f.tell()

    def _sync_now(self) -> None:
        """lock-held: _lock (internal half of ``sync``)."""
        self._f.flush()
        os.fsync(self._f.fileno())
        self._since_sync = 0
        self._last_sync_t = time.monotonic()
        self.stats["syncs"] += 1

    def _maybe_sync_adaptive(self, now: float) -> None:
        """lock-held: _lock.  The load-adaptive group-commit policy
        (see class doc): idle -> sync per record; burst -> one sync per
        ``burst_window_s`` of elapsed time."""
        gap = now - self._last_write_t
        if gap > self.idle_s:
            self.stats["idle_syncs"] += 1
            self._sync_now()
        elif now - self._last_sync_t >= self.burst_window_s:
            self.stats["window_syncs"] += 1
            self._sync_now()

    def _write(self, rtype: int, body: bytes) -> int:
        """lock-held: _lock (append/fence wrap this)."""
        hdr = _HDR.pack(_MAGIC, rtype, len(body))
        crc = zlib.crc32(hdr[4:] + body)  # covers type+len+body
        self._f.write(hdr + body + _CRC.pack(crc))
        self._f.flush()  # OS-visible immediately: lsn/tell stays exact
        self.stats["records"] += 1
        self._since_sync += 1
        if self.adaptive:
            now = time.monotonic()
            self._maybe_sync_adaptive(now)
            self._last_write_t = now
        elif self._since_sync >= self.sync_every:
            self._sync_now()
        return self._f.tell()

    def append(self, keys, payloads) -> int:
        keys = np.ascontiguousarray(np.atleast_1d(
            write_keys(keys, "IngestWAL.append")))
        pays = np.ascontiguousarray(np.atleast_1d(
            np.asarray(payloads, np.int64)))
        if keys.shape != pays.shape:
            raise ValueError("IngestWAL.append: payloads must match "
                             "keys 1:1")
        body = (struct.pack("<I", keys.shape[0])
                + keys.tobytes() + pays.tobytes())
        with self._lock:
            return self._write(REC_BATCH, body)

    def fence(self, epoch: int) -> int:
        with self._lock:
            lsn = self._write(REC_FENCE, struct.pack("<q", int(epoch)))
            self._sync_now()  # a published epoch is always durable
            self.stats["fences"] += 1
            return lsn

    def sync(self) -> None:
        with self._lock:
            self._sync_now()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._sync_now()
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def replay(path) -> Tuple[List[WALRecord], int, bool]:
    """Parse a WAL file -> ``(records, valid_end, torn)``.

    Walks frames front-to-back; stops at the first incomplete frame,
    bad magic, CRC mismatch, or malformed body.  ``valid_end`` is the
    byte offset of the last fully valid record (everything past it is
    the torn/corrupt tail, reported via ``torn``).  A missing file is
    an empty log, not an error.
    """
    if not os.path.exists(path):
        return [], 0, False
    data = open(path, "rb").read()
    records: List[WALRecord] = []
    pos, n = 0, len(data)
    while pos < n:
        if pos + _HDR.size > n:
            return records, pos, True
        magic, rtype, blen = _HDR.unpack_from(data, pos)
        body_end = pos + _HDR.size + blen
        if magic != _MAGIC or body_end + _CRC.size > n:
            return records, pos, True
        body = data[pos + _HDR.size: body_end]
        (crc,) = _CRC.unpack_from(data, body_end)
        if crc != zlib.crc32(data[pos + 4: body_end]):
            return records, pos, True
        end = body_end + _CRC.size
        if rtype == REC_BATCH:
            if blen < 4:
                return records, pos, True
            (cnt,) = struct.unpack_from("<I", body)
            if blen != 4 + 16 * cnt:
                return records, pos, True
            keys = np.frombuffer(body, np.float64, cnt, offset=4).copy()
            pays = np.frombuffer(body, np.int64, cnt,
                                 offset=4 + 8 * cnt).copy()
            records.append(WALRecord("batch", keys, pays, -1, end))
        elif rtype == REC_FENCE:
            if blen != 8:
                return records, pos, True
            (epoch,) = struct.unpack_from("<q", body)
            records.append(WALRecord("fence", None, None, int(epoch),
                                     end))
        else:
            return records, pos, True  # unknown type: treat as torn
        pos = end
    return records, pos, False


def truncate_torn_tail(path) -> int:
    """Trim a torn/corrupt tail in place -> bytes dropped (0 if clean).

    After this the file ends on a record boundary and a fresh
    ``IngestWAL`` can append to it safely."""
    _, valid_end, torn = replay(path)
    if not torn:
        return 0
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(valid_end)
    return size - valid_end


def recover_index(snapshot_dir, wal_path, *, step: Optional[int] = None,
                  device=None):
    """Crash recovery: newest checkpoint + WAL-tail replay.

    Returns ``(index, report)`` where ``index`` is a single-device
    ``Index`` or a ``ShardedIndex`` (dispatched on what the checkpoint
    directory holds) restored to the exact pre-crash state, its device
    state on ``device`` (cuda unless ``device="cpu"``), and ``report``
    records ``{"replayed", "skipped", "torn", "valid_end",
    "restored_step"}``.  Records at or below the checkpoint's
    ``wal_lsn`` are already folded into the snapshot and skipped; the
    torn tail (if any) is ignored, exactly like ``replay``.
    """
    sharded_manifest = os.path.join(str(snapshot_dir),
                                    "sharded_manifest.json")
    if os.path.exists(sharded_manifest):
        from ..dist.sharded import ShardedIndex
        idx, extra = ShardedIndex.restore(snapshot_dir, step=step,
                                          device=device)
    else:
        from ..core.handle import Index
        idx, extra = Index.restore(snapshot_dir, step=step, device=device)
    lsn0 = int(extra.get("wal_lsn", 0))
    records, valid_end, torn = replay(wal_path)
    replayed = skipped = 0
    for rec in records:
        if rec.kind != "batch":
            continue
        if rec.lsn <= lsn0:
            skipped += 1
            continue
        idx.ingest(rec.keys, rec.payloads)
        replayed += 1
    return idx, {"replayed": replayed, "skipped": skipped, "torn": torn,
                 "valid_end": valid_end,
                 "restored_step": extra.get("step")}
