"""Serving layer of the port: snapshot isolation, the ingest WAL with
crash recovery, admission control and self-tuning retrain — the
reference's serving and durability contract (``repro.serving``), on
the port's ``Index``:

* **Snapshot isolation** (``pipeline.EpochPipeline``): lookups serve a
  pinned immutable snapshot of epoch N while ingest builds epoch N+1 on
  the live index; ``publish()`` pins the new epoch completely and swaps
  the served reference in one assignment.  A snapshot lookup equals a
  quiesced lookup at its epoch bit for bit.
* **Durability** (``wal.IngestWAL`` + ``core.Index.save_snapshot``):
  ingests are CRC-framed to a write-ahead log before they are applied,
  ``publish`` fences the epoch (fsync), ``EpochPipeline.checkpoint``
  snapshots the live index with the current WAL offset, and
  ``wal.recover_index`` = newest snapshot + WAL-tail replay reproduces
  the acked state after a crash at any byte.  Log and snapshots are
  byte-compatible with the reference's.
* **Admission control** (``engine.MicroBatchQueue``): bounded depth
  with a typed ``Overloaded`` shed, a ``max_wait_ms`` deadline flush,
  and ingest retry whose last attempt takes the host partition path.
  ``robustness.InjectedCrash`` always propagates.
* **Self-tuning retrain** (``EpochPipeline.retrain`` and its MDL-drift
  trigger): a §4 sampled refit of the live key set behind the pinned
  snapshot, served from the next ``publish()``.

``pipeline.py`` is a verbatim copy of the reference's; ``wal.py`` and
``MicroBatchQueue`` are copies whose differences are named in their
modules.  All of it serves a ``dist.ShardedIndex`` as well: the pipeline
pins a ``ShardedSnapshot``, the queue's flush is one fan-out lookup,
and ``recover_index`` restores a sharded checkpoint directory.
``kv_cache.PagedKVCache`` is the paged-KV block table over the index,
and ``engine.ServingEngine`` the LLM decode loop over it: one batched
page lookup a round through a ``MicroBatchQueue``.
"""

from ..core.results import Overloaded
from .engine import MicroBatchQueue, Request, ServingEngine
from .kv_cache import PagedKVCache
from .pipeline import (EpochPipeline, IndexSnapshot, ShardedSnapshot,
                       pin_index)
from .wal import IngestWAL, WALRecord, recover_index, replay

__all__ = [
    "EpochPipeline",
    "IndexSnapshot",
    "IngestWAL",
    "MicroBatchQueue",
    "Overloaded",
    "PagedKVCache",
    "Request",
    "ServingEngine",
    "ShardedSnapshot",
    "WALRecord",
    "pin_index",
    "recover_index",
    "replay",
]
