"""Typed results for the unified ``repro.core.Index`` handle.

Every read returns a ``LookupResult`` and every write returns an
``IngestReport`` — one contract across host and device backends, static
and gapped builds (before this, static builds returned position arrays,
gapped builds payload arrays, and dynamic ops ad-hoc dicts/strings).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["LookupResult", "IngestReport", "Overloaded"]


@dataclasses.dataclass(frozen=True)
class LookupResult:
    """Result of ``Index.lookup`` (one batch).

    * ``payloads`` — (n,) int64; -1 for absent keys.  For static (no-gap)
      builds the payload of key i is its position i, so this doubles as
      the classic position array.
    * ``slots``    — (n,) int64 physical slot of each query's upper bound
      in the first-level array (-1 below all keys).
    * ``found``    — (n,) bool: key present (first-level slot hit OR
      linking-chain hit).  Distinguishes "absent" from "stored payload
      happens to be -1".
    * ``backend``  — the search stage that actually ran: ``pallas`` /
      ``xla-windowed`` / ``numpy-oracle``, or ``device-oracle`` when the
      engine's size-aware scheduler ran the full-array device search for
      a small default-resolved batch (explicit backend requests are
      forced and never relabeled).
    * ``epoch``    — index epoch the answer was computed against.
    * ``fallbacks`` — device-path queries re-resolved through the
      compacted fallback buffer (0 on the host backend).
    * ``oracle_escapes`` — whole-batch oracle escapes taken (compaction
      buffer overflow; rare by construction).
    """

    payloads: np.ndarray
    slots: np.ndarray
    found: np.ndarray
    backend: str
    epoch: int
    fallbacks: int = 0
    oracle_escapes: int = 0

    def __len__(self) -> int:
        return int(self.payloads.shape[0])

    def __array__(self, dtype=None):
        # legacy interop: np.asarray(result) is the old payload array
        a = self.payloads
        return a if dtype is None else a.astype(dtype)


@dataclasses.dataclass(frozen=True)
class IngestReport:
    """Result of ``Index.ingest`` (one batch of (key, payload) pairs).

    * ``n`` — batch size; ``slot`` / ``chain`` — §5.3 placement path
      counts (gap slot vs linking chain).  Invariant (asserted):
      ``slot + chain == n`` — every ingested key lands on exactly one
      path.
    * ``contested`` — how many keys visited the scalar arrival-order
      replay, summed over ALL recursive partition rounds (the contested
      remainder driving the refreeze policy); always ``<= n``.
    * ``placement`` — where the placement primitives were computed:
      ``"host"`` (numpy partition), ``"device"`` (the ingest-place
      kernel/fused-XLA backend against the frozen device arrays, exact
      by the per-key pair-exactness gate), or ``"device-verified"``
      (device primitives against a merely alias-free wide key set,
      validated row-by-row on the host in f64 with failing rows
      recomputed per-key — the widened-gate mode).
    * ``epoch`` — host epoch after the ingest.
    * ``device`` — how the frozen device state was brought forward:
      ``"none"`` (no device state materialized yet — it will freeze
      lazily on the next device lookup), ``"fused"`` (the single-
      dispatch ingest wrote the device buffers in-graph — placement,
      slot scatter, CSR merge, and rank/bound refresh in ONE dispatch;
      nothing was re-uploaded), ``"delta"`` (in-place scatter of
      changed slot/payload entries + CSR link tail appends), or
      ``"refreeze"`` (full rebuild: a threshold crossed or a capacity /
      dtype static changed).
    * ``device_elems`` — elements scattered on the delta path.
    * ``seconds`` — wall time of the whole ingest (host + device sync).
    * ``abort_reasons`` — names of the in-graph abort bits the fused
      single-dispatch write tripped on for THIS batch (empty when no
      fused dispatch ran or it committed): ``contested`` / ``d1_demote``
      / ``chain_overflow`` / ... (``kernels.ops_gap.FUSED_ABORT_BITS``).
      An aborted batch still lands (host partition path), so a non-empty
      tuple plus ``device != "fused"`` reads as "fused tried, vetoed".
    * ``fused_aborts`` — the ENGINE's cumulative fused-abort counter
      after this ingest (``Index.stats["fused_abort_total"]``), so a
      benchmark row answers "how often does the write graph veto" from
      the report stream alone.
    * ``split_commits`` — cumulative split-commit counter
      (``Index.stats["split_commits"]``): fused dispatches that aborted
      but salvaged the closure-trivial prefix in-graph, replaying only
      the contested remainder on the host path (``placement ==
      "device-split"`` when THIS batch took that arm).
    """

    n: int
    slot: int
    chain: int
    contested: int
    epoch: int
    device: str = "none"
    device_elems: int = 0
    seconds: float = 0.0
    placement: str = "host"
    abort_reasons: tuple = ()
    fused_aborts: int = 0
    split_commits: int = 0

    def __post_init__(self):
        if self.slot + self.chain != self.n:
            raise AssertionError(
                f"IngestReport count invariant violated: slot={self.slot} "
                f"+ chain={self.chain} != n={self.n}")
        if not 0 <= self.contested <= self.n:
            raise AssertionError(
                f"IngestReport contested={self.contested} outside "
                f"[0, n={self.n}]")

    @property
    def contested_fraction(self) -> float:
        return self.contested / max(self.n, 1)


@dataclasses.dataclass(frozen=True)
class Overloaded:
    """Typed backpressure shed from the serving queue.

    Returned (never raised) by ``MicroBatchQueue.result`` for a ticket
    the queue refused at admission because the pending depth was at
    ``max_depth`` — the explicit alternative to a silent hang or an
    unbounded queue.  Falsy (``bool(Overloaded(...)) is False``) so
    callers can branch ``if not res: retry_later()`` uniformly against
    ``LookupResult``/``IngestReport``.

    * ``kind``   — ``"lookup"`` or ``"ingest"`` (which submission shed).
    * ``depth``  — pending submissions at shed time.
    * ``max_depth`` — the configured bound the submission hit.
    * ``epoch``  — index epoch at shed time (for client-side retry
      bookkeeping; -1 if the backend exposes none).
    """

    kind: str
    depth: int
    max_depth: int
    epoch: int = -1

    def __bool__(self) -> bool:
        return False


def host_lookup_result(payloads: np.ndarray, slots: Optional[np.ndarray],
                       found: Optional[np.ndarray], backend: str,
                       epoch: int) -> LookupResult:
    """Assemble a LookupResult, defaulting slots/found from payloads."""
    payloads = np.asarray(payloads)
    if found is None:
        found = payloads >= 0
    if slots is None:
        slots = np.full(payloads.shape[0], -1, np.int64)
    return LookupResult(payloads=payloads.astype(np.int64),
                        slots=np.asarray(slots, np.int64),
                        found=np.asarray(found, bool),
                        backend=backend, epoch=epoch)
