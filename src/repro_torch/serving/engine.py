"""The decode loop over the learned-index block table
(``ServingEngine``) and cross-caller batch aggregation for index calls
(``MicroBatchQueue``).

``ServingEngine`` is the reference's ``repro.serving.engine``
scheduler: FIFO admission up to ``max_batch`` concurrent requests; each
round decodes one token for every active request (static batch slots,
padded).  The paged KV block table is the gapped learned index
(``kv_cache.PagedKVCache``): every round resolves the current page of
each active request with ONE batched lookup through a
``MicroBatchQueue`` (padded to its 512-query bucket, so one
fused-lookup kernel launch on the card) and allocates the misses in
one batch.  What is kept as the reference has it, by design: one
``cache_index`` for every slot, no prefill of the prompt (decoding
starts from the prompt's last token), the coalesced admission
``alloc_batch``, ``free_request`` on completion, and the final
``kv_*`` stats.  The model step is the eager ``model.decode_fn`` (the
reference jits it).  Sampling at ``temperature > 0`` draws with a
``torch.Generator`` seeded by the round, which cannot reproduce
``jax.random.categorical``'s draws; ``temperature <= 0`` is argmax,
exact against the reference.

``MicroBatchQueue``: small index calls are dominated by fixed per-call host overhead
(argument preparation, the kernel launch, the result copy back), so the
queue amortizes that overhead across CALLERS instead of across keys:

* callers ``submit_lookup``/``submit_ingest`` and hold a ticket;
* ``flush()`` concatenates every pending lookup into ONE padded batch
  (power-of-two buckets from ``min_bucket``) and issues ONE
  ``lookup`` — one fused-lookup kernel launch for a batch of 512 or
  more queries; pending ingests are likewise coalesced into one
  ``Index.ingest``;
* results demultiplex back per ticket, in submission order, as typed
  ``LookupResult``/``IngestReport`` slices.

The class is the reference's ``repro.serving.engine.MicroBatchQueue``
with three departures (tests/test_torch_freeze.py holds the rest of its
syntax tree equal):

* it keeps the index's key dtype (``key_dtype``: float64, or uint64 for
  an index on the exact 64-bit image, ``core.keys64``) from
  ``submit_lookup`` through its staging buffers, so 64-bit keys reach
  the index unrounded; ``submit_ingest`` refuses keys that need that
  image (``keys64.write_keys``);
* each coalesced lookup dispatch is a root span ``queue.flush`` with the
  stages ``queue.stage`` (concatenate and pad into the bucket),
  ``queue.dispatch`` (the index call, ``Index.lookup``'s spans nested)
  and ``queue.scatter`` (answers back to the tickets);
* ``stats`` adds ``lookup_keys`` (the keys dispatched, padding left
  out) and ``lookup_wait_ms_sum`` (per lookup request, from its submit
  to the start of the flush that dispatches it, summed).

The ``max_wait_ms`` deadline flush runs on a daemon timer thread, so a
flush launches the CUDA kernels from that thread: each launch takes the
device of its tensors and that thread's current stream (the default
stream unless the thread sets another), and an error there is raised
on the next queue call (``_async_error``).  An index built on
``device="cuda"`` resolves to each thread's current device; on a host
with several cards, pass ``device="cuda:N"``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import keys64 as _k64
from ..core.results import Overloaded
from ..device import resolve_device
from ..models import Model
from ..spans import span
from .kv_cache import _PAGE_SHIFT, PagedKVCache

__all__ = ["MicroBatchQueue", "Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray
    max_new_tokens: int = 16
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: int = -1


class MicroBatchQueue:
    """Cross-caller batch aggregation for index lookups/ingests (see
    module doc "Serving aggregation").  Single-threaded cooperative
    batching: callers submit, someone flushes, tickets resolve in
    submission order.

    ``index`` is any handle with ``lookup(queries) -> LookupResult``
    and ``ingest(keys, payloads) -> IngestReport`` — the single-device
    ``repro.core.Index``, the range-partitioned
    ``repro.dist.ShardedIndex`` (whose router then splits each
    coalesced flush across shards — one fan-out dispatch instead of one
    per caller), or a snapshot-isolated ``serving.EpochPipeline``.

    Admission control (ISSUE 8):

    * ``max_wait_ms`` — per-request deadline: the first pending submit
      arms a daemon timer that flushes a partially filled bucket when
      it fires, so a lone small caller never stalls waiting for
      bucket-full (``stats["deadline_flushes"]``).
    * ``max_depth`` — bounded queue: a submit past the bound resolves
      its ticket IMMEDIATELY to a typed ``core.Overloaded`` result
      (``stats["shed"]``) — explicit backpressure, never a silent hang
      and never an unbounded queue.
    * ingest retry — a raising ``index.ingest`` is retried
      ``ingest_retries`` times with exponential backoff, the final
      attempt forcing the host partition path
      (``fused_ingest_enabled=False``, restored after) so a
      misbehaving fused write graph degrades to the proven host path
      instead of failing the request.  ``InjectedCrash`` (process
      death) always propagates.
    """

    def __init__(self, index, min_bucket: int = 512,
                 max_wait_ms: Optional[float] = None,
                 max_depth: Optional[int] = None,
                 ingest_retries: int = 2,
                 retry_backoff_ms: float = 1.0,
                 faults=None, auditor=None, audit_every: int = 0):
        self.index = index
        self.min_bucket = max(1, int(min_bucket))
        self.max_wait_ms = max_wait_ms
        self.max_depth = max_depth
        self.ingest_retries = max(0, int(ingest_retries))
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.faults = faults
        self.auditor = auditor
        self.audit_every = int(audit_every)
        self._lookups: list = []   #: guarded-by: _lock
        self._ingests: list = []   #: guarded-by: _lock
        self._results: dict = {}   #: guarded-by: _lock
        self._next_ticket = 0      #: guarded-by: _lock
        # reentrant: the deadline timer thread calls flush(); result()
        # nests flush() under the same lock on the caller thread
        self._lock = threading.RLock()
        #: guarded-by: _lock
        self._deadline_timer: Optional[threading.Timer] = None
        #: guarded-by: _lock
        self._async_error: Optional[BaseException] = None
        # per-bucket reused staging buffers (donated-buffer pattern):
        # one f64 concat target per padded shape, never re-allocated
        self._staging: dict = {}   #: guarded-by: _lock
        #: guarded-by: _lock
        self.stats = {"flushes": 0, "lookup_dispatches": 0,
                      "ingest_dispatches": 0, "coalesced_lookups": 0,
                      "coalesced_ingests": 0, "deadline_flushes": 0,
                      "shed": 0, "ingest_retries": 0,
                      "host_fallbacks": 0, "lookup_keys": 0,
                      "lookup_wait_ms_sum": 0.0}

    def _ticket(self) -> int:
        """lock-held: _lock (every issuer is a locked public method)."""
        t = self._next_ticket
        self._next_ticket += 1
        return t

    def _raise_async_error(self) -> None:
        """lock-held: _lock"""
        err, self._async_error = self._async_error, None
        if err is not None:
            raise err

    def _depth(self) -> int:
        """lock-held: _lock"""
        return len(self._lookups) + len(self._ingests)

    def _shed(self, kind: str) -> int:
        """lock-held: _lock (called from the locked submit paths)."""
        t = self._ticket()
        self._results[t] = Overloaded(
            kind=kind, depth=self._depth(),
            max_depth=int(self.max_depth),
            epoch=int(getattr(self.index, "epoch", -1)))
        self.stats["shed"] += 1
        return t

    def _arm_deadline(self) -> None:
        """lock-held: _lock (called from the locked submit paths)."""
        if self.max_wait_ms is None or self._deadline_timer is not None:
            return
        t = threading.Timer(self.max_wait_ms / 1e3, self._deadline_fire)
        t.daemon = True
        self._deadline_timer = t
        t.start()

    def _cancel_deadline(self) -> None:
        """lock-held: _lock (flush()/close() call under their lock)."""
        t, self._deadline_timer = self._deadline_timer, None
        if t is not None:
            t.cancel()

    def _deadline_fire(self) -> None:
        with self._lock:
            self._deadline_timer = None
            if not (self._lookups or self._ingests):
                return
            self.stats["deadline_flushes"] += 1
            try:
                self.flush()
            except BaseException as e:  # surfaced on the next caller
                self._async_error = e   # touch — never lost silently

    def _key_dtype(self):
        return getattr(self.index, "key_dtype", np.dtype(np.float64))

    def submit_lookup(self, keys) -> int:
        keys = np.atleast_1d(_k64.lookup_keys(keys, self._key_dtype()))
        if keys.shape[0] == 0:
            raise ValueError("submit_lookup: empty key batch")
        with self._lock:
            self._raise_async_error()
            if (self.max_depth is not None
                    and self._depth() >= self.max_depth):
                return self._shed("lookup")
            t = self._ticket()
            self._lookups.append((t, keys, time.perf_counter()))
            self._arm_deadline()
            return t

    def submit_ingest(self, keys, payloads) -> int:
        keys = np.atleast_1d(_k64.write_keys(
            keys, "MicroBatchQueue.submit_ingest",
            self._key_dtype() == np.uint64))
        payloads = np.atleast_1d(np.asarray(payloads, np.int64))
        if keys.shape[0] == 0:
            raise ValueError("submit_ingest: empty key batch")
        if keys.shape != payloads.shape:
            raise ValueError("submit_ingest: payloads must match keys 1:1")
        with self._lock:
            self._raise_async_error()
            if (self.max_depth is not None
                    and self._depth() >= self.max_depth):
                return self._shed("ingest")
            t = self._ticket()
            self._ingests.append((t, keys, payloads))
            self._arm_deadline()
            return t

    def _bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b <<= 1
        return b

    def _stage(self, name: str, bucket: int, dtype) -> np.ndarray:
        """lock-held: _lock (only reached from flush())."""
        key = (name, bucket, np.dtype(dtype).str)
        buf = self._staging.get(key)
        if buf is None:
            buf = np.empty(bucket, dtype)
            self._staging[key] = buf
        return buf

    def _ingest_with_retry(self, keys, pays):
        """Dispatch one coalesced ingest with retry-with-backoff and a
        final host-path fallback (see class doc).

        lock-held: _lock (only reached from flush()).

        Retries transient
        ``RuntimeError``s only — ``InjectedCrash`` (process death) and
        caller bugs (``KeyError``/``ValueError``: duplicate keys, shape
        mismatches) propagate immediately, since replaying them cannot
        succeed and may double-apply."""
        from ..robustness.faults import InjectedCrash
        last: Optional[BaseException] = None
        for attempt in range(self.ingest_retries + 1):
            force_host = attempt > 0 and attempt == self.ingest_retries
            target = self.index
            prev = getattr(target, "fused_ingest_enabled", None)
            try:
                if self.faults is not None:
                    self.faults.check("ingest")
                if force_host and hasattr(target, "fused_ingest_enabled"):
                    target.fused_ingest_enabled = False
                    self.stats["host_fallbacks"] += 1
                return target.ingest(keys, pays)
            except InjectedCrash:
                raise
            except RuntimeError as e:
                last = e
                self.stats["ingest_retries"] += 1
                time.sleep(self.retry_backoff_ms * (2 ** attempt) / 1e3)
            finally:
                if force_host and hasattr(target, "fused_ingest_enabled"):
                    target.fused_ingest_enabled = prev
        raise last

    def flush(self) -> None:
        """Coalesce everything pending into one dispatch per kind
        (ingests first, so lookups submitted after an ingest in the
        same flush window observe its writes) and demux the results.

        Raises ``RuntimeError`` when nothing is pending: a flush with
        zero submissions has no last real key to pad the staging buffer
        with, and silently reading the previous flush's stale staging
        contents is exactly the bug this guard closes."""
        with self._lock:
            self._cancel_deadline()
            if not self._ingests and not self._lookups:
                raise RuntimeError(
                    "MicroBatchQueue.flush() with nothing pending — "
                    "submit before flushing (stale staging buffers are "
                    "never read)")
            if self.faults is not None:
                self.faults.check("flush")
            if self._ingests:
                pend, self._ingests = self._ingests, []
                keys = np.concatenate([k for _, k, _ in pend])
                pays = np.concatenate([p for _, _, p in pend])
                rep = self._ingest_with_retry(keys, pays)
                for t, k, _ in pend:
                    self._results[t] = rep  # one report, shared per ticket
                self.stats["ingest_dispatches"] += 1
                self.stats["coalesced_ingests"] += len(pend)
                if (self.auditor is not None and self.audit_every
                        and self.stats["ingest_dispatches"]
                        % self.audit_every == 0):
                    self.auditor.assert_ok(self.index)
            if self._lookups:
                with span("queue.flush"):
                    self._flush_lookups()
            self.stats["flushes"] += 1

    def _flush_lookups(self) -> None:
        """One coalesced lookup dispatch of everything pending.

        lock-held: _lock (only reached from flush())."""
        t_take = time.perf_counter()
        pend, self._lookups = self._lookups, []
        with span("queue.stage"):
            sizes = [k.shape[0] for _, k, _ in pend]
            n = int(sum(sizes))
            bucket = self._bucket(n)
            buf = self._stage("lookup", bucket, self._key_dtype())
            off = 0
            for _, k, _ in pend:
                buf[off: off + k.shape[0]] = k
                off += k.shape[0]
            buf[off:] = buf[off - 1]  # pad: repeat the last real key
        with span("queue.dispatch"):
            res = self.index.lookup(buf)
        with span("queue.scatter"):
            off = 0
            for (t, k, _), sz in zip(pend, sizes):
                sl = slice(off, off + sz)
                self._results[t] = dataclasses.replace(
                    res, payloads=res.payloads[sl],
                    slots=res.slots[sl], found=res.found[sl])
                off += sz
        self.stats["lookup_dispatches"] += 1
        self.stats["coalesced_lookups"] += len(pend)
        self.stats["lookup_keys"] += n
        self.stats["lookup_wait_ms_sum"] += 1e3 * sum(
            t_take - ts for _, _, ts in pend)

    def result(self, ticket: int):
        """Pop a ticket's typed result (flushing pending work first if
        the ticket is still queued).  Each ticket resolves EXACTLY
        once — a duplicate read, or a ticket this queue never issued,
        raises ``KeyError`` instead of triggering a spurious flush.
        A shed ticket resolves to its ``Overloaded`` marker here."""
        with self._lock:
            self._raise_async_error()
            if ticket in self._results:
                return self._results.pop(ticket)
            pending = (any(t == ticket for t, _, _ in self._lookups)
                       or any(t == ticket for t, _, _ in self._ingests))
            if pending:
                self.flush()
                return self._results.pop(ticket)
            if 0 <= ticket < self._next_ticket:
                raise KeyError(
                    f"ticket {ticket} already consumed — results resolve "
                    "exactly once")
            raise KeyError(f"unknown ticket {ticket} (never issued by "
                           "this queue)")

    def close(self) -> None:
        """Cancel the deadline timer (join not needed: the timer body
        only takes the lock and returns when nothing is pending)."""
        with self._lock:
            self._cancel_deadline()


class ServingEngine:
    """Continuous-batching decode over the learned-index block table (see
    the module doc).  ``device`` (cuda unless ``"cpu"``) holds the
    caches and the block table's device state; ``load`` takes params on
    that device."""

    def __init__(self, model: Model, max_batch: int = 4,
                 max_len: int = 256, page_size: int = 16,
                 temperature: float = 0.0, device=None):
        self.model = model
        self.max_batch = max_batch
        self.max_len = max_len
        self.temperature = temperature
        self.device = resolve_device(device)
        self.params = None
        self.caches = None
        self.cache_index = 0
        self.kv_pages = PagedKVCache.create(
            n_pages=max_batch * (max_len // page_size + 1),
            page_size=page_size, expected_requests=max_batch * 4,
            device=self.device)
        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}
        # cross-caller aggregation over the block-table index: one
        # lookup a round for all concurrent requests' pages
        self.aggregator = MicroBatchQueue(self.kv_pages.index)
        self.stats = {"decoded_tokens": 0, "rounds": 0, "page_lookups": 0}
        self._decode = model.decode_fn

    def load(self, params):
        self.params = params
        self.caches = self.model.init_caches(self.max_batch, self.max_len,
                                             device=self.device)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        free_slots = [s for s in range(self.max_batch)
                      if s not in {r.slot for r in self.active.values()}]
        rids, pages = [], []
        while self.queue and free_slots:
            req = self.queue.pop(0)
            req.slot = free_slots.pop(0)
            self.active[req.request_id] = req
            n_pages = len(req.prompt) // self.kv_pages.page_size + 1
            rids.append(np.full(n_pages, req.request_id, np.int64))
            pages.append(np.arange(n_pages, dtype=np.int64))
        if rids:
            # ONE coalesced prompt allocation for every request admitted
            # this round
            self.kv_pages.alloc_batch(np.concatenate(rids),
                                      np.concatenate(pages))

    def _sample(self, logits: np.ndarray) -> np.ndarray:
        if self.temperature <= 0:
            return np.argmax(logits, axis=-1)
        gen = torch.Generator().manual_seed(self.stats["rounds"])
        probs = torch.softmax(torch.from_numpy(logits) / self.temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].numpy()

    def step(self):
        """One decode round for all active requests."""
        self._admit()
        if not self.active:
            return
        tokens = np.zeros((self.max_batch, 1), np.int64)
        for req in self.active.values():
            last = (req.generated[-1] if req.generated
                    else int(req.prompt[-1]) % self.model.cfg.vocab)
            tokens[req.slot, 0] = last
        # resolve the current page of every active request via the index:
        # ONE batched lookup for the whole round, then one batched alloc
        # for the misses
        rids = np.array([r.request_id for r in self.active.values()])
        pages = np.array([
            (len(r.prompt) + len(r.generated)) // self.kv_pages.page_size
            for r in self.active.values()])
        ticket = self.aggregator.submit_lookup(
            ((rids.astype(np.int64) << _PAGE_SHIFT)
             | pages.astype(np.int64)).astype(np.float64))
        self.aggregator.flush()
        known = np.asarray(
            self.aggregator.result(ticket).payloads).astype(np.int64)
        miss = known < 0
        if np.any(miss):
            self.kv_pages.alloc_batch(rids[miss], pages[miss])
        self.stats["page_lookups"] += len(rids)

        logits, self.caches = self._decode(
            self.params,
            {"tokens": torch.from_numpy(tokens).to(self.device)},
            self.caches, self.cache_index)
        self.cache_index = min(self.cache_index + 1, self.max_len - 1)
        nxt = self._sample(logits.float().cpu().numpy())
        for req in list(self.active.values()):
            tok = int(nxt[req.slot])
            req.generated.append(tok)
            self.stats["decoded_tokens"] += 1
            if len(req.generated) >= req.max_new_tokens:
                req.done = True
                self.kv_pages.free_request(
                    req.request_id,
                    (len(req.prompt) + len(req.generated))
                    // self.kv_pages.page_size + 1)
                del self.active[req.request_id]
        self.stats["rounds"] += 1

    def run_until_done(self, max_rounds: int = 1000):
        t0 = time.perf_counter()
        while (self.queue or self.active) and self.stats["rounds"] < max_rounds:
            self.step()
        self.stats["wall_s"] = time.perf_counter() - t0
        # block-table health: epoch distance covered by delta updates vs
        # full refreezes (the Index handle's device sync)
        idx = self.kv_pages.index
        self.stats["kv_epoch"] = idx.epoch
        self.stats["kv_delta_updates"] = idx.stats["delta_updates"]
        self.stats["kv_refreezes"] = idx.stats["refreezes"]
        return self.stats
