"""Paged KV cache whose block table is the paper's gapped learned index.

vLLM-style paging keeps a per-request block table (logical page ->
physical page) in a hash map.  Here the table is a *gapped learned
index* over composite keys ``request_id * 2^20 + logical_page``, held by
the epoch-versioned ``core.Index`` handle:

 * allocation = the paper's §5.3 **dynamic insert**: the predicted slot
   is usually a reserved gap (requests allocate pages in key order, the
   exact pattern result-driven gaps anticipate), so inserts are O(1)
   without rehashing/retraining.  ``index.ingest`` delta-updates the
   frozen device buffers in place — no more "mark dirty + refreeze the
   whole engine on the next lookup" dance;
 * lookup     = ``index.lookup`` — the handle resolves small batches on
   the numpy oracle and large ones on the device engine.  Composite keys
   beyond f32 exactness (2^24) ride the f32 hi/lo pair representation,
   so the device path serves them exactly (no host fallback guard);
 * free       = §5.3 delete (device state follows via delta on the next
   device lookup).

A copy of the reference's ``repro.serving.kv_cache``; its one change is
that ``create`` takes ``device`` (cuda unless ``"cpu"``), where the
block-table index keeps its device state.  ``lookup_batch(device=True)``
runs the ``fused`` backend, which on the card is the hand-written CUDA
fused-lookup kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core import Index
from ..core.keys64 import write_keys

_PAGE_SHIFT = 20  # up to 2^20 pages per request


def table_key(request_id: int, logical_page: int) -> int:
    return (request_id << _PAGE_SHIFT) | logical_page


@dataclasses.dataclass
class PagedKVCache:
    n_pages: int
    page_size: int
    index: Index
    free_pages: List[int]
    allocated: Dict[int, int]  # composite key -> physical page

    @staticmethod
    def create(n_pages: int, page_size: int = 16,
               expected_requests: int = 256,
               gap_rho: float = 0.3, device=None) -> "PagedKVCache":
        """Bootstrap the block-table index from a synthetic key skeleton
        matching the (request, page) key distribution, with gaps reserved
        for the real allocations to land in (result-driven §5.1).  The
        index's device state lives on ``device`` (cuda unless
        ``device="cpu"``)."""
        skeleton = []
        pages_per_req = max(4, n_pages // max(expected_requests, 1))
        for r in range(1, expected_requests + 1):
            for p in range(0, pages_per_req, 2):  # every other page: gaps
                skeleton.append(table_key(r, p))
        keys = np.array(sorted(set(skeleton)), np.float64)
        index = Index.build(keys, method="pgm", eps=16, gap_rho=gap_rho,
                            device=device)
        # skeleton keys carry payload -1 (not an allocation)
        ga = index.gapped
        ga.payload[ga.occupied] = -1
        ga.links.chain_payloads[:] = -1
        return PagedKVCache(
            n_pages=n_pages, page_size=page_size, index=index,
            free_pages=list(range(n_pages)), allocated={})

    # ------------------------------------------------------------------
    def alloc(self, request_id: int, logical_page: int) -> int:
        if not self.free_pages:
            raise MemoryError("KV cache out of pages")
        key = table_key(request_id, logical_page)
        kf = float(write_keys(np.array([key]), "PagedKVCache.alloc")[0])
        phys = self.free_pages.pop()
        if self.index.gapped.lookup(kf) is not None:
            self.index.update(kf, phys)       # skeleton slot: claim it
        else:
            self.index.insert(kf, phys)       # dynamic insert into a gap
        self.allocated[key] = phys
        return phys

    def alloc_batch(self, request_ids: np.ndarray,
                    logical_pages: np.ndarray) -> np.ndarray:
        """Allocate many (request, page) mappings in one shot.

        Skeleton keys are claimed through ONE vectorized
        ``index.update_batch`` (payload-only scatter, one epoch bump);
        fresh keys go through ONE ``index.ingest`` — on engines with
        the fused write graph enabled (``Index.fused_ingest_enabled``,
        auto-on for a cuda index) that is a single fused dispatch (placement
        + slot scatter + CSR merge + rank/bound refresh in one graph;
        composite keys are integers < 2^48, so they are pair-exact and
        the device compares are exact); otherwise the two-dispatch
        place-then-delta path.  The physical-page claim
        is a vectorized tail slice of the free list (same pages, same
        order as the old one-pop-per-page loop — the last host-side
        per-element copy on this path).  Returns the physical pages.
        """
        request_ids = np.atleast_1d(np.asarray(request_ids, np.int64))
        logical_pages = np.atleast_1d(np.asarray(logical_pages, np.int64))
        n = request_ids.shape[0]
        if n == 0:
            return np.zeros(0, np.int64)
        if len(self.free_pages) < n:
            raise MemoryError("KV cache out of pages")
        keys = (request_ids << _PAGE_SHIFT) | logical_pages
        kf = write_keys(keys, "PagedKVCache.alloc_batch")
        phys = np.array(self.free_pages[: -n - 1: -1], np.int64)
        del self.free_pages[-n:]
        existing = self.index.gapped.contains_batch(kf)  # skeleton: claim
        if np.any(existing):
            self.index.update_batch(kf[existing], phys[existing])
        fresh = ~existing
        if np.any(fresh):
            self.index.ingest(kf[fresh], phys[fresh])
        self.allocated.update(zip(keys.tolist(), phys.tolist()))
        return phys

    def lookup_batch(self, request_ids: np.ndarray,
                     logical_pages: np.ndarray,
                     device: Optional[bool] = None) -> np.ndarray:
        """Batched (request, page) -> physical page; -1 for unmapped.

        ``device=None`` lets the handle's capability registry pick
        (numpy oracle below ``index.min_device_batch``, the fused
        single-dispatch engine above — composite keys beyond 2^24 ride
        the f32 hi/lo pair through the fused kernel's pair compares, so
        wide-key decode batches stay on device with no host-only
        guard).
        """
        keys = write_keys((request_ids.astype(np.int64) << _PAGE_SHIFT)
                          | logical_pages.astype(np.int64),
                          "PagedKVCache.lookup_batch")
        backend = None
        if device is True:
            backend = "fused"
        elif device is False:
            backend = "numpy-oracle"
        qsorted = bool(np.all(np.diff(keys) >= 0))
        res = self.index.lookup(keys, backend=backend,
                                queries_sorted=qsorted)
        return np.asarray(res.payloads).astype(np.int64)

    def free_request(self, request_id: int, n_pages: int) -> None:
        doomed = []
        for p in range(n_pages):
            key = table_key(request_id, p)
            phys = self.allocated.pop(key, None)
            if phys is not None and phys >= 0:
                self.free_pages.append(phys)
                doomed.append(float(key))
        if doomed:
            self.index.remove(np.asarray(doomed, np.float64))

    @property
    def utilization(self) -> float:
        return 1.0 - len(self.free_pages) / self.n_pages

    def insert_path_stats(self) -> Dict[str, float]:
        """Fraction of allocations that landed in reserved gap slots
        (the paper's dynamic-insert claim, measurable)."""
        g = self.index.gapped
        chained, _ = g.link_stats()
        return {"gap_fraction_remaining": g.gap_fraction,
                "chained_keys": chained,
                "epoch": self.index.epoch,
                "refreezes": self.index.stats["refreezes"],
                "delta_updates": self.index.stats["delta_updates"]}
