"""Learned-index-backed sample lookup — the paper as a data-plane feature.

A training job addresses samples by *key* (content hash / global shuffle
id), not ordinal: restarts, online mixing, and streamed ingestion all
need key -> storage-position resolution.  Classically that's a B-tree or
a hash map per worker; here it is the paper's pluggable learned index
behind the epoch-versioned ``core.Index`` handle:

 * build: PGM/FITing/RMI over the store's sorted sample keys —
   optionally **sampled** (§4) for fast worker startup on huge stores;
 * serve: ``index.lookup`` — the handle routes big batches through the
   device path and small ones through the numpy reference
   (``prefer_device`` pins the device backend instead);
 * stream: new documents appended out-of-key-order land in **gap slots**
   (§5.3 dynamic insert via ``index.ingest``) — no index rebuild, and
   the frozen device buffers are delta-updated in place (the old code
   refroze the whole engine after every append).

Misses raise KeyError (a miss means a corrupt manifest — fail loudly).

A copy of the reference's ``repro.data.indexed_dataset``; its one
change is that ``build`` takes ``device`` (cuda unless ``"cpu"``),
where the index keeps its device state.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import Index, IngestReport
from .token_store import PackedTokenStore


@dataclasses.dataclass
class IndexedTokenDataset:
    store: PackedTokenStore
    index: Index
    prefer_device: bool = False

    @staticmethod
    def build(store: PackedTokenStore, method: str = "pgm",
              sample_rate: float = 1.0, gap_rho: float = 0.15,
              use_device: bool = False, device=None,
              **mech_kwargs) -> "IndexedTokenDataset":
        keys = store.sample_keys.astype(np.float64)
        index = Index.build(
            keys, method=method, sample_rate=sample_rate, gap_rho=gap_rho,
            device=device, **mech_kwargs)
        ds = IndexedTokenDataset(store=store, index=index,
                                 prefer_device=use_device)
        if use_device:
            index.refreeze()  # materialize the engine up front
        return ds

    # ------------------------------------------------------------------
    def ordinals(self, sample_keys: np.ndarray) -> np.ndarray:
        """Batched key -> document ordinal (payload) resolution."""
        q = np.asarray(sample_keys, np.float64)
        backend = "xla-windowed" if self.prefer_device else None
        res = self.index.lookup(q, backend=backend)
        if not bool(res.found.all()):
            missing = q[~res.found][:5]
            raise KeyError(f"sample keys not in index (first 5): {missing}")
        return np.asarray(res.payloads, np.int64)

    def batch(self, sample_keys: np.ndarray, seq_len: int) -> np.ndarray:
        """Fetch + pad/trim documents into an (n, seq_len) token matrix."""
        ords = self.ordinals(sample_keys)
        out = np.zeros((len(ords), seq_len), np.int32)
        for i, o in enumerate(ords):
            doc = self.store.doc(int(o))[:seq_len]
            out[i, : len(doc)] = doc
        return out

    # ------------------------------------------------------------------
    def ingest(self, doc: np.ndarray, sample_key: int) -> str:
        """Streamed append: O(1) gap-slot insert, no retrain (paper §5.3).

        Returns the placement path ('slot'|'chain'); the device state —
        if materialized — follows lazily via delta update on the next
        device lookup.
        """
        ordinal = self.store.append(doc, sample_key)
        return self.index.insert(float(sample_key), int(ordinal))

    def ingest_batch(self, docs, sample_keys) -> IngestReport:
        """Batched streamed append: one vectorized §5.3 ingest (and at
        most ONE device delta-update/refreeze) for a whole shipment of
        documents.  Returns the typed ``IngestReport``."""
        ordinals = self.store.append_batch(docs, sample_keys)
        return self.index.ingest(
            np.asarray(sample_keys, np.float64), ordinals)
