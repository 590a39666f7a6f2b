"""Packed token storage: one flat token array + document boundaries.

On disk: ``<name>.tokens.npy`` (uint32) and ``<name>.meta.json`` with the
document offsets and the *sample keys* (sorted uint64 ids — e.g. content
hashes or global shuffle ids).  The learned index in
``indexed_dataset.py`` maps sample key -> document ordinal.

Streaming appends write into amortized-doubling capacity buffers (the
public ``tokens`` / ``doc_offsets`` / ``sample_keys`` are trimmed
views), so per-document ``append`` is O(len(doc)) amortized instead of
one whole-buffer copy per call; ``version`` counts appends — the
mutation counter the indexed dataset's epoch story keys off.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np


def _with_capacity(a: np.ndarray, cap: int) -> np.ndarray:
    out = np.empty(cap, a.dtype)
    out[: a.shape[0]] = a
    return out


class PackedTokenStore:
    def __init__(self, tokens: np.ndarray, doc_offsets: np.ndarray,
                 sample_keys: np.ndarray):
        self._tokens = np.asarray(tokens, np.uint32)
        self._offsets = np.asarray(doc_offsets, np.int64)
        self._keys = np.asarray(sample_keys, np.uint64)
        self._n_tokens = int(self._tokens.shape[0])
        self._n_docs = int(self._keys.shape[0])
        self.version = 0

    # ------------------------------------------------------------------
    @property
    def tokens(self) -> np.ndarray:
        return self._tokens[: self._n_tokens]

    @property
    def doc_offsets(self) -> np.ndarray:
        return self._offsets[: self._n_docs + 1]

    @property
    def sample_keys(self) -> np.ndarray:
        return self._keys[: self._n_docs]

    @property
    def n_docs(self) -> int:
        return self._n_docs

    def doc(self, ordinal: int) -> np.ndarray:
        a, b = self._offsets[ordinal], self._offsets[ordinal + 1]
        return self._tokens[a:b]

    # ------------------------------------------------------------------
    @staticmethod
    def build(docs: Sequence[np.ndarray],
              sample_keys: Optional[np.ndarray] = None) -> "PackedTokenStore":
        """Pack token documents; keys default to spaced ids (gap-friendly)."""
        lens = np.array([len(d) for d in docs], np.int64)
        offsets = np.concatenate([[0], np.cumsum(lens)])
        tokens = (np.concatenate(docs).astype(np.uint32)
                  if len(docs) else np.zeros(0, np.uint32))
        if sample_keys is None:
            # spaced keys leave headroom for streamed appends (paper §5.3)
            sample_keys = (np.arange(len(docs), dtype=np.uint64) + 1) * 16
        sample_keys = np.asarray(sample_keys, np.uint64)
        if not np.all(np.diff(sample_keys.astype(np.float64)) > 0):
            raise ValueError("sample keys must be strictly increasing")
        return PackedTokenStore(tokens, offsets, sample_keys)

    @staticmethod
    def synthetic(n_docs: int, mean_len: int = 512, vocab: int = 32_000,
                  seed: int = 0) -> "PackedTokenStore":
        rng = np.random.default_rng(seed)
        lens = np.maximum(8, rng.poisson(mean_len, n_docs))
        # Zipfian token frequencies (realistic, and gives training a
        # learnable unigram signal in tests/examples)
        docs = [(rng.zipf(1.4, l) - 1).clip(0, vocab - 1).astype(np.uint32)
                for l in lens]
        # realistic keys: sorted 48-bit content hashes
        keys = np.sort(rng.choice(2 ** 48, n_docs, replace=False)).astype(
            np.uint64)
        return PackedTokenStore.build(docs, keys)

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.save(path + ".tokens.npy", self.tokens)
        np.save(path + ".offsets.npy", self.doc_offsets)
        np.save(path + ".keys.npy", self.sample_keys)
        with open(path + ".meta.json", "w") as f:
            json.dump({"n_docs": self.n_docs,
                       "total_tokens": int(self._n_tokens)}, f)

    @staticmethod
    def load(path: str) -> "PackedTokenStore":
        return PackedTokenStore(
            tokens=np.load(path + ".tokens.npy", mmap_mode="r"),
            doc_offsets=np.load(path + ".offsets.npy"),
            sample_keys=np.load(path + ".keys.npy"),
        )

    # ------------------------------------------------------------------
    def _reserve(self, extra_tokens: int, extra_docs: int) -> None:
        need_t = self._n_tokens + extra_tokens
        if need_t > self._tokens.shape[0]:
            self._tokens = _with_capacity(self.tokens, max(need_t * 2, 1024))
        need_d = self._n_docs + extra_docs
        if need_d + 1 > self._offsets.shape[0]:
            self._offsets = _with_capacity(self.doc_offsets,
                                           max((need_d + 1) * 2, 64))
        if need_d > self._keys.shape[0]:
            self._keys = _with_capacity(self.sample_keys,
                                        max(need_d * 2, 64))

    def append(self, doc: np.ndarray, sample_key: int) -> int:
        """Streamed ingestion: append one document (key may interleave).

        Returns the new document ordinal.  The learned index layer
        handles out-of-order keys through gap insertion (paper §5.3) —
        physical token storage is append-only (amortized O(len(doc))).
        """
        doc = np.asarray(doc, np.uint32)
        self._reserve(doc.shape[0], 1)
        t0 = self._n_tokens
        self._tokens[t0 : t0 + doc.shape[0]] = doc
        self._n_tokens += int(doc.shape[0])
        self._offsets[self._n_docs + 1] = self._n_tokens
        self._keys[self._n_docs] = np.uint64(sample_key)
        self._n_docs += 1
        self.version += 1
        return self._n_docs - 1

    def append_batch(self, docs, sample_keys) -> np.ndarray:
        """Append many documents with ONE capacity reservation.
        Returns the new document ordinals."""
        lens = np.array([len(d) for d in docs], np.int64)
        self._reserve(int(lens.sum()), len(docs))
        first = self._n_docs
        for d, k in zip(docs, np.asarray(sample_keys, np.uint64)):
            d = np.asarray(d, np.uint32)
            t0 = self._n_tokens
            self._tokens[t0 : t0 + d.shape[0]] = d
            self._n_tokens += int(d.shape[0])
            self._offsets[self._n_docs + 1] = self._n_tokens
            self._keys[self._n_docs] = k
            self._n_docs += 1
        self.version += 1
        return np.arange(first, first + len(lens), dtype=np.int64)
