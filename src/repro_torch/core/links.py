"""Growable CSR linking arrays — canonical storage for §5.2 chains.

``CSRLinks`` stores every per-slot linking array (the keys that chained
onto an occupied slot instead of taking their predicted slot) in three
flat arrays:

* ``offsets``  — (n_slots + 1,) int64; slot i's chain is
  ``chain_keys[offsets[i]:offsets[i+1]]`` (key-sorted, like the old
  per-slot sorted lists);
* ``chain_keys``     — (L,) float64;
* ``chain_payloads`` — (L,) int64.

This replaces the previous dict-of-lists: batched chain appends become
ONE vectorized merge (``append_batch``) instead of ~1.2 us/append of
interpreter overhead, ``GappedArray.export_csr_links`` is free (the CSR
tables ARE the storage), and the device delta-update path can diff the
tables directly.

Scalar mutators stay O(chain) despite the flat layout: ``insert_one``
lands in a small per-slot PENDING overlay (sorted python lists) that is
merged into the CSR arrays lazily — read surfaces that need the flat
tables (``csr()``, ``offsets``, the dict-style views) flush first, while
the scalar hot-path reads (``chain_len`` / ``chain_max_key`` /
``find_payload`` / ``set_payload``) consult CSR + overlay directly, so
scalar insert/lookup loops never pay an O(L) rebuild per write.
Removals (`pop_front`/`remove`) are flush-first — deletes are the rare
arm of dynamic workloads.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["CSRLinks"]


class CSRLinks:
    """CSR linking arrays over ``n_slots`` slots (see module docstring)."""

    __slots__ = ("_offsets", "_keys", "_pays", "_maxlen", "_pend",
                 "_pend_n", "_shared")

    def __init__(self, n_slots: int,
                 offsets: Optional[np.ndarray] = None,
                 chain_keys: Optional[np.ndarray] = None,
                 chain_payloads: Optional[np.ndarray] = None):
        if offsets is None:
            offsets = np.zeros(n_slots + 1, np.int64)
        self._offsets = np.asarray(offsets, np.int64)
        self._keys = (np.zeros(0, np.float64) if chain_keys is None
                      else np.asarray(chain_keys, np.float64))
        self._pays = (np.zeros(0, np.int64) if chain_payloads is None
                      else np.asarray(chain_payloads, np.int64))
        self._maxlen = (int(np.max(np.diff(self._offsets)))
                        if self._offsets[-1] else 0)
        self._pend = {}
        self._pend_n = 0
        self._shared = False

    # ------------------------------------------------------------------
    # snapshot sharing (copy-on-write backing for GappedArray pins)
    # ------------------------------------------------------------------
    def mark_shared(self) -> None:
        """A pinned snapshot now references the CSR arrays by identity;
        every in-place mutation must ``unshare`` first.  Wholesale
        rebuilds (``_merge``) are COW-safe by construction — they
        replace all three arrays — so only the in-place mutators
        (``_remove_at``, ``set_payload``) and the write-capable
        ``chain_payloads`` view pay the copy, once per pin."""
        self._shared = True

    def unshare(self) -> None:
        if self._shared:
            self._offsets = self._offsets.copy()
            self._keys = self._keys.copy()
            self._pays = self._pays.copy()
            self._shared = False

    # ------------------------------------------------------------------
    # pending overlay
    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Merge the pending per-slot overlay into the CSR arrays now
        (ONE vectorized merge).  Reads that need the flat tables call
        this implicitly; batch writers call it eagerly so the merge is
        accounted to the write, not to a later reader."""
        self._flush()

    def _flush(self) -> None:
        if not self._pend_n:
            return
        pend, self._pend, self._pend_n = self._pend, {}, 0
        slots, keys, pays = [], [], []
        for s, lst in pend.items():
            for k, p in lst:
                slots.append(s)
                keys.append(k)
                pays.append(p)
        self._merge(np.asarray(slots, np.int64),
                    np.asarray(keys, np.float64),
                    np.asarray(pays, np.int64))

    def _csr_len(self, slot: int) -> int:
        return int(self._offsets[slot + 1] - self._offsets[slot])

    def _find_csr(self, slot: int, key: float) -> int:
        s, e = int(self._offsets[slot]), int(self._offsets[slot + 1])
        if e == s:
            return -1
        # bounded bisect straight on the flat array: chains are short
        # (§5.2), so a few python probes beat a numpy slice + dispatch
        j = bisect_left(self._keys, key, s, e)
        if j < e and self._keys[j] == key:
            return j
        return -1

    # ------------------------------------------------------------------
    # shape / stats (overlay-aware, no flush)
    # ------------------------------------------------------------------
    @property
    def n_slots(self) -> int:
        return int(self._offsets.shape[0]) - 1

    @property
    def total(self) -> int:
        """Total number of chained keys (incl. pending)."""
        return int(self._offsets[-1]) + self._pend_n

    @property
    def offsets(self) -> np.ndarray:
        """(n_slots+1,) int64 CSR offsets — flushes pending appends."""
        self._flush()
        return self._offsets

    @property
    def chain_keys(self) -> np.ndarray:
        """(L,) float64 chain keys in CSR order — flushes pending."""
        self._flush()
        return self._keys

    @property
    def chain_payloads(self) -> np.ndarray:
        """(L,) int64 — flushes pending; in-place writes are allowed."""
        self._flush()
        self.unshare()  # callers may write through the returned view
        return self._pays

    @property
    def max_chain(self) -> int:
        """Longest per-slot chain — tracked incrementally (O(1) read)."""
        return self._maxlen

    def chain_len(self, slot: int) -> int:
        b = self._pend.get(slot)
        return self._csr_len(slot) + (len(b) if b else 0)

    def chain_max_key(self, slot: int) -> float:
        """Largest chained key at ``slot`` (-inf when the chain is empty);
        max over the CSR run AND the pending overlay."""
        s, e = self._offsets[slot], self._offsets[slot + 1]
        mx = float(self._keys[e - 1]) if e > s else -np.inf
        b = self._pend.get(slot)
        if b and b[-1][0] > mx:
            mx = float(b[-1][0])
        return mx

    def chain_max_keys(self, slots: np.ndarray) -> np.ndarray:
        """Vectorized ``chain_max_key`` over an int array of slots
        (flushes pending first)."""
        self._flush()
        slots = np.asarray(slots, np.int64)
        s = self._offsets[slots]
        e = self._offsets[slots + 1]
        out = np.full(slots.shape[0], -np.inf, np.float64)
        live = e > s
        out[live] = self._keys[e[live] - 1]
        return out

    # ------------------------------------------------------------------
    # dict-compatible read surface (chains are key-sorted snapshots)
    # ------------------------------------------------------------------
    def _nonempty(self) -> np.ndarray:
        self._flush()
        return np.flatnonzero(np.diff(self._offsets) > 0)

    def keys(self) -> List[int]:
        return [int(i) for i in self._nonempty()]

    def __iter__(self) -> Iterator[int]:
        return iter(self.keys())

    def __len__(self) -> int:
        return int(self._nonempty().shape[0])

    def __bool__(self) -> bool:
        return self.total > 0

    def __contains__(self, slot: int) -> bool:
        return 0 <= slot < self.n_slots and self.chain_len(slot) > 0

    def __getitem__(self, slot: int) -> List[Tuple[float, int]]:
        self._flush()
        s, e = int(self._offsets[slot]), int(self._offsets[slot + 1])
        if e == s:
            raise KeyError(slot)
        return list(zip(self._keys[s:e].tolist(), self._pays[s:e].tolist()))

    def get(self, slot: int, default=None):
        if self.chain_len(slot) == 0:
            return default
        return self[slot]

    def items(self):
        return [(i, self[i]) for i in self.keys()]

    def values(self):
        return [self[i] for i in self.keys()]

    def __eq__(self, other) -> bool:
        if isinstance(other, CSRLinks):
            return (np.array_equal(self.offsets, other.offsets)
                    and np.array_equal(self.chain_keys, other.chain_keys)
                    and np.array_equal(self.chain_payloads,
                                       other.chain_payloads))
        if isinstance(other, dict):
            return dict(self) == other
        return NotImplemented

    def __hash__(self):  # mutable container
        raise TypeError("CSRLinks is unhashable")

    def __repr__(self) -> str:
        return (f"CSRLinks(n_slots={self.n_slots}, total={self.total}, "
                f"max_chain={self.max_chain})")

    # ------------------------------------------------------------------
    # point lookups
    # ------------------------------------------------------------------
    def find(self, slot: int, key: float) -> int:
        """Global CSR index of (slot, key), or -1 (flushes pending)."""
        self._flush()
        return self._find_csr(slot, key)

    def find_payload(self, slot: int, key: float) -> Optional[int]:
        """Payload stored for (slot, key), or None — overlay-aware, no
        flush (the scalar read path)."""
        j = self._find_csr(slot, key)
        if j >= 0:
            return int(self._pays[j])
        b = self._pend.get(slot)
        if b:
            t = bisect_left(b, (key,))
            if t < len(b) and b[t][0] == key:
                return int(b[t][1])
        return None

    # ------------------------------------------------------------------
    # scalar mutators (O(chain): pending overlay, lazily merged)
    # ------------------------------------------------------------------
    def insert_one(self, slot: int, key: float, payload: int) -> None:
        """Sorted-position insert; raises KeyError on a duplicate key."""
        if self._find_csr(slot, key) >= 0:
            raise KeyError(f"duplicate key {key!r}")
        b = self._pend.setdefault(slot, [])
        j = bisect_left(b, (key,))
        if j < len(b) and b[j][0] == key:
            raise KeyError(f"duplicate key {key!r}")
        b.insert(j, (key, payload))
        self._pend_n += 1
        self._maxlen = max(self._maxlen, self._csr_len(slot) + len(b))

    def pop_front(self, slot: int) -> Tuple[float, int]:
        """Remove and return the chain's minimum (key, payload)."""
        self._flush()
        s, e = int(self._offsets[slot]), int(self._offsets[slot + 1])
        if e == s:
            raise KeyError(slot)
        k, p = float(self._keys[s]), int(self._pays[s])
        self._remove_at(slot, s)
        return k, p

    def remove(self, slot: int, key: float) -> bool:
        self._flush()
        j = self._find_csr(slot, key)
        if j < 0:
            return False
        self._remove_at(slot, j)
        return True

    def _remove_at(self, slot: int, j: int) -> None:
        self.unshare()  # in-place offset shift below
        was = self._csr_len(slot)
        self._keys = np.delete(self._keys, j)
        self._pays = np.delete(self._pays, j)
        self._offsets[slot + 1 :] -= 1
        if was == self._maxlen:  # rare: the argmax shrank — recompute
            self._maxlen = (int(np.max(np.diff(self._offsets)))
                            if self._offsets[-1] else 0)

    def set_payload(self, slot: int, key: float, payload: int) -> bool:
        j = self._find_csr(slot, key)
        if j >= 0:
            self.unshare()
            self._pays[j] = payload
            return True
        b = self._pend.get(slot)
        if b:
            t = bisect_left(b, (key,))
            if t < len(b) and b[t][0] == key:
                b[t] = (key, payload)
                return True
        return False

    # ------------------------------------------------------------------
    # the vectorized batch path
    # ------------------------------------------------------------------
    def append_batch(self, slots: np.ndarray, keys: np.ndarray,
                     payloads: np.ndarray) -> None:
        """Merge a batch of (slot, key, payload) chain entries in ONE
        vectorized pass (lexsort + merge), preserving per-slot key order.
        Raises KeyError on any duplicate (slot, key) — within the batch
        or against an existing entry — matching sequential semantics.
        """
        self._flush()
        slots = np.asarray(slots, np.int64)
        if slots.shape[0] == 0:
            return
        self._merge(slots, np.asarray(keys, np.float64),
                    np.asarray(payloads, np.int64))

    def _merge(self, slots: np.ndarray, keys: np.ndarray,
               payloads: np.ndarray) -> None:
        """O(L + B log B) merge: the flat CSR arrays are globally
        key-sorted (per-slot chains are key-sorted and per-slot key
        ranges ascend with the slot — §5.3's total-order invariant), so
        the batch's insert positions come from ONE searchsorted and the
        rebuild is a single gather instead of an O((L+B) log(L+B))
        lexsort over everything already stored."""
        order = np.lexsort((keys, slots))
        bs = slots[order]
        bk = keys[order]
        bp = payloads[order]
        dup = (bs[1:] == bs[:-1]) & (bk[1:] == bk[:-1])
        if np.any(dup):
            raise KeyError(f"duplicate key {bk[1:][dup][0]!r}")
        pos = np.searchsorted(self._keys, bk, side="left")
        L = self._keys.shape[0]
        if L:
            exists = (pos < L) & (self._keys[np.minimum(pos, L - 1)] == bk)
            if np.any(exists):
                raise KeyError(
                    f"duplicate key {bk[np.flatnonzero(exists)[0]]!r}")
        # single-allocation merge (this is also the host oracle for the
        # device CSR-merge scatter in kernels.gap_place): old entry i
        # shifts right by the number of batch positions <= i, batch
        # entry j lands at pos[j] + j (pos is nondecreasing after the
        # lexsort, so the destinations are strictly increasing) — one
        # scatter each instead of np.insert's two full rebuilds
        B = bk.shape[0]
        dst_old = np.arange(L) + np.searchsorted(pos, np.arange(L),
                                                 side="right")
        dst_new = pos + np.arange(B)
        new_keys = np.empty(L + B, self._keys.dtype)
        new_pays = np.empty(L + B, self._pays.dtype)
        new_keys[dst_old] = self._keys
        new_keys[dst_new] = bk
        new_pays[dst_old] = self._pays
        new_pays[dst_new] = bp
        self._keys = new_keys
        self._pays = new_pays
        counts = np.bincount(bs, minlength=self.n_slots)
        old_len = np.diff(self._offsets)
        self._offsets = self._offsets + np.concatenate(
            [[0], np.cumsum(counts)])
        upd = np.flatnonzero(counts)
        if upd.size:
            self._maxlen = max(self._maxlen,
                               int(np.max(old_len[upd] + counts[upd])))
        # all three arrays were rebuilt above: any pinned snapshot keeps
        # the pre-merge arrays, so the new storage is privately owned
        self._shared = False

    # ------------------------------------------------------------------
    # export / copy
    # ------------------------------------------------------------------
    def csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(offsets, keys, payloads) — views of the canonical storage
        after flushing pending appends (free when nothing is pending;
        copy before mutating the structure)."""
        self._flush()
        return self._offsets, self._keys, self._pays

    def copy(self) -> "CSRLinks":
        self._flush()
        return CSRLinks(self.n_slots, self._offsets.copy(),
                        self._keys.copy(), self._pays.copy())

    @staticmethod
    def from_dict(n_slots: int, d) -> "CSRLinks":
        """Build from the legacy dict-of-sorted-lists representation."""
        out = CSRLinks(n_slots)
        if d:
            slots = np.concatenate(
                [np.full(len(v), int(i), np.int64) for i, v in d.items()])
            keys = np.concatenate(
                [np.array([k for k, _ in v], np.float64) for v in d.values()])
            pays = np.concatenate(
                [np.array([p for _, p in v], np.int64) for v in d.values()])
            out.append_batch(slots, keys, pays)
        return out
