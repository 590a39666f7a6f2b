"""The plain reference: an exact key -> payload map in NumPy.

It imports nothing of the program and takes nothing the program made:
it is given the benchmark's own keys, payloads and writes.  A write
carries the epoch the program acknowledged it at, so an answer is held
against the map as of the epoch the answer reports.

``KVReference(..., dtype=np.float32)`` is the control: the same map with
keys and queries rounded to float32, the precision below the float64
keys the configurations state.  Keys below 2^40 then collide in
groups, and answers go wrong.
"""

from __future__ import annotations

import numpy as np


class KVReference:
    def __init__(self, keys, payloads, dtype=np.float64):
        self.dtype = dtype
        self.keys = np.asarray(keys, np.float64).astype(dtype)
        self.payloads = np.asarray(payloads, np.int64)
        self.w_keys = np.zeros(0, dtype)
        self.w_pays = np.zeros(0, np.int64)
        self.w_epochs = np.zeros(0, np.int64)

    def set_writes(self, keys, payloads, epochs) -> None:
        """Every write: its keys, payloads and the epoch it was
        acknowledged at (one entry per key)."""
        keys = np.asarray(keys, np.float64).astype(self.dtype)
        order = np.argsort(keys, kind="stable")
        self.w_keys = keys[order]
        self.w_pays = np.asarray(payloads, np.int64)[order]
        self.w_epochs = np.asarray(epochs, np.int64)[order]

    @staticmethod
    def _find(keys, q):
        """Position of each query's match in ``keys`` and whether it
        matches; the queries are searched in sorted order."""
        order = np.argsort(q, kind="stable")
        qs = q[order]
        at_s = np.minimum(np.searchsorted(keys, qs), max(keys.size - 1, 0))
        at = np.empty(q.shape, np.int64)
        at[order] = at_s
        hit = np.zeros(q.shape, bool)
        if keys.size:
            hit[order] = keys[at_s] == qs
        return at, hit

    def answer(self, queries, epoch=None):
        """``(payloads, found)`` for ``queries``; -1 and False for an
        absent key.  ``epoch`` (a scalar or one per query) leaves out
        writes acknowledged after it; None counts every write."""
        q = np.asarray(queries, np.float64).astype(self.dtype)
        at, hit = self._find(self.keys, q)
        pay = np.where(hit, self.payloads[at] if self.keys.size else -1, -1)
        found = hit.copy()
        if self.w_keys.size:
            wat, whit = self._find(self.w_keys, q)
            if epoch is not None:
                whit &= self.w_epochs[wat] <= np.asarray(epoch, np.int64)
            pay = np.where(whit & ~hit, self.w_pays[wat], pay)
            found |= whit
        return pay.astype(np.int64), found


def count_wrong(ref, queries, payloads, found, epoch=None) -> int:
    """Answers (rows) whose payload or found differs from the
    reference's."""
    want_pay, want_found = ref.answer(queries, epoch)
    return int(np.count_nonzero((np.asarray(payloads) != want_pay)
                                | (np.asarray(found, bool) != want_found)))
