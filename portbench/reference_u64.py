"""The benchmark's plain reference for 64-bit keys: an exact key ->
payload map in plain torch.

Keys are integers in [0, 2^64), given as uint64 (or non-negative
integer) arrays.  Each is held as an int64 with its top bit flipped (the
uint64 bias), whose signed order is the keys' order, and queries are
answered by ``torch.searchsorted`` over the sorted keys.  It imports
nothing of the program under test: the benchmark's copy of
``src/repro_torch/plain_kv.py``, which decides ``correct`` in the cells
over 64-bit keys.

``PlainKV(..., dtype=torch.float32)`` is a control: the same map with
keys and queries rounded to float32, where neighbouring 63-bit keys
collide and answers go wrong.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PlainKV", "biased", "count_wrong"]

_BIAS = np.uint64(1 << 63)


def biased(keys) -> torch.Tensor:
    """uint64 keys as an int64 tensor in the same order (top bit
    flipped)."""
    u = np.asarray(keys).astype(np.uint64)
    return torch.from_numpy((u ^ _BIAS).view(np.int64).copy())


class PlainKV:
    def __init__(self, keys, payloads, dtype=torch.int64):
        self.dtype = dtype
        k = self._keys(keys)
        order = torch.argsort(k, stable=True)
        self.keys = k[order]
        self.payloads = torch.from_numpy(
            np.asarray(payloads, np.int64).copy())[order]

    def _keys(self, keys) -> torch.Tensor:
        if self.dtype == torch.int64:
            return biased(keys)
        return torch.from_numpy(
            np.asarray(keys).astype(np.float64)).to(self.dtype)

    def answer(self, queries):
        """``(payloads, found)`` as numpy arrays; -1 and False for an
        absent key."""
        q = self._keys(np.atleast_1d(queries))
        if self.keys.numel() == 0:
            return (np.full(q.shape[0], -1, np.int64),
                    np.zeros(q.shape[0], bool))
        at = torch.searchsorted(self.keys, q).clamp_(max=self.keys.numel()
                                                    - 1)
        found = self.keys[at] == q
        pay = torch.where(found, self.payloads[at], torch.full_like(at, -1))
        return pay.numpy(), found.numpy()


def count_wrong(ref: PlainKV, queries, payloads, found) -> int:
    """Answers whose payload or found differs from the reference's."""
    want_pay, want_found = ref.answer(queries)
    return int(np.count_nonzero((np.asarray(payloads) != want_pay)
                                | (np.asarray(found, bool) != want_found)))
