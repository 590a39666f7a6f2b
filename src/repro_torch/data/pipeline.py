"""Deterministic, seekable, host-sharded batch pipeline.

Determinism + seekability are the fault-tolerance substrate: a restart at
step k replays the exact key schedule (seeded permutation of sample
keys, re-seeded per epoch) and O(1)-seeks to k — no data loss or dup.
Each data-parallel host takes a strided shard of every global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from .indexed_dataset import IndexedTokenDataset


@dataclasses.dataclass
class ShardedLoader:
    dataset: IndexedTokenDataset
    global_batch: int
    seq_len: int
    seed: int = 0
    shard_id: int = 0
    n_shards: int = 1
    step: int = 0

    def __post_init__(self):
        if self.global_batch % self.n_shards:
            raise ValueError("global_batch must divide evenly across shards")
        self._epoch = -1
        self._perm = None

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.n_shards

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.dataset.store.n_docs // self.global_batch)

    def _ensure_epoch(self, epoch: int):
        if epoch != self._epoch:
            rng = np.random.default_rng((self.seed, epoch))
            self._perm = rng.permutation(self.dataset.store.n_docs)
            self._epoch = epoch

    def seek(self, step: int) -> None:
        """O(1) restart-resume: jump the schedule to ``step``."""
        self.step = step

    def next_batch(self) -> Dict[str, np.ndarray]:
        epoch = self.step // self.steps_per_epoch
        self._ensure_epoch(epoch)
        pos = (self.step % self.steps_per_epoch) * self.global_batch
        sel = self._perm[pos : pos + self.global_batch]
        if len(sel) < self.global_batch:  # wrap the tail deterministically
            sel = np.concatenate([sel, self._perm[: self.global_batch - len(sel)]])
        sel = sel[self.shard_id :: self.n_shards]
        keys = self.dataset.store.sample_keys[sel].astype(np.float64)
        toks = self.dataset.batch(keys, self.seq_len + 1)
        self.step += 1
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "mask": (toks[:, 1:] != 0).astype(np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
