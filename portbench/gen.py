"""Traffic generators: keys, payloads, lookup batches, fresh write keys
and YCSB's zipfian request stream, all drawn from the run's seed.

Copied from ``chip_smoke.py`` (``draw_keys``, ``mixed_queries``,
``zipf_sampler``, the serve phase's gap midpoints) so that a change to
the program cannot change the yardstick.  ``mixed_queries`` draws its
present keys from the key set alone: the smoke's tenth of chained keys
came from the index's own layout, which the traffic may not read.
"""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream...): the seed may be
    any whole number up to a little over 2^31 (or larger)."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *stream])


def draw_keys(rng, n: int, key_bits: int) -> np.ndarray:
    """A Bernoulli draw of n of the integers below 2^key_bits, sorted,
    made O(n): geometric gaps with mean 2^bits / (1.01 n) sum to about
    0.99 * 2^bits."""
    span = 2.0 ** key_bits
    for _ in range(100):   # a small n can overshoot; redraw from rng
        gaps = rng.geometric(min(1.0, 1.01 * n / span), n)
        keys = (np.cumsum(gaps) - 1).astype(np.float64)
        if keys[-1] < span:
            return keys
    raise ValueError(f"key draw ran past 2^{key_bits}")


def draw_payloads(rng, n: int, bits: int) -> np.ndarray:
    return rng.integers(0, 1 << bits, n, dtype=np.int64)


def mixed_queries(rng, keys, n, present, absent, out_of_range):
    """``present`` / ``absent`` (in range) / ``out_of_range`` shares of n
    queries (out of range: half below the first key, half above the
    last), in random order."""
    n_present = int(present * n)
    n_out = int(out_of_range * n)
    n_absent = n - n_present - n_out
    pres = rng.choice(keys, n_present)
    cand = np.floor(rng.uniform(keys[0], keys[-1], 2 * n_absent))
    miss = cand[~isin_sorted(keys, cand)][:n_absent]
    below = keys[0] - 1.0 - np.floor(rng.uniform(0, 2.0 ** 20, n_out // 2))
    above = keys[-1] + 1.0 + np.floor(
        rng.uniform(0, 2.0 ** 20, n_out - n_out // 2))
    q = np.concatenate([pres, miss, below, above])
    if q.size < n:   # absent draws that hit a key were dropped
        q = np.concatenate([q, rng.choice(keys, n - q.size)])
    return rng.permutation(q)


def isin_sorted(keys, q) -> np.ndarray:
    """Whether each of ``q`` is in the sorted ``keys``; the needles are
    searched in sorted order (an unsorted search of a large array
    misses the cache on every probe)."""
    order = np.argsort(q, kind="stable")
    qs = q[order]
    at = np.minimum(np.searchsorted(keys, qs), keys.size - 1)
    hit = np.empty(q.shape, bool)
    hit[order] = keys[at] == qs
    return hit


def fresh_keys(rng, keys) -> np.ndarray:
    """Keys absent from ``keys``: the midpoints of its gaps, in random
    order (the serve phase's inserts)."""
    mids = keys[:-1] + np.floor(np.diff(keys) * 0.5)
    mids = mids[(mids > keys[:-1]) & (mids < keys[1:])]
    return rng.permutation(mids)


class Zipf:
    """Bounded Zipf(theta) over ranks 0..n_items-1 by the inverse CDF,
    ranks spread over the key space by a fixed permutation (YCSB's
    request model, as benchmarks/serving_bench.py draws it).  The table
    is built once; each caller draws with its own generator."""

    def __init__(self, n_items: int, theta: float, rng):
        self.n_items = int(n_items)
        self.theta = float(theta)
        if self.theta > 0.0:
            w = 1.0 / np.power(np.arange(1, n_items + 1, dtype=np.float64),
                               theta)
            self.cdf = np.cumsum(w / w.sum())
            self.perm = rng.permutation(n_items)

    def draw(self, rng, size) -> np.ndarray:
        """Independent draws of ``size`` (an int or a shape): the
        uniforms are searched in sorted order, then the draws shuffled,
        which leaves them independent."""
        n = int(np.prod(size))
        if self.theta <= 0.0:
            return rng.integers(0, self.n_items, n).reshape(size)
        u = np.sort(rng.random(n))
        at = np.minimum(np.searchsorted(self.cdf, u), self.n_items - 1)
        return self.perm[rng.permutation(at)].reshape(size)
