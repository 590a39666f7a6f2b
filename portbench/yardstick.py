"""The card's peak bandwidth and the least work of a lookup batch.

Peak: NVIDIA's H100 SXM data sheet at the full 700 W (the run records
the card's name and power limit beside every number).
"""

from __future__ import annotations

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3


def lookup_least_bytes(queries, keys) -> int:
    """The least bytes one lookup batch moves, from the benchmark's own
    inputs: 8 bytes per query read once, 9 per answer written once
    (payload and found), 16 per distinct present key the batch asks for
    (key and payload).  Frozen: it counts no tile, window or flat width
    of any kernel, so a kernel that works differently is judged on the
    same work."""
    q = np.asarray(queries, np.float64)
    uq = np.unique(q)                    # sorted: a cache-friendly search
    at = np.minimum(np.searchsorted(keys, uq), keys.size - 1)
    distinct_present = int(np.count_nonzero(keys[at] == uq))
    return 8 * q.size + 9 * q.size + 16 * distinct_present
