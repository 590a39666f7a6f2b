"""The least work of a lookup batch over exact 64-bit integer keys.

``lookup_least_bytes_u64`` is ``yardstick.lookup_least_bytes``'s frozen
count on uint64 keys, compared exactly: 8 bytes per query read once, 9
per answer written once (payload and found), 16 per distinct present
key the batch asks for (key and payload).  Float64 would merge
neighbouring 63-bit keys.
"""

from __future__ import annotations

import numpy as np


def lookup_least_bytes_u64(queries, keys) -> int:
    """The least bytes one lookup batch moves; ``keys`` sorted uint64."""
    q = np.asarray(queries, np.uint64)
    uq = np.unique(q)
    at = np.minimum(np.searchsorted(keys, uq), keys.size - 1)
    distinct_present = int(np.count_nonzero(keys[at] == uq))
    return 8 * q.size + 9 * q.size + 16 * distinct_present
