"""Legacy ``LearnedIndex`` facade — a thin deprecation shim over the
unified ``repro.core.Index`` handle.

``LearnedIndex`` predates the epoch-versioned handle; it returned bare
arrays from ``lookup`` (positions for static builds, payloads for gapped
ones, -1 sentinels for both) and ad-hoc dicts/strings from dynamic ops.
The handle replaces all of that with typed results (``LookupResult`` /
``IngestReport``) and owns the frozen device state.

Migration:

====================================  =================================
old                                   new
====================================  =================================
``LearnedIndex.build(...)``           ``Index.build(...)``
``idx.lookup(q) -> ndarray``          ``idx.lookup(q).payloads``
``idx.insert_batch(k, p) -> dict``    ``idx.ingest(k, p) -> IngestReport``
``QueryEngine.from_index(idx)``       ``idx.lookup(q, backend=...)`` (the
                                      handle freezes lazily and keeps the
                                      engine fresh via delta updates)
====================================  =================================

``LearnedIndex.lookup`` keeps the old array returns for one release and
emits a ``DeprecationWarning``; everything else inherits the handle's
behavior unchanged (same build knobs, same §5.3 dynamic ops).
"""

from __future__ import annotations

import warnings

import numpy as np

from .handle import Index

__all__ = ["LearnedIndex"]


class LearnedIndex(Index):
    """Deprecated facade — use ``repro.core.Index`` (see module doc)."""

    def lookup(self, qs: np.ndarray, **kwargs) -> np.ndarray:
        """Legacy lookup: positions (static) / payloads (gapped); -1 for
        misses.  One-release shim: routes through the unified
        ``LookupResult`` and returns its payload array (identical values
        — static payloads ARE positions), warning once per call site.
        """
        warnings.warn(
            "LearnedIndex.lookup returning a bare array is deprecated; "
            "use repro.core.Index.lookup -> LookupResult (payloads/slots/"
            "found/stats)", DeprecationWarning, stacklevel=2)
        return np.asarray(Index.lookup(self, qs, **kwargs).payloads)
