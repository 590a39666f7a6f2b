"""Named spans on the torch profiler's clock, and set-up stage timers.

``span(name)`` marks one stage of the program.  While a torch profiler
records, the stage is a record-function host event: it lies on the same
clock as the profiler's device events and nests by time with the other
spans of its thread, so a reader of the trace can say which stage the
host was in while the device idled.  With no profiler recording, a span
costs one check.

The event is torch's C++ ``_RecordFunctionFast`` where torch has it,
``torch.profiler.record_function`` otherwise: both record the same host
event, and the first costs a few microseconds less a span, which on the
lookup path under the profiler is a few percent of a call.

``span(name, into)`` also adds the stage's seconds on the host clock to
``into`` under the last dotted part of ``name`` (``"freeze.upload"``
adds to ``into["upload"]``), profiler or not.  It serves one-time
set-up stages; the lookup path passes no ``into``.

This is the program's only tracing mechanism: the profiler keeps the
spans in memory and hands them to whoever stops it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span"]

_OFF = contextlib.nullcontext()
_record = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
           or torch.profiler.record_function)


@contextlib.contextmanager
def _timed(name: str, into: dict):
    key = name.rpartition(".")[2]
    t0 = time.perf_counter()
    with _record(name) if _profiler._is_profiler_enabled else _OFF:
        yield
    into[key] = into.get(key, 0.0) + time.perf_counter() - t0


def span(name: str, into: Optional[dict] = None):
    """A context manager for the stage ``name`` (see module doc)."""
    if into is not None:
        return _timed(name, into)
    # torch's own flag, true exactly while a torch profiler records, on
    # any thread (``torch._C._autograd._profiler_enabled()`` reads false
    # under the profiler's ``profile_all_threads``)
    if _profiler._is_profiler_enabled:
        return _record(name)
    return _OFF
