"""Fault tolerance primitives: straggler watchdog + failure injection.

At thousand-node scale the dominant events are (a) slow hosts
(stragglers), (b) dead hosts (restart), (c) flaky steps (NaN/timeout).
The Trainer composes:

  * :class:`StepWatchdog` — wall-clock alarm around each step; on
    expiry it records a straggler event and invokes a callback
    (production: mark host suspect, pre-empt its shard; here: logged and
    surfaced in metrics so tests can assert on it).
  * :class:`FailureInjector` — deterministic fault schedule for tests/
    examples (raise at step k, NaN at step m), proving the
    checkpoint-restart path end to end.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional


class StepWatchdog:
    def __init__(self, timeout_s: float,
                 on_timeout: Optional[Callable[[int, float], None]] = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self.events: List[Dict] = []
        self._timer: Optional[threading.Timer] = None
        self._t0 = 0.0
        self._step = -1

    def _fire(self):
        elapsed = time.monotonic() - self._t0
        self.events.append({"step": self._step, "elapsed_s": elapsed})
        if self.on_timeout is not None:
            self.on_timeout(self._step, elapsed)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # cancel even on exception exit — an armed timer surviving a
        # crashed step would fire a bogus straggler event for a step
        # that never completed, and keep a thread alive past teardown
        self.close()
        return False

    def arm(self, step: int):
        self.cancel()
        self._step = step
        self._t0 = time.monotonic()
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def cancel(self) -> Optional[threading.Timer]:
        t, self._timer = self._timer, None
        if t is not None:
            t.cancel()
        return t

    def close(self, timeout_s: float = 1.0):
        """Cancel and JOIN the timer thread so no ``_fire`` callback can
        run after the owner is torn down (cancel() alone races a timer
        that already started firing)."""
        t = self.cancel()
        if (t is not None and t.is_alive()
                and t is not threading.current_thread()):
            t.join(timeout=timeout_s)


class FailureInjector:
    """Deterministic fault schedule: {step: kind} with kind in
    {"crash", "nan", "slow"}."""

    def __init__(self, schedule: Optional[Dict[int, str]] = None):
        self.schedule = dict(schedule or {})
        self.fired: List[int] = []

    def maybe_fail(self, step: int):
        kind = self.schedule.get(step)
        if kind is None or step in self.fired:
            return None
        self.fired.append(step)
        if kind == "crash":
            raise RuntimeError(f"injected crash at step {step}")
        if kind == "slow":
            time.sleep(0.2)
        return kind
