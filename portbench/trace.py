"""The traced run: torch.profiler over the measured window, reduced to
device busy time, the device ops that take most of it, and the idle
gaps named by what the host was doing.

The harness's own spans (``pb.*``, ``torch.profiler.record_function``
around each call into a layer) name the host side; the profiler's
device events (kernels, copies, memsets) give the device side.  All
times are microseconds on the profiler's clock.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

WINDOW_SPAN = "pb.window"
NAMED_GAPS = 200     # the longest gaps also get the host op inside them


@dataclasses.dataclass
class Events:
    """One trace as plain arrays: device ops and host spans, each a
    list of names with start and end times."""
    dev_names: list
    dev_start: np.ndarray
    dev_end: np.ndarray
    host_names: list
    host_start: np.ndarray
    host_end: np.ndarray
    window: tuple            # (start, end) of the window span

    @property
    def window_us(self) -> float:
        return float(self.window[1] - self.window[0])

    def _clipped(self, mask=None):
        s, e = self.dev_start, self.dev_end
        if mask is not None:
            s, e = s[mask], e[mask]
        s = np.clip(s, *self.window)
        e = np.clip(e, *self.window)
        keep = e > s
        return s[keep], e[keep]

    def busy_intervals(self):
        """The union of device-op intervals inside the window, merged."""
        s, e = self._clipped()
        if not s.size:
            return np.zeros(0), np.zeros(0)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        reach = np.maximum.accumulate(e)
        new = np.ones(s.size, bool)
        new[1:] = s[1:] > reach[:-1]
        starts = s[new]
        idx = np.flatnonzero(new)
        ends = np.maximum.reduceat(e, idx)
        return starts, ends

    def busy_us(self) -> float:
        s, e = self.busy_intervals()
        return float((e - s).sum())

    def device_us(self, substr: str) -> float:
        """Summed device time of the ops whose name holds ``substr``."""
        mask = np.array([substr in n for n in self.dev_names], bool)
        if not mask.any():
            return 0.0
        s, e = self._clipped(mask)
        return float((e - s).sum())

    def top_device_ops(self, k: int = 10):
        tot = {}
        s, e = self.dev_start, self.dev_end
        for n, a, b in zip(self.dev_names, s, e):
            a, b = max(a, self.window[0]), min(b, self.window[1])
            if b > a:
                tot[n] = tot.get(n, 0.0) + (b - a)
        rows = sorted(tot.items(), key=lambda r: -r[1])[:k]
        return [[n, us / 1e6] for n, us in rows]

    def idle_gaps(self, k: int = 10):
        """Idle time inside the window by what the host was doing: each
        gap is named by the harness span that covers its midpoint, and
        each of the longest by the innermost other host op there too;
        the top k names with their summed seconds."""
        bs, be = self.busy_intervals()
        w0, w1 = self.window
        g_s = np.concatenate([[w0], be])
        g_e = np.concatenate([bs, [w1]])
        keep = g_e > g_s
        g_s, g_e = g_s[keep], g_e[keep]
        mid = 0.5 * (g_s + g_e)
        names = np.array(self.host_names, dtype=object)
        hs, he = self.host_start, self.host_end
        is_pb = np.array([n.startswith("pb.") and n != WINDOW_SPAN
                          for n in self.host_names], bool)
        ps, pe, pn = hs[is_pb], he[is_pb], names[is_pb]
        order = np.argsort(ps, kind="stable")
        ps, pe, pn = ps[order], pe[order], pn[order]
        at = np.searchsorted(ps, mid, side="right") - 1
        inside = (at >= 0) & (pe[np.maximum(at, 0)] >= mid)
        label = np.where(inside, pn[np.maximum(at, 0)], "host: no span") \
            if ps.size else np.full(mid.shape, "host: no span", object)
        ops = ~is_pb & (names != WINDOW_SPAN)
        os_, oe, on = hs[ops], he[ops], names[ops]
        for i in np.argsort(g_s - g_e, kind="stable")[:NAMED_GAPS]:
            hit = np.flatnonzero((os_ <= mid[i]) & (oe >= mid[i]))
            if hit.size:
                inner = on[hit[np.argmin(oe[hit] - os_[hit])]]
                label[i] = f"{label[i]} > {inner}"
        tot = {}
        for name, us in zip(label, g_e - g_s):
            tot[name] = tot.get(name, 0.0) + us
        rows = sorted(tot.items(), key=lambda r: -r[1])[:k]
        return [[n, us / 1e6] for n, us in rows]


def _rows(prof):
    """``(name, is_device, start_us, end_us, is_annotation)`` of every
    event: the profiler's raw event list, which it hands over without
    building its tree of host ops (that takes minutes for a long
    window); its parsed events where the raw list is not there."""
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None:
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        for ev in raw.events():
            on_dev = ev.device_type() == cuda
            start = ev.start_ns() / 1e3
            yield (ev.name(), on_dev, start, start + ev.duration_ns() / 1e3,
                   on_dev and ev.is_user_annotation())
        return
    for ev in prof.events():
        tr = ev.time_range
        yield (ev.name, "CUDA" in str(getattr(ev, "device_type", "")),
               tr.start, tr.end, getattr(ev, "is_user_annotation", False))


def from_profiler(prof) -> Events:
    """The profiler's events as ``Events``; the window is the
    ``pb.window`` span."""
    dev, host, window = [], [], None
    for name, on_dev, start, end, note in _rows(prof):
        if on_dev:
            dev.append((name, start, end, note))
        else:
            if name == WINDOW_SPAN:
                window = (start, end)
            host.append((name, start, end))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    # a host span's mirror on the device timeline (from its first kernel
    # to its last) is no device op
    spans = {h[0] for h in host}
    dev = [d[:3] for d in dev if not d[3] and d[0] not in spans]

    def cols(rows):
        return ([r[0] for r in rows],
                np.array([r[1] for r in rows], np.float64),
                np.array([r[2] for r in rows], np.float64))

    return Events(*cols(dev), *cols(host), window=window)


class Tracer:
    """``with tracer:`` profiles the window when ``on``; ``span(name)``
    marks a harness span (a no-op when off)."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.events = None
        self.seconds = {}

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def __enter__(self):
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            try:   # host spans of every thread (the serving clients)
                from torch.profiler import _ExperimentalConfig
                cfg = _ExperimentalConfig(profile_all_threads=True)
            except (ImportError, TypeError):
                cfg = None
            self.prof = profile(activities=acts, experimental_config=cfg)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            import time
            import torch
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.prof.__exit__(*exc)
            t1 = time.perf_counter()
            if exc[0] is None:
                self.events = from_profiler(self.prof)
            self.prof = None
            self.seconds = {"stop_s": t1 - t0,
                            "read_s": time.perf_counter() - t1}
        return False
