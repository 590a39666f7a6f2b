"""Readings of the program's own spans and stage counters.

The program (``repro_torch.spans``) marks each call of ``Index.lookup``
with a root span ``lookup`` and each stage inside it with a span
``lookup.<stage>``; under the traced run's profiler these are host
events on the clock of the device ops.  ``stage_idle`` lays them over
the device's busy intervals: each instant of the window inside a root
span counts once, under the innermost stage span that covers it (the
one that started last), or as unstaged.  The set-up stages are the
program's counters: ``GappedArray.build_timings`` and
``Index.stats["freeze_stages"]``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

ROOT = "lookup"
STAGE = "lookup."

# the stages each ``lookup_idle_<group>_ms.read`` metric sums
GROUPS = {
    "in": ("lookup.route", "lookup.prepare", "lookup.copy_in"),
    "launch": ("lookup.sort", "lookup.search", "lookup.unsort"),
    "fixup": ("lookup.fixup", "lookup.oracle"),
    "out": ("lookup.copy_out", "lookup.finish"),
}


def _union(s, e):
    """Intervals merged into disjoint ones, in order."""
    if not s.size:
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    return s[new], np.maximum.reduceat(e, idx)


def _inside(starts, ends, x):
    """Whether each point of ``x`` lies in one of the disjoint, ordered
    intervals."""
    if not starts.size:
        return np.zeros(x.shape, bool)
    at = np.searchsorted(starts, x, side="right") - 1
    return (at >= 0) & (ends[np.maximum(at, 0)] > x)


def stage_idle(ev) -> Optional[dict]:
    """Device-idle and host time under the program's spans in the window
    of ``ev`` (``trace.Events``), in microseconds: ``calls`` (root spans
    in the window), ``idle_us`` (device idle inside root spans),
    ``unstaged_idle_us`` (of it, under no stage span), ``stage_idle_us``
    and ``stage_self_us`` (per stage span name: the idle time, and all
    the time, for which it is the innermost stage) and
    ``unstaged_self_us``.  None where the window holds no root span."""
    w0, w1 = ev.window
    names = np.array(ev.host_names, dtype=object)
    hs = np.clip(ev.host_start, w0, w1)
    he = np.clip(ev.host_end, w0, w1)
    live = he > hs
    is_root = live & (names == ROOT)
    if not is_root.any():
        return None
    is_stage = live & np.array([n.startswith(STAGE) for n in ev.host_names],
                               bool)
    rs, re_ = _union(hs[is_root], he[is_root])
    bs, be = ev.busy_intervals()
    ss, se, sn = hs[is_stage], he[is_stage], names[is_stage]
    cuts = np.unique(np.concatenate([[w0, w1], rs, re_, bs, be, ss, se]))
    mid = 0.5 * (cuts[:-1] + cuts[1:])
    length = np.diff(cuts)
    in_root = _inside(rs, re_, mid)
    idle = in_root & ~_inside(bs, be, mid)
    # paint each stage over its segments, outer before inner: a span
    # that starts later (or as early and ends sooner) lies inside
    kinds = sorted(set(sn))
    code = np.array([kinds.index(n) for n in sn], np.int64)
    label = np.full(mid.size, -1, np.int64)
    order = np.lexsort((-se, ss))
    lo = np.searchsorted(cuts, ss[order])
    hi = np.searchsorted(cuts, se[order])
    for a, b, k in zip(lo, hi, code[order]):
        label[a:b] = k
    staged = label >= 0

    def per_stage(mask):
        mask = mask & staged
        sums = np.bincount(label[mask], weights=length[mask],
                           minlength=len(kinds))
        return {n: float(v) for n, v in zip(kinds, sums)}

    return {"calls": int(is_root.sum()),
            "idle_us": float(length[idle].sum()),
            "unstaged_idle_us": float(length[idle & ~staged].sum()),
            "stage_idle_us": per_stage(idle),
            "stage_self_us": per_stage(in_root),
            "unstaged_self_us": float(length[in_root & ~staged].sum())}


def lookup_stages(run) -> Optional[dict]:
    """``stage_idle`` of the run's trace, computed once a run."""
    if run.events is None:
        return None
    if not hasattr(run, "_lookup_stages"):
        run._lookup_stages = stage_idle(run.events)
    return run._lookup_stages


def idle_ms_per_call(run, group: str) -> Optional[float]:
    """Device-idle ms per ``Index.lookup`` call under the stages of
    ``GROUPS[group]``."""
    st = lookup_stages(run)
    if st is None:
        return None
    us = sum(st["stage_idle_us"].get(n, 0.0) for n in GROUPS[group])
    return us / 1e3 / st["calls"]


def unstaged_idle_share(run) -> Optional[float]:
    """The share of device-idle time inside ``lookup`` spans that no
    stage span covers."""
    st = lookup_stages(run)
    if st is None or st["idle_us"] <= 0:
        return None
    return st["unstaged_idle_us"] / st["idle_us"]


def build_seconds(run, key: str) -> Optional[float]:
    """``GappedArray.build_timings[key]`` of the run's index."""
    gapped = getattr(getattr(run, "system", None), "gapped", None)
    return (getattr(gapped, "build_timings", None) or {}).get(key)


def freeze_seconds(run, stage: str) -> Optional[float]:
    """``Index.stats["freeze_stages"][stage]`` of the run's index (its
    last freeze)."""
    stats = getattr(getattr(run, "system", None), "stats", None) or {}
    return stats.get("freeze_stages", {}).get(stage)
