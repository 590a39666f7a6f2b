"""Readings of the serving queue's spans: ``portbench.spans.stage_idle``
with the root span and the stage spans as parameters.

The program's ``MicroBatchQueue`` marks each coalesced lookup dispatch
with a root span ``queue.flush`` and its stages ``queue.stage``,
``queue.dispatch`` (which holds ``Index.lookup``'s own ``lookup`` spans)
and ``queue.scatter``.  Their names share the root's prefix, so the
stages are named here rather than found by prefix.  Each instant of the
window inside a root span counts once, under the innermost named stage
span that covers it (the one that started last), or as unstaged.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from portbench.spans import _inside, _union

ROOT = "queue.flush"
STAGES = ("queue.stage", "queue.dispatch", "queue.scatter")


def stage_idle(ev, root: str = ROOT,
               stages: Sequence[str] = STAGES) -> Optional[dict]:
    """``{"calls", "idle_us", "stage_idle_us": {stage: us}}``: the root
    spans in the window of ``ev`` (``trace.Events``), the device's idle
    time inside them, and of it the time under each stage; None where
    the window holds no root span."""
    w0, w1 = ev.window
    names = np.array(ev.host_names, dtype=object)
    hs = np.clip(ev.host_start, w0, w1)
    he = np.clip(ev.host_end, w0, w1)
    live = he > hs
    is_root = live & (names == root)
    if not is_root.any():
        return None
    is_stage = live & np.isin(names, list(stages))
    rs, re_ = _union(hs[is_root], he[is_root])
    bs, be = ev.busy_intervals()
    ss, se, sn = hs[is_stage], he[is_stage], names[is_stage]
    cuts = np.unique(np.concatenate([[w0, w1], rs, re_, bs, be, ss, se]))
    mid = 0.5 * (cuts[:-1] + cuts[1:])
    length = np.diff(cuts)
    idle = _inside(rs, re_, mid) & ~_inside(bs, be, mid)
    label = np.full(mid.size, -1, np.int64)
    code = np.array([list(stages).index(n) for n in sn], np.int64)
    order = np.lexsort((-se, ss))
    lo = np.searchsorted(cuts, ss[order])
    hi = np.searchsorted(cuts, se[order])
    for a, b, k in zip(lo, hi, code[order]):
        label[a:b] = k
    staged = label >= 0
    sums = np.bincount(label[idle & staged], weights=length[idle & staged],
                       minlength=len(stages))
    return {"calls": int(is_root.sum()),
            "idle_us": float(length[idle].sum()),
            "stage_idle_us": {n: float(v) for n, v in zip(stages, sums)}}


def queue_stages(run) -> Optional[dict]:
    """``stage_idle`` of the run's trace, computed once a run."""
    if run.events is None:
        return None
    if not hasattr(run, "_queue_stages"):
        run._queue_stages = stage_idle(run.events)
    return run._queue_stages
