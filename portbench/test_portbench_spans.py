"""The readers of the program's spans and stage counters: device-idle
time under each stage span of a synthetic trace, and whole traced runs
on the CPU at a small size, which report every new metric (and the
control, which runs no program, none)."""

import types

import numpy as np
import pytest
import torch

from portbench import harness, spans, trace
from portbench.test_portbench_runs import SEED, SMALL

NEW = ("lookup_idle_in_ms.read", "lookup_idle_launch_ms.read",
       "lookup_idle_fixup_ms.read", "lookup_idle_out_ms.read",
       "lookup_unstaged_idle.read", "build_learn_s", "build_place_s",
       "freeze_images_s", "freeze_upload_s", "freeze_bounds_s",
       "freeze_routers_s", "freeze_mirror_s")


@pytest.fixture(autouse=True)
def _in_process(monkeypatch):
    """One thread, and no look for JAX in ``sys.modules`` (other test
    files import it into this worker)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(harness, "leaked_modules", lambda: [])
    yield
    torch.set_num_threads(prev)


def _events():
    """Three calls in a window of 100 us; the device busy over [10, 30]
    and [66, 70].  Call 1 nests ``lookup.fixup`` inside
    ``lookup.search`` and starts ``lookup.unsort`` with
    ``lookup.copy_out``; call 2 overlaps ``lookup.prepare`` with a later
    ``lookup.sort``; call 3 runs past the window's end; one stage span
    lies outside every call."""
    host = [("pb.window", 0, 100), ("pb.lookup", 4, 51),
            ("lookup", 5, 50), ("lookup.route", 5, 8),
            ("lookup.search", 8, 40), ("aten::copy_", 9, 12),
            ("lookup.fixup", 25, 35), ("lookup.copy_out", 40, 48),
            ("lookup.unsort", 40, 44), ("lookup.copy_in", 50.5, 54),
            ("lookup", 55, 95), ("lookup.prepare", 55, 65),
            ("lookup.sort", 60, 75), ("lookup.oracle", 80, 95),
            ("lookup", 97, 120), ("lookup.finish", 99, 120)]
    return trace.Events(
        dev_names=["k1", "k2", "k3"],
        dev_start=np.array([10.0, 15.0, 66.0]),
        dev_end=np.array([20.0, 30.0, 70.0]),
        host_names=[h[0] for h in host],
        host_start=np.array([h[1] for h in host], np.float64),
        host_end=np.array([h[2] for h in host], np.float64),
        window=(0.0, 100.0))


def test_idle_under_each_stage_span():
    st = spans.stage_idle(_events())
    assert st["calls"] == 3
    assert st["idle_us"] == pytest.approx(64.0)
    assert st["unstaged_idle_us"] == pytest.approx(9.0)
    assert st["stage_idle_us"] == pytest.approx({
        "lookup.route": 3.0, "lookup.prepare": 5.0, "lookup.copy_in": 0.0,
        "lookup.sort": 11.0, "lookup.search": 7.0, "lookup.unsort": 4.0,
        "lookup.fixup": 5.0, "lookup.oracle": 15.0,
        "lookup.copy_out": 4.0, "lookup.finish": 1.0})
    self_us = st["stage_self_us"]
    assert self_us["lookup.search"] == pytest.approx(22.0)
    assert self_us["lookup.fixup"] == pytest.approx(10.0)
    assert self_us["lookup.sort"] == pytest.approx(15.0)
    assert st["unstaged_self_us"] == pytest.approx(9.0)

    run = types.SimpleNamespace(events=_events())
    per_call = {g: spans.idle_ms_per_call(run, g) for g in spans.GROUPS}
    assert per_call == pytest.approx({"in": 8 / 3e3, "launch": 22 / 3e3,
                                      "fixup": 20 / 3e3, "out": 5 / 3e3})
    assert spans.unstaged_idle_share(run) == pytest.approx(9 / 64)


def test_readers_find_nothing_without_program_spans():
    ev = _events()
    keep = [i for i, n in enumerate(ev.host_names)
            if not n.startswith("lookup")]
    ev.host_names = [ev.host_names[i] for i in keep]
    ev.host_start, ev.host_end = ev.host_start[keep], ev.host_end[keep]
    run = types.SimpleNamespace(events=ev, system=object())
    assert spans.stage_idle(ev) is None
    assert spans.idle_ms_per_call(run, "in") is None
    assert spans.unstaged_idle_share(run) is None
    assert spans.build_seconds(run, "learn_seconds") is None
    assert spans.freeze_seconds(run, "upload") is None
    assert spans.idle_ms_per_call(types.SimpleNamespace(events=None),
                                  "in") is None


def _traced(cell, **kw):
    return harness.execute(cell, SEED, 0.5, True, device="cpu",
                           overrides=SMALL[cell], log=lambda m: None, **kw)


def test_traced_run_reports_the_stage_metrics():
    out = _traced("sosd32m.get-4k")
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW) <= set(got)
    assert all(got[k] >= 0.0 for k in NEW)
    assert got["lookup_unstaged_idle.read"] <= 0.05
    assert (got["build_learn_s"] + got["build_place_s"]
            <= got["build_s"])
    assert sum(got[f"freeze_{s}_s"] for s in
               ("images", "upload", "bounds", "routers", "mirror")
               ) <= got["freeze_s"]


def test_traced_control_reports_no_stage_metric():
    out = _traced("sosd32m.get-4k", control=True)
    assert not set(NEW) & set(out["metrics"])
