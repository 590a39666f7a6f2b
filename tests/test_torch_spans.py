"""The port's spans and set-up stage counters (``repro_torch.spans``):
no profiler event without a profiler, every stage of ``Index.lookup``
inside its root span on one thread under one, unchanged answers, and
the freeze's and the build's stage seconds."""

import copy

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core import Index

STAGES = ("lookup.route", "lookup.prepare", "lookup.copy_in", "lookup.sort",
          "lookup.search", "lookup.fixup", "lookup.unsort",
          "lookup.copy_out", "lookup.finish")
FREEZE_STAGES = {"images", "upload", "bounds", "routers", "mirror"}


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(28)
    keys = np.unique(rng.choice(2 ** 32, 40_000, replace=False)
                     ).astype(np.float64)
    idx = Index.build(keys, method="pgm", eps=64, gap_rho=0.15,
                      sample_rate=0.1, payloads=rng.permutation(keys.size),
                      rng=np.random.default_rng(1), device="cpu")
    idx.sync_device()
    return idx, rng.choice(keys, 4096)


def _same(a, b):
    assert np.array_equal(a.payloads, b.payloads)
    assert np.array_equal(a.slots, b.slots)
    assert np.array_equal(a.found, b.found)
    assert a.backend == b.backend


def test_no_profiler_opens_no_record_function(built, monkeypatch):
    idx, q = built
    opened = []
    real = spans._record

    def counting(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(spans, "_record", counting)
    idx.lookup(q)
    assert opened == []
    with torch.profiler.profile():
        idx.lookup(q)
    assert opened[0] == "lookup" and set(STAGES) <= set(opened)


def test_traced_lookup_records_each_stage_inside_its_root(built):
    idx, q = built
    want = idx.lookup(q)
    with torch.profiler.profile() as prof:
        got = idx.lookup(q)
    _same(want, got)
    ev = [e for e in prof.events() if e.name.split(".")[0] == "lookup"]
    roots = [e for e in ev if e.name == "lookup"]
    assert len(roots) == 1
    root = roots[0]
    stages = [e for e in ev if e is not root]
    assert sorted({e.name for e in stages}) == sorted(STAGES)
    for e in stages:
        assert e.thread == root.thread
        assert root.time_range.start <= e.time_range.start
        assert e.time_range.end <= root.time_range.end
    # the stages run one after another, in the order of the pipeline
    stages.sort(key=lambda e: e.time_range.start)
    assert [e.name for e in stages] == list(STAGES)
    for a, b in zip(stages, stages[1:]):
        assert a.time_range.end <= b.time_range.start


def test_span_into_adds_seconds_under_the_last_part_of_its_name():
    into = {}
    with spans.span("freeze.upload", into):
        pass
    with spans.span("freeze.upload", into):
        pass
    with spans.span("build.learn", into):
        pass
    assert set(into) == {"upload", "learn"}
    assert all(v >= 0.0 for v in into.values())


def test_freeze_stages_and_build_timings(built):
    idx, _ = built
    stages = idx.stats["freeze_stages"]
    assert set(stages) == FREEZE_STAGES
    assert all(v >= 0.0 for v in stages.values())
    assert sum(stages.values()) <= idx.stats["freeze_seconds"]
    timings = idx.gapped.build_timings
    assert timings["learn_seconds"] >= 0.0
    assert timings["place_seconds"] >= 0.0
    assert (timings["learn_seconds"] + timings["place_seconds"]
            <= idx.build_seconds)
    dup = copy.deepcopy(idx)
    assert dup.stats["freeze_stages"] == stages
    assert dup.stats["freeze_stages"] is not stages
    assert dup.gapped.build_timings == timings
    # a refreeze records the stages of the last freeze
    idx.refreeze()
    assert set(idx.stats["freeze_stages"]) == FREEZE_STAGES
    assert idx.stats["freeze_stages"] is not stages
