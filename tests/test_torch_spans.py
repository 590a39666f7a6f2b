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


QUEUE_STAGES = ("queue.stage", "queue.dispatch", "queue.scatter")


@pytest.fixture(scope="module")
def built64():
    """A 64-bit index (keys past 2^63) and 3 callers' lookups."""
    rng = np.random.default_rng(30)
    keys = np.unique(rng.integers(2 ** 63, 2 ** 64 - 2, 30_000,
                                  dtype=np.uint64))
    idx = Index.build(keys, method="pgm", eps=64, gap_rho=0.15,
                      sample_rate=0.1, payloads=rng.permutation(keys.size),
                      rng=np.random.default_rng(1), device="cpu")
    idx.sync_device()
    return idx, [keys[rng.integers(0, keys.size, n)]
                 for n in (700, 900, 500)]


def test_traced_queue_flush_nests_its_stages(built64):
    """One coalesced dispatch under a recording profiler: the root span
    ``queue.flush`` holds ``queue.stage``, ``queue.dispatch`` (with
    ``Index.lookup``'s ``lookup`` span inside) and ``queue.scatter``, one
    after another on one thread; the answers are the untraced ones."""
    from repro_torch.serving import EpochPipeline, MicroBatchQueue
    idx, batches = built64
    q = MicroBatchQueue(EpochPipeline(idx))
    want = [q.result(t) for t in [q.submit_lookup(b) for b in batches]]
    tickets = [q.submit_lookup(b) for b in batches]
    with torch.profiler.profile() as prof:
        q.flush()
    for t, w in zip(tickets, want):
        _same(q.result(t), w)
    ev = [e for e in prof.events()
          if e.name.startswith("queue.") or e.name == "lookup"]
    roots = [e for e in ev if e.name == "queue.flush"]
    assert len(roots) == 1
    root = roots[0]
    inner = sorted((e for e in ev if e is not root),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in inner] == ["queue.stage", "queue.dispatch",
                                       "lookup", "queue.scatter"]
    for e in inner:
        assert e.thread == root.thread
        assert root.time_range.start <= e.time_range.start
        assert e.time_range.end <= root.time_range.end
    stages = [e for e in inner if e.name in QUEUE_STAGES]
    for a, b in zip(stages, stages[1:]):
        assert a.time_range.end <= b.time_range.start
    dispatch, lookup = inner[1], inner[2]
    assert dispatch.time_range.start <= lookup.time_range.start
    assert lookup.time_range.end <= dispatch.time_range.end
    q.close()


def test_queue_counters_and_lookups_u64_count_what_was_sent(built64):
    """``lookup_keys`` counts the keys dispatched (padding left out),
    ``lookup_wait_ms_sum`` each request's wait from its submit to its
    flush, ``Index.stats["lookups_u64"]`` the device lookups on the
    64-bit image (a lookup below the device batch runs on the host)."""
    import time as _time
    from repro_torch.serving import EpochPipeline, MicroBatchQueue
    idx, batches = built64
    q = MicroBatchQueue(EpochPipeline(idx))
    u0 = idx.stats.get("lookups_u64", 0)
    t0 = _time.perf_counter()
    tickets = [q.submit_lookup(b) for b in batches]
    _time.sleep(0.02)
    q.flush()
    waited = _time.perf_counter() - t0
    tickets.append(q.submit_lookup(batches[0]))
    q.flush()
    for t in tickets:
        q.result(t)
    st = q.stats
    assert st["lookup_dispatches"] == 2 and st["coalesced_lookups"] == 4
    assert st["lookup_keys"] == sum(b.size for b in batches) + 700
    assert 3 * 20.0 <= st["lookup_wait_ms_sum"] <= 4 * waited * 1e3
    assert idx.stats["lookups_u64"] - u0 == 2
    idx.lookup(batches[0][:100])           # below the device batch
    assert idx.stats["lookups_u64"] - u0 == 2
    q.close()
