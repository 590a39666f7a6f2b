"""The port's serving stack against the reference's: the single-device
cases of tests/test_serving_pipeline.py (snapshot isolation,
refcounts, the auditor, admission control, the MDL-drift retrain
trigger) run on the port, and where a case is a sequence of operations
the same sequence goes through both packages and the answers and stats
are compared exactly.  One test runs the port's stack under the
reference's lock sanitizer.  Inputs are made with numpy from a seed
and handed to both packages."""

import threading
import time

import numpy as np
import pytest

from repro.analysis import sanitize_serving_stack
from repro.core import Index as RefIndex
from repro.robustness import FaultInjector as RefFaultInjector
from repro.robustness import InjectedCrash as RefInjectedCrash
from repro.serving import EpochPipeline as RefPipeline
from repro.serving import IngestWAL as RefWAL
from repro.serving import MicroBatchQueue as RefQueue
from repro_torch.core import Index, Overloaded
from repro_torch.robustness import (FaultInjector, InjectedCrash,
                                    InjectedFault, InvariantAuditor)
from repro_torch.serving import (EpochPipeline, IngestWAL, MicroBatchQueue,
                                 pin_index)

PORT = (Index, EpochPipeline, MicroBatchQueue, IngestWAL)
REF = (RefIndex, RefPipeline, RefQueue, RefWAL)


def _keys(n, seed, wide):
    rng = np.random.default_rng(seed)
    # wide: beyond f32 exactness (2^24), inside pair exactness (2^48)
    hi = 2 ** 46 if wide else 2 ** 21
    keys = np.unique(rng.choice(hi, n, replace=False)).astype(np.float64)
    return keys * 2.0   # even grid: every midpoint is a fresh key


def _build(cls, keys, **kw):
    kw = dict(dict(method="pgm", eps=64, gap_rho=0.2), **kw)
    if cls is Index:
        kw["device"] = "cpu"
    return cls.build(keys, **kw)


def _mk_index(n=6_000, seed=0, wide=False, **kw):
    keys = _keys(n, seed, wide)
    return _build(Index, keys, **kw), keys


def _fresh(keys, n):
    mids = np.setdiff1d(keys[:-1] + np.rint(np.diff(keys) * 0.5), keys)
    assert mids.size >= n
    return mids[:n]


def _same(a, b, slots=True):
    assert a.epoch == b.epoch
    assert np.array_equal(a.payloads, b.payloads)
    assert np.array_equal(a.found, b.found)
    if slots:
        assert np.array_equal(a.slots, b.slots)


def _index_stats(idx):
    return {k: v for k, v in idx.stats.items() if k != "freeze_seconds"}


# ---------------------------------------------------------------------------
# snapshot isolation


@pytest.mark.parametrize("wide", [False, True])
def test_snapshot_bit_identical_under_ingest(wide):
    """A pinned snapshot's answers never move while the live index
    ingests, deletes and updates; they equal the quiesced lookup at the
    pinned epoch, and the reference's at every step."""
    keys = _keys(20_000, 0, wide)
    rng = np.random.default_rng(1)
    q = np.concatenate([rng.choice(keys, 1_500),
                        rng.choice(keys, 300) + 1.0,
                        [keys[0] - 4.0, keys[-1] + 4.0]])
    batches = np.array_split(_fresh(keys, 3_000), 4)
    runs = []
    for idx_cls, pipe_cls, _q, _w in (REF, PORT):
        idx = _build(idx_cls, keys)
        quiesced = idx.lookup(q)
        pipe = pipe_cls(idx)
        epoch0 = pipe.epoch
        got = []
        for i, b in enumerate(batches):
            pipe.ingest(b, (50_000 + np.arange(b.size) + i).astype(np.int64))
            r = pipe.lookup(q)
            assert r.epoch == epoch0 and r.backend == "snapshot"
            _same(r, quiesced, slots=False)
            hit = quiesced.found   # the oracle clamps a miss's slot to 0
            assert np.array_equal(r.slots[hit], quiesced.slots[hit])
            got.append(r)
        idx.delete(float(keys[10]))
        idx.update(float(keys[11]), 999_999)
        got.append(pipe.lookup(q))
        _same(got[-1], quiesced, slots=False)
        pipe.publish()
        assert pipe.epoch == pipe.live_epoch > epoch0
        allb = np.concatenate(batches)
        got.append(pipe.lookup(allb))
        assert got[-1].found.all()
        assert not pipe.lookup(np.array([float(keys[10])])).found.any()
        runs.append((got, dict(pipe.stats), _index_stats(idx)))
        pipe.close()
    (ga, sa, ia), (gb, sb, ib) = runs
    for a, b in zip(ga, gb):
        _same(a, b)
    assert sa == sb
    assert {k: ia[k] for k in ("ingests", "retrains")} == {
        k: ib[k] for k in ("ingests", "retrains")}


def test_snapshot_equals_quiesced_after_forced_refreeze():
    idx, keys = _mk_index(n=8_000)
    pipe = EpochPipeline(idx)
    q = keys[::7]
    want = pipe.lookup(q)
    big = _fresh(keys, 4_000)
    pipe.ingest(big, np.arange(big.size, dtype=np.int64))
    idx._sync_device(prefer_delta=False)  # refreeze under the pin
    assert idx.device_epoch == idx.epoch
    got = pipe.lookup(q)
    _same(got, want)
    pipe.close()


def test_concurrent_reader_thread_sees_one_epoch_per_call():
    idx, keys = _mk_index(n=10_000)
    pipe = EpochPipeline(idx)
    b = _fresh(keys, 1_024)
    errors = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            res = pipe.lookup(b)
            nf = int(res.found.sum())
            if nf not in (0, b.size):
                errors.append(f"torn epoch: {nf}/{b.size} found at "
                              f"epoch {res.epoch}")

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    time.sleep(0.02)
    pipe.ingest(b, np.arange(b.size, dtype=np.int64))
    time.sleep(0.02)
    pipe.publish()
    time.sleep(0.02)
    stop.set()
    t.join(timeout=5)
    assert not t.is_alive()
    assert not errors, errors
    assert pipe.lookup(b).found.all()
    pipe.close()


def test_pin_refcount_and_cow_detach():
    idx, keys = _mk_index(n=4_000)
    ga = idx.gapped
    s1 = ga.pin_snapshot()
    s2 = ga.pin_snapshot()
    assert s1.pinned and s2.pinned
    base = s1.lookup_batch(keys[:64])
    idx.insert(float(keys[0] + 1.0), 1)
    assert ga._pins is None
    np.testing.assert_array_equal(s1.lookup_batch(keys[:64]), base)
    np.testing.assert_array_equal(s2.lookup_batch(keys[:64]), base)
    s1.release()
    assert not s1.pinned and s2.pinned
    s2.release()
    assert not s2.pinned
    s2.release()
    InvariantAuditor().assert_ok(idx)


def test_publish_releases_the_old_pin_and_retained_readers_keep_it():
    idx, keys = _mk_index(n=6_000)
    pipe = EpochPipeline(idx)
    old = pipe._snapshot
    old.retain()                        # an in-flight reader
    pre = old.lookup(keys[:64])
    pipe.ingest(_fresh(keys, 128), np.arange(128, dtype=np.int64))
    pipe.publish()
    assert old._snap.pinned             # the reader's reference holds it
    _same(old.lookup(keys[:64]), pre)
    old.release()
    assert not old._snap.pinned
    with pytest.raises(RuntimeError):
        old.retain()
    assert pipe._snapshot._snap.pinned
    pipe.close()
    assert not pipe._snapshot._snap.pinned


def test_static_index_refuses_snapshot():
    keys = _keys(2_000, 0, False)
    idx = Index.build(keys, method="pgm", eps=64, device="cpu")
    with pytest.raises(ValueError, match="gapped"):
        pin_index(idx)


def test_auditor_catches_planted_corruption():
    idx, keys = _mk_index(n=4_000)
    aud = InvariantAuditor()
    aud.assert_ok(idx)
    idx.gapped.occupied[np.flatnonzero(idx.gapped.occupied)[0]] = False
    with pytest.raises(AssertionError, match="slot"):
        aud.assert_ok(idx)


# ---------------------------------------------------------------------------
# admission control (MicroBatchQueue)


def test_deadline_flush_fires_without_explicit_flush():
    idx, keys = _mk_index(n=4_000)
    q = MicroBatchQueue(idx, max_wait_ms=20)
    t = q.submit_lookup(keys[:4])
    deadline = time.monotonic() + 5.0
    while q.stats["deadline_flushes"] == 0:
        assert time.monotonic() < deadline, "deadline timer never fired"
        time.sleep(0.005)
    res = q.result(t)
    assert res.found.all()
    assert res.backend in ("fused", "device-oracle")  # a 512-key bucket
    assert q.stats["flushes"] >= 1
    q.close()


def test_bounded_depth_sheds_with_typed_overloaded():
    idx, keys = _mk_index(n=4_000)
    q = MicroBatchQueue(idx, max_depth=2)
    t1 = q.submit_lookup(keys[:2])
    t2 = q.submit_ingest(_fresh(keys, 2), np.array([1, 2]))
    t3 = q.submit_lookup(keys[4:6])
    shed = q.result(t3)
    assert isinstance(shed, Overloaded) and not shed
    assert shed.kind == "lookup" and shed.depth == 2 == shed.max_depth
    assert q.stats["shed"] == 1
    with pytest.raises(KeyError, match="exactly once"):
        q.result(t3)
    q.flush()
    assert q.result(t1).found.all()
    assert q.result(t2).n == 2
    q.close()


def test_ingest_retry_absorbs_transient_abort():
    idx, keys = _mk_index(n=4_000)
    inj = FaultInjector({("ingest", 0): "abort"})
    q = MicroBatchQueue(idx, faults=inj, ingest_retries=2,
                        retry_backoff_ms=0.1)
    b = _fresh(keys, 8)
    rep = q.result(q.submit_ingest(b, np.arange(8, dtype=np.int64)))
    assert rep.n == 8
    assert q.stats["ingest_retries"] == 1 and q.stats["host_fallbacks"] == 0
    assert inj.fired == [("ingest", 0, "abort")]
    assert idx.lookup(b).found.all()
    q.close()


@pytest.mark.parametrize("setting", [None, True, False])
def test_final_retry_takes_the_host_path_and_restores_the_setting(setting):
    """The last attempt runs with ``fused_ingest_enabled=False``; the
    index gets its own setting back after it — ``None`` (the default:
    on for a cuda engine) stays ``None``."""
    idx, keys = _mk_index(n=4_000)
    idx.fused_ingest_enabled = setting
    seen = []
    ingest = idx.ingest

    def spy(k, p):
        seen.append(idx.fused_ingest_enabled)
        return ingest(k, p)

    idx.ingest = spy
    inj = FaultInjector({("ingest", 0): "abort", ("ingest", 1): "abort"})
    q = MicroBatchQueue(idx, faults=inj, ingest_retries=2,
                        retry_backoff_ms=0.1)
    b = _fresh(keys, 8)
    rep = q.result(q.submit_ingest(b, np.arange(8, dtype=np.int64)))
    assert rep.n == 8 and seen == [False]
    assert q.stats["ingest_retries"] == 2 and q.stats["host_fallbacks"] == 1
    assert idx.fused_ingest_enabled is setting
    q.close()


def test_injected_crash_propagates_through_retry():
    idx, keys = _mk_index(n=4_000)
    inj = FaultInjector({("ingest", 0): "crash"})
    q = MicroBatchQueue(idx, faults=inj, ingest_retries=5)
    t = q.submit_ingest(_fresh(keys, 4), np.arange(4, dtype=np.int64))
    with pytest.raises(InjectedCrash):
        q.result(t)
    assert q.stats["ingest_retries"] == 0
    assert InjectedCrash is not RefInjectedCrash
    q.close()


def test_a_reference_crash_is_not_the_ports():
    """The queue's retry loop lets the port's ``InjectedCrash`` through;
    the reference's class is another class, a ``RuntimeError`` the
    loop retries like any transient fault."""
    idx, keys = _mk_index(n=4_000)
    q = MicroBatchQueue(idx, faults=RefFaultInjector(
        {("ingest", 0): "crash"}), ingest_retries=1, retry_backoff_ms=0.1)
    rep = q.result(q.submit_ingest(_fresh(keys, 4),
                                   np.arange(4, dtype=np.int64)))
    assert rep.n == 4 and q.stats["ingest_retries"] == 1
    q.close()


def test_exhausted_retries_raise_last_error():
    idx, keys = _mk_index(n=4_000)
    inj = FaultInjector({("ingest", i): "abort" for i in range(4)})
    q = MicroBatchQueue(idx, faults=inj, ingest_retries=2,
                        retry_backoff_ms=0.1)
    t = q.submit_ingest(_fresh(keys, 4), np.arange(4, dtype=np.int64))
    with pytest.raises(InjectedFault, match="injected abort"):
        q.result(t)
    q.close()


def test_deadline_timer_error_surfaces_on_next_call():
    idx, keys = _mk_index(n=4_000)
    inj = FaultInjector({("flush", 0): "abort"})
    q = MicroBatchQueue(idx, max_wait_ms=10, faults=inj)
    q.submit_lookup(keys[:4])
    deadline = time.monotonic() + 5.0
    while q._async_error is None:
        assert time.monotonic() < deadline, "timer error never captured"
        time.sleep(0.005)
    with pytest.raises(InjectedFault, match="injected abort"):
        q.submit_lookup(keys[4:8])
    q.close()


def _stack_run(classes, keys, tmp, wide):
    """One op sequence through queue -> pipeline (+ WAL) -> index:
    rounds of coalesced ingests and lookups, a publish every other
    round, a retrain.  Returns every answer, the stats and the log."""
    idx_cls, pipe_cls, queue_cls, wal_cls = classes
    idx = _build(idx_cls, keys, sample_rate=0.05,
                 rng=np.random.default_rng(2))
    wal = wal_cls(tmp / "w.wal", sync_every=4)
    pipe = pipe_cls(idx, wal=wal)
    q = queue_cls(pipe, min_bucket=512)
    fresh = _fresh(keys, 1_200)
    rng = np.random.default_rng(9)
    out = []
    for r in range(6):
        b = fresh[r * 200:(r + 1) * 200]
        t1 = q.submit_ingest(b[:120], 10_000 * r + np.arange(120))
        t2 = q.submit_ingest(b[120:], 10_000 * r + 500 + np.arange(80))
        lk = [q.submit_lookup(np.concatenate(
            [rng.choice(keys, 300), fresh[:(r + 1) * 200:7]]))
            for _ in range(3)]
        res = [q.result(t) for t in lk]
        rep = q.result(t1)
        assert rep is q.result(t2)          # one report, shared
        out.append(([(x.payloads, x.slots, x.found, x.epoch, x.backend)
                     for x in res], rep.n, rep.epoch))
        if r % 2:
            pipe.publish()
        if r == 3:
            pipe.retrain(sample_rate=0.05, rng=np.random.default_rng(4))
    pipe.publish()
    final = pipe.lookup(fresh)
    assert final.found.all()
    stats = (dict(q.stats), dict(pipe.stats), dict(wal.stats))
    q.close()
    pipe.close()
    return out, final, stats, (tmp / "w.wal").read_bytes()


@pytest.mark.parametrize("wide", [False, True])
def test_queue_over_pipeline_with_wal_equals_the_reference(tmp_path, wide):
    keys = _keys(12_000, 3, wide)
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    a = _stack_run(REF, keys, tmp_path / "ref", wide)
    b = _stack_run(PORT, keys, tmp_path / "port", wide)
    for (ra, na, ea), (rb, nb, eb) in zip(a[0], b[0]):
        assert (na, ea) == (nb, eb)
        for x, y in zip(ra, rb):
            for u, v in zip(x[:3], y[:3]):
                assert np.array_equal(u, v)
            assert x[3] == y[3]
            # a snapshot serves with the same label in both; a live
            # lookup's stage may differ (the reference's CPU "fused" is
            # its XLA graph, ROADMAP.md queue C)
            assert (x[4] == "snapshot") == (y[4] == "snapshot")
    _same(a[1], b[1])
    qa, pa, wa = a[2]
    qb, pb, wb = b[2]
    # the port's queue counts more (``lookup_keys``, the keys it
    # dispatched, and ``lookup_wait_ms_sum``): the reference's counters
    # are equal, the port's own count what was sent
    assert {k: qb[k] for k in qa} == qa and pa == pb
    assert set(qb) - set(qa) == {"lookup_keys", "lookup_wait_ms_sum"}
    assert qb["lookup_keys"] == sum(
        3 * (300 + len(range(0, (r + 1) * 200, 7))) for r in range(6))
    assert qb["lookup_wait_ms_sum"] >= 0.0
    assert wa["records"] == wb["records"] and wa["fences"] == wb["fences"]
    assert a[3] == b[3]                      # the same log, byte for byte
    assert pb["retrains"] == 1 and pb["snapshot_lookups"] > 0


def test_queue_over_pipeline_composes():
    idx, keys = _mk_index(n=6_000)
    pipe = EpochPipeline(idx, publish_every=1)
    q = MicroBatchQueue(pipe)
    b = _fresh(keys, 16)
    t1 = q.submit_ingest(b[:8], np.arange(8, dtype=np.int64))
    t2 = q.submit_ingest(b[8:], 8 + np.arange(8, dtype=np.int64))
    t3 = q.submit_lookup(b)
    assert q.result(t3).found.all()
    assert q.result(t1).n == 16 and q.result(t2).n == 16
    assert pipe.stats["publishes"] == 1
    pipe.close()


# ---------------------------------------------------------------------------
# the MDL-drift retrain trigger


def _drift_run(idx_cls, pipe_cls):
    keys = _keys(20_000, 3, False)
    idx = _build(idx_cls, keys, gap_rho=0.15)
    pipe = pipe_cls(idx, retrain_mdl_drift=0.02)
    base0 = pipe._mdl_baseline
    step = float(np.mean(np.diff(keys)))
    tail = np.rint(keys[-1] + step * 10.0 * (1.0 + np.arange(800))) * 2.0
    fired_at = None
    for i in range(4):
        pipe.ingest(tail[i * 200:(i + 1) * 200],
                    (1_000_000 + np.arange(200) + i * 200).astype(np.int64))
        pipe.publish()
        if pipe.stats["mdl_retrains"]:
            fired_at = i
            break
    assert fired_at is not None, "drift never crossed the threshold"
    assert pipe.stats["mdl_checks"] == fired_at + 1
    assert pipe.stats["retrains"] >= 1
    assert pipe._mdl_baseline == pytest.approx(pipe._mdl_score())
    pipe.publish()
    got = pipe.lookup(np.concatenate([keys[:200],
                                      tail[:(fired_at + 1) * 200]]))
    assert got.found.all()
    n_fired = pipe.stats["mdl_retrains"]
    pipe.ingest(_fresh(keys, 32), (77_000 + np.arange(32)).astype(np.int64))
    pipe.publish()
    assert pipe.stats["mdl_retrains"] == n_fired
    out = (fired_at, base0, pipe._mdl_baseline, dict(pipe.stats), got,
           idx.epoch)
    pipe.close()
    return out


def test_mdl_drift_retrain_trigger_equals_the_reference():
    a = _drift_run(RefIndex, RefPipeline)
    b = _drift_run(Index, EpochPipeline)
    assert a[:4] == b[:4] and a[5] == b[5]
    _same(a[4], b[4])


def test_mdl_drift_check_cadence():
    idx, keys = _mk_index(n=6_000)
    pipe = EpochPipeline(idx, retrain_mdl_drift=10.0, retrain_check_every=2)
    fresh = _fresh(keys, 128)
    for i in range(4):
        pipe.ingest(fresh[i * 32:(i + 1) * 32],
                    (np.arange(32) + i * 32).astype(np.int64))
        pipe.publish()
    assert pipe.stats["mdl_checks"] == 2
    assert pipe.stats["mdl_retrains"] == 0
    pipe.close()


# ---------------------------------------------------------------------------
# the lock sanitizer


def test_port_stack_is_sanitizer_clean(tmp_path):
    """Queue + pipeline + WAL of the port under ``repro.analysis``'s
    lock sanitizer, with the deadline timer firing and a second caller
    thread: no lock-order inversion, no unguarded access."""
    idx, keys = _mk_index()
    wal = IngestWAL(tmp_path / "w.wal", sync_every="adaptive")
    pipe = EpochPipeline(idx, wal=wal, publish_every=2)
    queue = MicroBatchQueue(pipe, max_wait_ms=2.0, min_bucket=64)
    san = sanitize_serving_stack(queue=queue, pipeline=pipe, wal=wal)
    fresh = _fresh(keys, 512)
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            t = queue.submit_lookup(keys[:32])
            queue.flush()
            queue.result(t)

    t = threading.Thread(target=reader)
    t.start()
    try:
        for i in range(8):
            bt = queue.submit_ingest(
                fresh[i * 32:(i + 1) * 32],
                (90_000 + np.arange(32) + i).astype(np.int64))
            time.sleep(0.004)
            queue.result(bt)
    finally:
        stop.set()
        t.join(timeout=30)
        queue.close()
        pipe.close()
    assert not t.is_alive()
    san.assert_clean()
    assert any(a.startswith("MicroBatchQueue")
               and b.startswith("EpochPipeline") for (a, b) in san.edges)
    assert pipe.lookup(fresh[:256]).found.all()
