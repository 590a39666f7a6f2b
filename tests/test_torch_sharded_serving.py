"""The port's sharded index under the serving stack, against the
reference's: sharded snapshots (``sharded_manifest.json`` byte for byte
the reference's, each shard directory as the single-index rule has it:
leaf files byte-equal, the manifest equal but for ``treedef``), restored
both ways, ``recover_index`` of a sharded directory, and the sharded
cases of tests/test_wal_recovery.py, test_serving_pipeline.py,
test_serving.py, test_retrain.py and test_tuning.py, each run on both
packages with the same numpy inputs and compared."""

import json
import os

import numpy as np
import pytest

from conftest import make_keys
from repro.core import Index as RefIndex
from repro.dist.sharded import ShardedIndex as RefSharded
from repro.serving import EpochPipeline as RefPipeline
from repro.serving import IngestWAL as RefWAL
from repro.serving import MicroBatchQueue as RefQueue
from repro.serving import recover_index as ref_recover
from repro_torch.core import Index
from repro_torch.dist import ShardedIndex
from repro_torch.robustness import InvariantAuditor
from repro_torch.serving import (EpochPipeline, IngestWAL, MicroBatchQueue,
                                 recover_index)

LEAVES = ("chain_keys", "chain_payloads", "keys", "mech_pickle",
          "occupied", "offsets", "payload", "slot_key")


def _keys(n, seed, wide):
    rng = np.random.default_rng(seed)
    hi = 2 ** 46 if wide else 2 ** 20   # wide: beyond f32, pair-exact
    keys = np.unique(rng.choice(hi, n, replace=False)).astype(np.float64)
    return keys * 2.0                   # every midpoint is a fresh key


def _fresh(keys, n, skip=0):
    mids = np.setdiff1d(keys[:-1] + np.rint(np.diff(keys) * 0.5), keys)
    assert mids.size >= skip + n
    return mids[skip:skip + n]


def _pair(keys, shards, seed=None, **kw):
    """The same sharded build in both packages, each with a generator
    of its own made from ``seed``."""
    kw = dict(dict(method="pgm", eps=64, gap_rho=0.2), **kw)

    def rng():
        return None if seed is None else np.random.default_rng(seed)

    return (RefIndex.build(keys, shards=shards, rng=rng(), **kw),
            Index.build(keys, shards=shards, rng=rng(), device="cpu", **kw))


def _shard_equal(a, b):
    ga, gb = a.gapped, b.gapped
    return (np.array_equal(ga.slot_key, gb.slot_key)
            and np.array_equal(ga.occupied, gb.occupied)
            and np.array_equal(ga.payload, gb.payload)
            and ga.n_keys == gb.n_keys and a.epoch == b.epoch
            and all(np.array_equal(x, y) for x, y in
                    zip(ga.export_csr_links(), gb.export_csr_links())))


def _sharded_equal(a, b):
    return (len(a.shards) == len(b.shards)
            and np.array_equal(a.router.bounds, b.router.bounds)
            and a.router.lo_key == b.router.lo_key
            and a.epoch == b.epoch and a._mutations == b._mutations
            and all(_shard_equal(x, y) for x, y in zip(a.shards, b.shards)))


def _same_answers(a, b, q, label=True):
    ra, rb = a.lookup(q), b.lookup(q)
    assert np.array_equal(ra.payloads, rb.payloads)
    assert np.array_equal(ra.slots, rb.slots)
    assert np.array_equal(ra.found, rb.found)
    assert ra.epoch == rb.epoch
    if label:
        assert ra.backend == rb.backend


def _written(wide, n=12_000, shards=3):
    keys = _keys(n, 1, wide)
    ref, port = _pair(keys, shards)
    fresh = _fresh(keys, 1_500)
    for idx in (ref, port):
        idx.ingest(fresh[:1_000], (3 << 40) + np.arange(1_000))
        idx.maybe_rebalance(force_shard=0)
        idx.ingest(fresh[1_000:], np.arange(500))
    assert _sharded_equal(ref, port) and len(port.shards) == shards + 1
    return keys, fresh, ref, port


def _queries(keys, fresh, seed=3):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.choice(keys, 1_500), fresh[::3],
                           fresh[::5] + 1.0, [keys[0] - 2.0,
                                              keys[-1] + 2.0]])


# ---------------------------------------------------------------------------
# sharded snapshots


@pytest.mark.parametrize("wide", [False, True])
def test_sharded_snapshot_files_equal_the_reference(tmp_path, wide):
    _k, _f, ref, port = _written(wide)
    a = ref.save_snapshot(tmp_path / "ref", step=2, wal_lsn=9)
    b = port.save_snapshot(tmp_path / "port", step=2, wal_lsn=9)
    name = "sharded_manifest.json"
    assert (open(os.path.join(a, name), "rb").read()
            == open(os.path.join(b, name), "rb").read())
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for i in range(len(port.shards)):
        sa = os.path.join(a, f"shard_{i:03d}", "step_00000002")
        sb = os.path.join(b, f"shard_{i:03d}", "step_00000002")
        ma = json.load(open(os.path.join(sa, "manifest.json")))
        mb = json.load(open(os.path.join(sb, "manifest.json")))
        assert mb["treedef"] == "" and ma["treedef"]
        del ma["treedef"], mb["treedef"]
        assert ma == mb
        assert sorted(os.listdir(sa)) == sorted(os.listdir(sb))
        for leaf in LEAVES:
            with open(os.path.join(sa, leaf + ".npy"), "rb") as f:
                want = f.read()
            with open(os.path.join(sb, leaf + ".npy"), "rb") as f:
                assert f.read() == want, (i, leaf)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_sharded_snapshots_cross_restore(tmp_path, wide, direction):
    keys, fresh, ref, port = _written(wide)
    if direction == "reference_to_port":
        ref.save_snapshot(tmp_path / "ck", step=5, wal_lsn=77)
        rec, extra = ShardedIndex.restore(tmp_path / "ck", device="cpu")
        assert isinstance(rec, ShardedIndex)
        assert all(sh.device.type == "cpu" for sh in rec.shards)
    else:
        port.save_snapshot(tmp_path / "ck", step=5, wal_lsn=77)
        rec, extra = RefSharded.restore(tmp_path / "ck")
        assert isinstance(rec, RefSharded)
    assert extra["wal_lsn"] == 77 and extra["step"] == 5
    assert extra["epoch"] == port.epoch
    assert _sharded_equal(rec, ref) and _sharded_equal(rec, port)
    q = _queries(keys, fresh)
    _same_answers(rec, ref, q)
    _same_answers(rec, port, q)
    _same_answers(rec, port, q[:300])


def test_sharded_restore_and_recover_default_to_cuda(tmp_path,
                                                     monkeypatch):
    import torch
    _k, _f, _ref, port = _written(False, n=6_000, shards=2)
    port.save_snapshot(tmp_path / "ck")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedIndex.restore(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="CUDA"):
        recover_index(tmp_path / "ck", tmp_path / "w.wal")


def test_sharded_checkpoint_restores_router_and_mutations(tmp_path):
    keys = _keys(9_000, 0, False)
    ref, port = _pair(keys, 3)
    fresh = _fresh(keys, 500)
    for idx, d in ((ref, "r"), (port, "p")):
        idx.ingest(fresh, np.arange(500, dtype=np.int64))
        idx.maybe_rebalance(force_shard=0)
        idx.save_snapshot(tmp_path / d, step=7, wal_lsn=123)
    rec, extra = ShardedIndex.restore(tmp_path / "p", device="cpu")
    want, w_extra = RefSharded.restore(tmp_path / "r")
    assert extra == w_extra
    assert extra["wal_lsn"] == 123 and extra["step"] == 7
    assert rec.epoch == port.epoch == want.epoch
    assert _sharded_equal(rec, want) and _sharded_equal(rec, port)
    q = np.concatenate([keys[::17], fresh[::7]])
    _same_answers(rec, port, q)
    _same_answers(rec, want, q)


# ---------------------------------------------------------------------------
# WAL recovery


def _pipeline_run(pkg, tmp_path, keys, wide):
    """The same checkpointed, logged, torn run through one package's
    stack; returns the index and the WAL's batch ends."""
    idx_cls, pipe_cls, wal_cls = pkg
    kw = dict(method="pgm", eps=64, gap_rho=0.2, shards=2)
    if idx_cls is Index:
        kw["device"] = "cpu"
    idx = idx_cls.build(keys, **kw)
    wal = wal_cls(tmp_path / "w.wal")
    pipe = pipe_cls(idx, wal=wal)
    fresh = _fresh(keys, 48)
    pipe.ingest(fresh[:8], 100 + np.arange(8, dtype=np.int64))
    pipe.checkpoint(tmp_path / "ck", step=0)
    ends = []
    for i in range(1, 5):
        pipe.ingest(fresh[8 * i:8 * (i + 1)],
                    (100 * (i + 1) + np.arange(8)).astype(np.int64))
        ends.append(wal.lsn)
    pipe.publish()
    pipe.close()
    return idx, ends


@pytest.mark.parametrize("wide", [False, True])
def test_recover_sharded_directory_equals_the_reference(tmp_path, wide):
    keys = _keys(3_000, 2, wide)
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    ref, ends_r = _pipeline_run((RefIndex, RefPipeline, RefWAL),
                                tmp_path / "r", keys, wide)
    port, ends_p = _pipeline_run((Index, EpochPipeline, IngestWAL),
                                 tmp_path / "p", keys, wide)
    assert ends_r == ends_p
    assert ((tmp_path / "r" / "w.wal").read_bytes()
            == (tmp_path / "p" / "w.wal").read_bytes())
    assert _sharded_equal(ref, port)
    cut = ends_p[2] + 11            # a torn fourth batch
    for d in ("r", "p"):
        raw = (tmp_path / d / "w.wal").read_bytes()
        (tmp_path / d / "torn.wal").write_bytes(raw[:cut])
    a, ia = ref_recover(tmp_path / "r" / "ck", tmp_path / "r" / "torn.wal")
    b, ib = recover_index(tmp_path / "p" / "ck", tmp_path / "p" / "torn.wal",
                          device="cpu")
    c, ic = recover_index(tmp_path / "r" / "ck", tmp_path / "r" / "torn.wal",
                          device="cpu")
    assert ia == ib == ic
    assert ia["replayed"] == 3 and ia["skipped"] == 1 and ia["torn"]
    assert isinstance(b, ShardedIndex) and isinstance(c, ShardedIndex)
    for x in (b, c):
        assert _sharded_equal(x, a)
        InvariantAuditor().assert_ok(x)
    q = np.concatenate([keys[::11], _fresh(keys, 48)])
    _same_answers(b, a, q)
    _same_answers(c, a, q)


@pytest.mark.parametrize("wide", [False, True])
def test_kill_at_every_byte_boundary_recovers_acked_prefix(tmp_path, wide):
    """Tear the WAL at every byte offset past the checkpoint: a sharded
    recovery reproduces exactly the acked batches (never a partial one,
    never a lost one), as the reference's case does."""
    keys = _keys(3_000, 0, wide)
    _ref, idx = _pair(keys, 2)
    wal_path = tmp_path / "ingest.wal"
    wal = IngestWAL(wal_path)
    pipe = EpochPipeline(idx, wal=wal)
    pipe.checkpoint(tmp_path / "ckpt", step=0)
    base_lsn = wal.lsn
    fresh = _fresh(keys, 24)
    batches = [(fresh[i * 8:(i + 1) * 8],
                (100 * (i + 1) + np.arange(8)).astype(np.int64))
               for i in range(3)]
    ends = []
    for bk, bp in batches:
        pipe.ingest(bk, bp)
        ends.append(wal.lsn)
    wal.sync()
    raw = wal_path.read_bytes()
    refs = []
    for upto in range(4):
        r, _ = ShardedIndex.restore(tmp_path / "ckpt", device="cpu")
        for bk, bp in batches[:upto]:
            r.ingest(bk, bp)
        refs.append(r)
    aud = InvariantAuditor()
    torn_path = tmp_path / "torn.wal"
    for cut in range(base_lsn, len(raw) + 1):
        torn_path.write_bytes(raw[:cut])
        rec, info = recover_index(tmp_path / "ckpt", torn_path,
                                  device="cpu")
        n_acked = sum(e <= cut for e in ends)
        assert info["replayed"] == n_acked, f"cut={cut}"
        assert info["torn"] == (cut not in ([base_lsn] + ends)), cut
        for sa, sb in zip(rec.shards, refs[n_acked].shards):
            assert _shard_equal(sa, sb), f"cut={cut}"
        aud.assert_ok(rec)
    pipe.close()


# ---------------------------------------------------------------------------
# serving


def test_sharded_snapshot_isolation_and_forced_split():
    """A pinned ``ShardedSnapshot`` keeps the router topology: answers
    stay bit-identical across ingest and a forced split, in both
    packages alike."""
    keys = _keys(24_000, 0, False)
    rng = np.random.default_rng(2)
    q = np.concatenate([rng.choice(keys, 2_000),
                        rng.choice(keys, 400) + 1.0])
    b = _fresh(keys, 2_000)
    out = []
    for idx, pipe_cls in zip(_pair(keys, 3), (RefPipeline, EpochPipeline)):
        quiesced = idx.lookup(q)
        pipe = pipe_cls(idx)
        epoch0 = pipe.epoch
        pipe.ingest(b, (70_000 + np.arange(b.size)).astype(np.int64))
        idx.maybe_rebalance(force_shard=1)
        got = pipe.lookup(q)
        assert got.epoch == epoch0 and got.backend == "snapshot"
        assert np.array_equal(got.payloads, quiesced.payloads)
        assert np.array_equal(got.found, quiesced.found)
        hit = np.asarray(quiesced.found)
        assert np.array_equal(np.asarray(got.slots)[hit],
                              np.asarray(quiesced.slots)[hit])
        pipe.publish()
        res = pipe.lookup(b)
        assert res.found.all()
        assert np.array_equal(res.payloads, 70_000 + np.arange(b.size))
        out.append((quiesced, got, res, idx))
        pipe.close()
    (q_r, g_r, r_r, ref), (q_p, g_p, r_p, port) = out
    assert _sharded_equal(ref, port)
    for x, y in ((q_r, q_p), (g_r, g_p), (r_r, r_p)):
        assert x.backend == y.backend and x.epoch == y.epoch
        for f in ("payloads", "slots", "found"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), f


def test_micro_batch_queue_over_sharded_index():
    """One coalesced flush over a sharded index demuxes per-ticket
    results, in both packages alike and equal to a single index."""
    rng = np.random.default_rng(6)
    keys = np.unique(rng.choice(2 ** 22, 24_000, replace=False)
                     ).astype(np.float64)
    single = Index.build(keys, method="pgm", eps=64, gap_rho=0.2,
                         device="cpu")
    batches = [rng.choice(keys, 300), rng.choice(keys, 200) + 1.0,
               rng.choice(keys, 400)]
    new = np.array([keys[-1] + 10.0, keys[-1] + 12.0])
    results = []
    for sharded, q_cls in zip(_pair(keys, 4), (RefQueue, MicroBatchQueue)):
        q = q_cls(sharded, min_bucket=512)
        tickets = [q.submit_lookup(b) for b in batches]
        ti = q.submit_ingest(new, np.array([7, 8]))
        q.flush()
        assert q.stats["lookup_dispatches"] == 1
        got = [q.result(t) for t in tickets]
        rep = q.result(ti)
        assert rep.device == "sharded" and rep.n == 2
        assert sharded.lookup(np.array([keys[-1] + 12.0])).payloads[0] == 8
        results.append((got, rep, dict(q.stats)))
        q.close()
    (g_r, rep_r, st_r), (g_p, rep_p, st_p) = results
    # the reference's queue counters; the port's adds lookup_keys (the
    # keys of the one dispatch) and lookup_wait_ms_sum
    assert {k: st_p[k] for k in st_r} == st_r
    assert st_p["lookup_keys"] == sum(b.size for b in batches)
    assert (rep_r.n, rep_r.slot, rep_r.chain, rep_r.epoch) == (
        rep_p.n, rep_p.slot, rep_p.chain, rep_p.epoch)
    for b, x, y in zip(batches, g_r, g_p):
        want = single.lookup(b)
        assert x.backend == y.backend == "sharded-fanout"
        for f in ("payloads", "slots", "found"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), f
        assert np.array_equal(y.payloads, want.payloads)
        assert np.array_equal(y.found, want.found)


def test_sharded_retrain_all_shards_preserves_answers():
    x = make_keys("iot", 24_000, seed=5)
    ref, port = _pair(x, 3, seed=5, gap_rho=0.15)
    q = np.random.default_rng(6).choice(x, 4000)
    recs = []
    for idx in (ref, port):
        before = idx.lookup(q)
        e0 = idx.epoch
        rec = idx.retrain(sample_rate=0.1, rng=np.random.default_rng(7))
        assert rec["kind"] == "retrain" and len(rec["per_shard"]) == 3
        assert idx.epoch > e0 and idx.stats["retrains"] == 1
        after = idx.lookup(q)
        assert np.array_equal(before.payloads, after.payloads)
        assert np.array_equal(before.found, after.found)
        recs.append(rec)
    assert _sharded_equal(ref, port)
    for (s_r, r_r), (s_p, r_p) in zip(recs[0]["per_shard"],
                                      recs[1]["per_shard"]):
        assert s_r == s_p
        for k in ("n", "epoch", "chains_before", "chains_after"):
            assert r_r[k] == r_p[k], k
    _same_answers(ref, port, q)


def test_sharded_watermark_retrains_unsplittable_shard():
    x = make_keys("iot", 6_000, seed=8)
    step = float(np.mean(np.diff(x)))
    tail = x[-1] + step * (1.0 + np.arange(300))
    recs = []
    for idx in _pair(x, 2, seed=8, gap_rho=0.15):
        idx.min_split_keys = 10 ** 9
        idx.split_chain_depth = 4
        idx.ingest(tail, 2_000_000 + np.arange(300))
        assert any(sh.gapped.links.max_chain > 4 for sh in idx.shards)
        rec = idx.maybe_rebalance()
        assert rec is not None and rec["kind"] == "retrain"
        assert idx.stats["splits"] == 0
        r = idx.lookup(tail)
        assert np.asarray(r.found).all()
        assert np.array_equal(np.asarray(r.payloads),
                              2_000_000 + np.arange(300))
        recs.append((rec, idx))
    (rec_r, ref), (rec_p, port) = recs
    assert rec_r["shards"] == rec_p["shards"]
    assert _sharded_equal(ref, port)
    _same_answers(ref, port, np.concatenate([tail, x[::7]]))


def test_sharded_auto_per_shard():
    x = make_keys("iot", 30_000, seed=8)
    kw = dict(method="auto", gap_rho=0.15)
    ref = RefIndex.build(x, shards=3, rng=np.random.default_rng(8), **kw)
    port = Index.build(x, shards=3, rng=np.random.default_rng(8),
                       device="cpu", **kw)
    for a, b in zip(ref.shards, port.shards):
        assert b.tuned is not None and b.method in ("pgm", "fiting")
        assert (a.method, a.mech_kwargs, a.sample_rate) == (
            b.method, b.mech_kwargs, b.sample_rate)
        assert a.tuned.score == b.tuned.score
    assert _sharded_equal(ref, port)
    q = np.random.default_rng(9).choice(x, 3000)
    r = port.lookup(q)
    assert np.array_equal(r.payloads, np.searchsorted(x, q))
    _same_answers(ref, port, q)
