"""Durability in the port against the reference: snapshots (the port
saves and restores; each package restores the other's; the files on
disk are the reference's byte for byte, the manifest's ``treedef``
aside), ``keep``-N garbage collection, and the ingest WAL (the same
appends and fences give the same bytes, each package replays the
other's log, and the port's log keeps the crash-recovery properties of
tests/test_wal_recovery.py on the single-device paths at both key
widths).  Inputs are made with numpy from a seed and handed to both
packages; every comparison is exact."""

import json
import os

import numpy as np
import pytest

from repro.core import Index as RefIndex
from repro.serving import EpochPipeline as RefPipeline
from repro.serving import IngestWAL as RefWAL
from repro.serving import recover_index as ref_recover
from repro.serving import replay as ref_replay
from repro_torch.core import Index
from repro_torch.robustness import InvariantAuditor
from repro_torch.serving import EpochPipeline, IngestWAL, recover_index, replay
from repro_torch.train import CheckpointManager

LEAVES = ("chain_keys", "chain_payloads", "keys", "mech_pickle",
          "occupied", "offsets", "payload", "slot_key")
WIDTHS = [False, True]   # keys below 2^24, keys below 2^40


def _keys(seed, wide, n):
    """Sorted unique integer keys on the even grid (every midpoint of
    two keys is a fresh key)."""
    rng = np.random.default_rng(seed)
    hi = 2 ** 39 if wide else 2 ** 23
    keys = np.unique(rng.choice(hi, n, replace=False)).astype(np.float64)
    return keys * 2.0


def _fresh(keys, n, skip=0):
    mids = np.setdiff1d(keys[:-1] + np.rint(np.diff(keys) * 0.5), keys)
    assert mids.size >= skip + n
    return mids[skip:skip + n]


def _both(wide, n=25_000, seed=0, **kw):
    """The same build in both packages (the port on the CPU)."""
    keys = _keys(seed, wide, n)
    kw = dict(dict(method="pgm", eps=64, gap_rho=0.15, sample_rate=0.05),
              **kw)
    ref = RefIndex.build(keys, rng=np.random.default_rng(seed + 1), **kw)
    port = Index.build(keys, rng=np.random.default_rng(seed + 1),
                       device="cpu", **kw)
    return keys, ref, port


def _written(wide, **kw):
    """``_both`` after the same two ingest batches (chains included)."""
    keys, ref, port = _both(wide, **kw)
    fresh = _fresh(keys, 3_000)
    for idx in (ref, port):
        idx.ingest(fresh[:2_000], 1_000_000 + np.arange(2_000))
        idx.ingest(fresh[2_000:], (3 << 40) + np.arange(1_000))
    return keys, fresh, ref, port


def _state_equal(a, b):
    ga, gb = a.gapped, b.gapped
    return (np.array_equal(ga.slot_key, gb.slot_key)
            and np.array_equal(ga.occupied, gb.occupied)
            and np.array_equal(ga.payload, gb.payload)
            and ga.n_keys == gb.n_keys and ga.rho == gb.rho
            and np.array_equal(a.keys, b.keys)
            and a.epoch == b.epoch
            and all(np.array_equal(x, y) for x, y in
                    zip(ga.export_csr_links(), gb.export_csr_links())))


def _queries(keys, fresh, seed=3):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.choice(keys, 1_500), fresh[::3],
                           fresh[::5] + 1.0, [keys[0] - 2.0,
                                              keys[-1] + 2.0]])


def _same_answers(a, b, q):
    """Payloads, slots and found equal.  The stage that served may
    differ: the reference's CPU ``fused`` stage is its XLA graph, whose
    escapes differ from the kernel's (ROADMAP.md queue C)."""
    ra, rb = a.lookup(q), b.lookup(q)
    assert np.array_equal(ra.payloads, rb.payloads)
    assert np.array_equal(ra.slots, rb.slots)
    assert np.array_equal(ra.found, rb.found)


def _same_mech(a, b, keys):
    assert np.array_equal(a.mech.predict(keys), b.mech.predict(keys))
    pa, pb = a.mech.plm, b.mech.plm
    for f in ("seg_first_key", "slope", "icept", "err_lo", "err_hi"):
        assert np.array_equal(getattr(pa, f), getattr(pb, f)), f


# ---------------------------------------------------------------------------
# snapshots


@pytest.mark.parametrize("wide", WIDTHS)
def test_port_save_restore_is_bit_identical(tmp_path, wide):
    keys, fresh, _ref, port = _written(wide)
    port.lookup(keys[:1_024])           # a frozen device cache exists
    out = port.save_snapshot(tmp_path / "ck", step=4, wal_lsn=77,
                             extra={"note": "x"})
    assert out == str(tmp_path / "ck" / "step_00000004")
    rec, extra = Index.restore(tmp_path / "ck", device="cpu")
    assert extra["wal_lsn"] == 77 and extra["note"] == "x"
    assert extra["step"] == 4 and extra["epoch"] == port.epoch
    assert _state_equal(rec, port)
    assert (rec.method, rec.sample_rate, rec.gap_rho) == (
        port.method, port.sample_rate, port.gap_rho)
    assert type(rec.mech).__module__ == "repro_torch.core.mechanisms"
    assert rec.device.type == "cpu" and rec.device_epoch == -1
    _same_mech(rec, port, np.concatenate([keys, fresh]))
    _same_answers(rec, port, _queries(keys, fresh))


@pytest.mark.parametrize("wide", WIDTHS)
@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_snapshots_cross_restore(tmp_path, wide, direction):
    keys, fresh, ref, port = _written(wide)
    if direction == "reference_to_port":
        ref.save_snapshot(tmp_path / "ck", wal_lsn=5)
        rec, extra = Index.restore(tmp_path / "ck", device="cpu")
        live, module = ref, "repro_torch.core.mechanisms"
    else:
        port.save_snapshot(tmp_path / "ck", wal_lsn=5)
        rec, extra = RefIndex.restore(tmp_path / "ck")
        live, module = port, "repro.core.mechanisms"
    assert type(rec.mech).__module__ == module
    assert extra["wal_lsn"] == 5 and extra["step"] == live.epoch
    assert _state_equal(rec, live)
    _same_mech(rec, live, np.concatenate([keys, fresh]))
    q = _queries(keys, fresh)
    _same_answers(rec, live, q)
    _same_answers(rec, port if live is ref else ref, q)


@pytest.mark.parametrize("wide", WIDTHS)
def test_snapshot_files_equal_the_reference(tmp_path, wide):
    """Every leaf file is the reference's byte for byte (the mechanism
    pickle included) and the manifest equals it except ``treedef``."""
    _keys_, _fresh_, ref, port = _written(wide)
    a = ref.save_snapshot(tmp_path / "ref", step=2, wal_lsn=9)
    b = port.save_snapshot(tmp_path / "port", step=2, wal_lsn=9)
    ma = json.load(open(os.path.join(a, "manifest.json")))
    mb = json.load(open(os.path.join(b, "manifest.json")))
    assert tuple(ma["leaves"]) == LEAVES
    assert mb["treedef"] == "" and ma["treedef"]
    del ma["treedef"], mb["treedef"]
    assert ma == mb
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in LEAVES:
        with open(os.path.join(a, name + ".npy"), "rb") as f:
            want = f.read()
        with open(os.path.join(b, name + ".npy"), "rb") as f:
            assert f.read() == want, name


def test_static_snapshot_cross_restores(tmp_path):
    keys = _keys(5, True, 8_000)
    ref = RefIndex.build(keys, method="fiting", eps=32)
    port = Index.build(keys, method="fiting", eps=32, device="cpu")
    port.save_snapshot(tmp_path / "p")
    ref.save_snapshot(tmp_path / "r")
    a, _ = RefIndex.restore(tmp_path / "p")
    b, _ = Index.restore(tmp_path / "r", device="cpu")
    assert a.gapped is None and b.gapped is None
    q = np.concatenate([keys[::5], keys[::7] + 1.0])
    for x, y in ((a, port), (b, ref), (b, port)):
        assert np.array_equal(x.predict(q), y.predict(q))
        rx, ry = x.lookup(q), y.lookup(q)
        assert np.array_equal(rx.payloads, ry.payloads)
        assert np.array_equal(rx.found, ry.found)


def test_keep_gc_and_leftover_tmp_directory(tmp_path):
    keys, ref, port = _both(False, n=6_000)
    fresh = _fresh(keys, 400)
    for s in range(4):
        port.ingest(fresh[s * 100:(s + 1) * 100], np.arange(100) + 100 * s)
        port.save_snapshot(tmp_path / "ck", step=s, keep=2)
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000002",
                                                   "step_00000003"]
    # a save cut off before its publish leaves step_<k>.tmp behind
    os.makedirs(tmp_path / "ck" / "step_00000009.tmp")
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 3
    rec, extra = Index.restore(tmp_path / "ck", device="cpu")
    assert extra["step"] == 3 and _state_equal(rec, port)
    older, _ = RefIndex.restore(tmp_path / "ck", step=2)
    assert older.epoch == port.epoch - 1
    with pytest.raises(FileNotFoundError):
        Index.restore(tmp_path / "empty", device="cpu")


def test_restore_refuses_other_reference_modules(tmp_path):
    """A snapshot's mechanism pickle may name the reference's
    ``mechanisms`` module and no other module of the reference."""
    import pickle

    keys, _ref, port = _both(False, n=4_000)
    d = port.save_snapshot(tmp_path / "ck")
    bad = pickle.dumps(RefIndex.build(keys, gap_rho=0.1).gapped.links)
    np.save(os.path.join(d, "mech_pickle.npy"),
            np.frombuffer(bad, np.uint8))
    with pytest.raises(pickle.UnpicklingError, match="repro.core.links"):
        Index.restore(tmp_path / "ck", device="cpu")


# ---------------------------------------------------------------------------
# WAL framing


def _wal_ops(seed=5):
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(6):
        k = np.sort(rng.choice(2 ** 40, 16 + i, replace=False)
                    ).astype(np.float64)
        ops.append(("batch", k, (7 << 40) + np.arange(k.size) + 100 * i))
        if i % 2:
            ops.append(("fence", 3 * i, None))
    return ops


def _write(wal_cls, path, ops, sync_every):
    with wal_cls(path, sync_every=sync_every) as w:
        lsns = [w.append(a, b) if kind == "batch" else w.fence(a)
                for kind, a, b in ops]
    return lsns


@pytest.mark.parametrize("sync_every", [1, 3, "adaptive"])
def test_wal_bytes_equal_the_reference(tmp_path, sync_every):
    ops = _wal_ops()
    la = _write(RefWAL, tmp_path / "ref.wal", ops, sync_every)
    lb = _write(IngestWAL, tmp_path / "port.wal", ops, sync_every)
    assert la == lb
    assert ((tmp_path / "ref.wal").read_bytes()
            == (tmp_path / "port.wal").read_bytes())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_replays_the_others_log(tmp_path, writer):
    ops = _wal_ops(seed=6)
    p = tmp_path / "w.wal"
    _write(RefWAL if writer == "reference" else IngestWAL, p, ops, 2)
    raw = p.read_bytes()
    p.write_bytes(raw[:-7])             # and a torn tail
    ra, ea, ta = ref_replay(p)
    rb, eb, tb = replay(p)
    assert (ea, ta) == (eb, tb) and ta
    assert len(ra) == len(rb) == len(ops) - 1
    for x, y, (kind, a, b) in zip(ra, rb, ops):
        assert x.kind == y.kind == kind and x.lsn == y.lsn
        assert x.epoch == y.epoch
        if kind == "batch":
            assert np.array_equal(x.keys, y.keys)
            assert np.array_equal(y.keys, a)
            assert np.array_equal(x.payloads, y.payloads)
            assert np.array_equal(y.payloads, b)


def test_wal_flipped_bit_is_caught_by_crc(tmp_path):
    p = tmp_path / "a.wal"
    with IngestWAL(p) as w:
        w.append(np.array([1.0, 2.0]), np.array([1, 2]))
        end1 = w.append(np.array([3.0]), np.array([3]))
    raw = bytearray(p.read_bytes())
    raw[end1 - 10] ^= 0x40              # one bit of record 2's body
    p.write_bytes(bytes(raw))
    recs, valid_end, torn = replay(p)
    assert torn and len(recs) == 1 and valid_end < end1
    assert ref_replay(p)[1:] == (valid_end, torn)


# ---------------------------------------------------------------------------
# snapshot + WAL recovery on the single-device paths


def _small(wide, n=3_000, seed=0):
    keys = _keys(seed, wide, n)
    return Index.build(keys, method="pgm", eps=64, gap_rho=0.2,
                       device="cpu"), keys


@pytest.mark.parametrize("wide", WIDTHS)
def test_kill_at_every_byte_boundary_recovers_acked_prefix(tmp_path, wide):
    """Tear the port's WAL at every byte past the checkpoint: recovery
    reproduces exactly the acked batches, never a partial one."""
    idx, keys = _small(wide)
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
        r, _ = Index.restore(tmp_path / "ckpt", device="cpu")
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
        assert info["torn"] == (cut not in [base_lsn] + ends), f"cut={cut}"
        assert _state_equal(rec, refs[n_acked]), f"cut={cut}"
        aud.assert_ok(rec)
    assert _state_equal(refs[3], idx)
    pipe.close()


@pytest.mark.parametrize("wide", WIDTHS)
def test_checkpoint_mid_log_skips_folded_records(tmp_path, wide):
    """Records at or below the checkpoint's ``wal_lsn`` are skipped, so
    a second replay of the same log applies nothing twice."""
    idx, keys = _small(wide)
    wal = IngestWAL(tmp_path / "w.wal")
    pipe = EpochPipeline(idx, wal=wal)
    fresh = _fresh(keys, 30)
    pipe.ingest(fresh[:10], np.arange(10, dtype=np.int64))
    pipe.ingest(fresh[10:20], 10 + np.arange(10, dtype=np.int64))
    pipe.checkpoint(tmp_path / "ckpt", step=0)
    pipe.ingest(fresh[20:], 20 + np.arange(10, dtype=np.int64))
    wal.sync()
    for _ in range(2):
        rec, info = recover_index(tmp_path / "ckpt", tmp_path / "w.wal",
                                  device="cpu")
        assert info["skipped"] == 2 and info["replayed"] == 1
        assert info["restored_step"] == 0 and not info["torn"]
        assert _state_equal(rec, idx)
    pipe.close()


@pytest.mark.parametrize("wide", WIDTHS)
def test_recover_index_equals_the_reference(tmp_path, wide):
    """The same pipeline run in both packages (each with its own log
    and snapshots): each recovery, and the port's recovery of the
    reference's files, equal array for array."""
    keys, ref, port = _both(wide, n=6_000, sample_rate=1.0)
    fresh = _fresh(keys, 900)
    runs = {}
    for name, idx, pipe_cls, wal_cls in (
            ("ref", ref, RefPipeline, RefWAL),
            ("port", port, EpochPipeline, IngestWAL)):
        d = tmp_path / name
        d.mkdir()
        wal = wal_cls(d / "w.wal")
        pipe = pipe_cls(idx, wal=wal)
        for i in range(3):
            pipe.ingest(fresh[i * 300:(i + 1) * 300 - 150],
                        np.arange(150) + 1_000 * i)
            if i == 1:
                pipe.checkpoint(d / "ck", step=i)
            pipe.ingest(fresh[(i + 1) * 300 - 150:(i + 1) * 300],
                        np.arange(150) + 1_000 * i + 500)
            pipe.publish()
        pipe.close()
        runs[name] = d
    a, ia = ref_recover(runs["ref"] / "ck", runs["ref"] / "w.wal")
    b, ib = recover_index(runs["port"] / "ck", runs["port"] / "w.wal",
                          device="cpu")
    c, ic = recover_index(runs["ref"] / "ck", runs["ref"] / "w.wal",
                          device="cpu")
    assert ia == ib == ic
    assert ia["replayed"] == 3 and ia["skipped"] == 3
    assert (runs["ref"] / "w.wal").read_bytes() == (
        runs["port"] / "w.wal").read_bytes()
    for x in (b, c):
        assert _state_equal(x, a) and _state_equal(x, port)
    _same_answers(b, a, _queries(keys, fresh))


def test_sharded_snapshot_directory_raises_not_ported(tmp_path):
    """Sharding is ported: a directory with ``sharded_manifest.json``
    recovers as a ``ShardedIndex`` (replaying the WAL tail), equal to
    the reference's recovery of the same directory."""
    from repro_torch.dist import ShardedIndex
    keys = _keys(4, False, 6_000)
    kw = dict(method="pgm", eps=64, gap_rho=0.2, shards=2)
    ref = RefIndex.build(keys, **kw)
    ref.save_snapshot(tmp_path / "ck", wal_lsn=0)
    fresh = _fresh(keys, 16)
    with RefWAL(tmp_path / "w.wal") as w:
        w.append(fresh, np.arange(16))
    rec, info = recover_index(tmp_path / "ck", tmp_path / "w.wal",
                              device="cpu")
    want, want_info = ref_recover(tmp_path / "ck", tmp_path / "w.wal")
    assert isinstance(rec, ShardedIndex) and info == want_info
    assert info["replayed"] == 1
    assert rec.epoch == want.epoch
    for a, b in zip(rec.shards, want.shards):
        assert _state_equal(a, b)
    _same_answers(rec, want, np.concatenate([keys[::5], fresh]))
