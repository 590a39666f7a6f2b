"""Exact 64-bit integer keys (``core.keys64``) against the plain
reference ``repro_torch.plain_kv``: the key sets that float64 gets
wrong (adjacent keys at 2^53 + 1, 2^62 and at or above 2^63), the
2^24 / 2^48 / 2^53 boundaries, queries out of range, answers through
``Index.lookup``, the serving queue over an ``EpochPipeline`` and a
checkpoint recovered with its WAL; a key set below 2^48 freezing to the
f32-pair images array for array; integer keys below 2^53 staying on the
writable float64 path; every write and sharding entry point refusing
keys that need the 64-bit image.  The ``gpu`` cases hold the
64-bit kernel against its plain version on the card, bit for bit."""

import numpy as np
import pytest
import torch

from repro_torch import plain_kv
from repro_torch.core import Index
from repro_torch.core import keys64 as k64
from repro_torch.kernels import freeze, ops
from repro_torch.kernels.lookup import (fused_lookup_u64,
                                        fused_lookup_u64_plain)
from repro_torch.serving import EpochPipeline, IngestWAL, MicroBatchQueue
from repro_torch.serving.wal import recover_index, replay

U = np.uint64
# adjacent keys that float64 merges (k and k + 1 past 2^53), with an
# absent key between each pair and the next
ADJACENT = {"2^53+1": 2 ** 53 + 1, "2^62": 2 ** 62, "2^63": 2 ** 63,
            "2^64-4": 2 ** 64 - 4}


def _keys(seed, n, lo, hi, extra=()):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, hi - lo, n, dtype=np.uint64) + U(lo)
    return np.unique(np.concatenate([k, np.asarray(extra, np.uint64)]))


def _build(keys, seed=1, device="cpu"):
    pay = np.random.default_rng(seed).integers(0, 2 ** 30, keys.size)
    idx = Index.build(keys, method="pgm", eps=64, gap_rho=0.15,
                      sample_rate=0.1, payloads=pay,
                      rng=np.random.default_rng(seed), device=device)
    return idx, pay


def _queries(keys, seed, extra=()):
    """Present keys, their neighbours (mostly absent) and ``extra``."""
    rng = np.random.default_rng(seed)
    pres = keys[rng.integers(0, keys.size, 3000)]
    near = np.concatenate([keys[:50] - U(1), keys[-50:] + U(1),
                           keys[rng.integers(0, keys.size, 500)] + U(1)])
    return np.concatenate([pres, near, np.asarray(extra, np.uint64)])


def _assert_exact(res, ref, q):
    want_pay, want_found = ref.answer(q)
    assert np.array_equal(res.found, want_found)
    assert np.array_equal(res.payloads, want_pay)


@pytest.fixture(scope="module")
def adjacent():
    extra = [v + d for v in ADJACENT.values() for d in (0, 1)]
    keys = _keys(63, 30_000, 2 ** 52, 2 ** 64 - 8, extra)
    idx, pay = _build(keys)
    idx.sync_device()
    return idx, keys, pay, extra


@pytest.mark.parametrize("name", sorted(ADJACENT))
@pytest.mark.parametrize("backend", [None, "fused", "numpy-oracle"])
def test_adjacent_keys_float64_merges_answer_exactly(adjacent, name,
                                                     backend):
    idx, keys, pay, _ = adjacent
    v = ADJACENT[name]
    pair = np.array([v, v + 1], np.uint64)
    # float64 merges a key of the pair with a neighbour, present or
    # absent (2^53 + 1 rounds onto the absent 2^53): the parent's
    # coercion answered them alike
    around = np.array([v - 1, v, v + 1, v + 2], np.uint64)
    assert np.unique(around.astype(np.float64)).size < 4
    q = np.concatenate([pair, pair + U(1), pair - U(1),
                        _queries(keys, 5)])
    res = idx.lookup(q, backend=backend)
    assert res.found[:3].all() and not res.found[3]   # v + 2: absent
    _assert_exact(res, plain_kv.PlainKV(keys, pay), q)
    assert idx._engine.arrays.key_u64
    assert type(idx.gapped).__name__ == "GappedArray64"


@pytest.mark.parametrize("where", ["below", "above", "both ends"])
def test_queries_out_of_range(adjacent, where):
    idx, keys, pay, _ = adjacent
    below = np.arange(0, 600, dtype=np.uint64)
    above = np.arange(2 ** 64 - 600, 2 ** 64 - 1, dtype=np.uint64)
    q = {"below": below, "above": above,
         "both ends": np.concatenate([below, keys[:10], above])}[where]
    res = idx.lookup(q)
    assert res.backend in ("fused", "device-oracle")
    _assert_exact(res, plain_kv.PlainKV(keys, pay), q)


@pytest.mark.parametrize("kind", ["int64", "float", "negative"])
def test_query_dtypes(adjacent, kind):
    """int64 queries are exact; integral floats below 2^53 are exact,
    fractional and negative queries are absent; float queries at or
    above 2^53 raise."""
    idx, keys, pay, _ = adjacent
    small = keys[keys < U(2 ** 53)]
    assert small.size >= 2
    if kind == "int64":
        q = keys[keys < U(2 ** 63)][:600].astype(np.int64)
        want = plain_kv.PlainKV(keys, pay).answer(q.astype(np.uint64))
    elif kind == "float":   # fractions below 2^52, where floats hold them
        frac = np.arange(600) * 1e9 + 0.5
        q = np.concatenate([small.astype(np.float64), frac])
        want = plain_kv.PlainKV(keys, pay).answer(
            np.concatenate([small, np.zeros(frac.size, np.uint64)]))
        want[0][small.size:], want[1][small.size:] = -1, False
    else:
        q = np.concatenate([-small.astype(np.int64) - 1,
                            small.astype(np.int64)])
        want = plain_kv.PlainKV(keys, pay).answer(
            np.concatenate([small, small]))
        want[0][:small.size], want[1][:small.size] = -1, False
    for backend in (None, "numpy-oracle"):
        res = idx.lookup(q, backend=backend)
        assert np.array_equal(res.payloads, want[0])
        assert np.array_equal(res.found, want[1])
    with pytest.raises(ValueError, match="2\\^53"):
        idx.lookup(np.array([2.0 ** 60] * 600))


@pytest.mark.parametrize("bound,image", [
    (2 ** 24, "pair"), (2 ** 48, "pair"), (2 ** 53, "u64")])
@pytest.mark.parametrize("side", ["below", "straddle"])
def test_boundaries(bound, image, side):
    """Integer keys just below a boundary and straddling it (``image``:
    the straddling set's): below 2^24 the plain f32 image, below 2^53
    float64 and the f32 pair (exact on the device below 2^48), from 2^53
    the 64-bit image; every answer exact."""
    lo = bound - 40_000 if side == "below" else bound - 20_000
    hi = bound if side == "below" else bound + 20_000
    keys = _keys(bound % 97, 8_000, lo, hi, [hi - 1, lo])
    idx, pay = _build(keys)
    a = idx.sync_device().arrays
    if side == "below":
        want = "f32" if bound == 2 ** 24 else "pair"
    else:
        want = image
    got = "u64" if a.key_u64 else ("pair" if a.key_wide else "f32")
    assert got == want
    assert idx.keys.dtype == (np.uint64 if got == "u64" else np.float64)
    q = _queries(keys, 7, [lo - 1, hi, hi + 1])
    _assert_exact(idx.lookup(q), plain_kv.PlainKV(keys, pay), q)


def test_pair_image_below_2_48_unchanged():
    """Integer keys below 2^48 freeze to the f32-pair images of the same
    keys given as float64, array for array."""
    keys = _keys(48, 20_000, 2 ** 40, 2 ** 48 - 1)
    a_int, _ = _build(keys.astype(np.int64))
    a_flt, _ = _build(keys.astype(np.float64))
    assert a_int.keys.dtype == np.float64
    na, sa = freeze.freeze_numpy_headroom(a_int)
    nb, sb = freeze.freeze_numpy_headroom(a_flt)
    assert sa == sb and sa["key_wide"] and "key_u64" not in sa
    assert set(na) == set(nb)
    for f in na:
        assert na[f].dtype == nb[f].dtype and np.array_equal(na[f], nb[f]), f


@pytest.mark.parametrize("entry", ["Index.ingest", "EpochPipeline.ingest",
                                   "IngestWAL.append"])
def test_integer_keys_below_2_53_stay_writable(entry, tmp_path):
    """Integer keys in [2^48, 2^53), which float64 holds exactly, keep
    the float64 image and its write path: a write of such keys through
    ``entry`` is applied (and logged).  After it every present key
    answers its payload on the default backend, and every answer is
    exact on ``numpy-oracle`` (on the device the f32 pair lets an absent
    neighbour alias a key beyond 2^48, as in the reference)."""
    keys = _keys(52, 6_000, 2 ** 48, 2 ** 53 - 2, [2 ** 53 - 1])
    idx, pay = _build(keys.astype(np.int64))
    assert idx.keys.dtype == np.float64
    rng = np.random.default_rng(8)
    new = np.setdiff1d(rng.integers(2 ** 48, 2 ** 53 - 1, 500,
                                    dtype=np.int64), keys.astype(np.int64))
    new_pay = rng.integers(0, 2 ** 30, new.size)
    wal = IngestWAL(tmp_path / "w.wal")
    if entry == "Index.ingest":
        idx.ingest(new, new_pay)
    elif entry == "EpochPipeline.ingest":
        EpochPipeline(idx, wal=wal, publish_every=1).ingest(new, new_pay)
    else:
        wal.append(new, new_pay)
        wal.close()
        records, _end, torn = replay(tmp_path / "w.wal")
        assert not torn and [r.kind for r in records] == ["batch"]
        assert np.array_equal(records[0].keys, new.astype(np.float64))
        return
    all_keys = np.concatenate([keys, new.astype(np.uint64)])
    all_pay = np.concatenate([pay, new_pay])
    ref = plain_kv.PlainKV(all_keys, all_pay)
    q = _queries(np.sort(all_keys), 9)
    _assert_exact(idx.lookup(q.astype(np.int64), backend="numpy-oracle"),
                  ref, q)
    present = np.concatenate([new, keys[:3000].astype(np.int64)])
    _assert_exact(idx.lookup(present), ref, present.astype(np.uint64))


def test_queue_pipeline_and_recovery_answer_exactly(adjacent, tmp_path):
    """The same queries through ``MicroBatchQueue`` over an
    ``EpochPipeline`` with a WAL (coalesced across callers), its pinned
    snapshot, and an index recovered from its checkpoint and WAL."""
    idx, keys, pay, extra = adjacent
    ref = plain_kv.PlainKV(keys, pay)
    wal = IngestWAL(tmp_path / "w.wal", sync_every="adaptive")
    pipe = EpochPipeline(idx, wal=wal, publish_every=1)
    queue = MicroBatchQueue(pipe, max_wait_ms=2, max_depth=64)
    qs = [_queries(keys, 20 + i, extra)[:1500] for i in range(6)]
    tickets = [queue.submit_lookup(q) for q in qs]
    for q, t in zip(qs, tickets):
        _assert_exact(queue.result(t), ref, q)
    assert queue.stats["coalesced_lookups"] == 6
    assert queue.stats["lookup_keys"] == sum(q.size for q in qs)
    q = np.concatenate(qs)
    snap = pipe._snapshot.lookup(q)
    assert snap.backend == "snapshot"
    _assert_exact(snap, ref, q)
    pipe.checkpoint(tmp_path / "ck", step=0)
    queue.close()
    pipe.close()
    rec, _meta = recover_index(tmp_path / "ck", tmp_path / "w.wal",
                               device="cpu")
    assert rec.keys.dtype == np.uint64
    assert np.array_equal(rec.gapped.slot_key, idx.gapped.slot_key)
    for backend in (None, "numpy-oracle"):
        _assert_exact(rec.lookup(q, backend=backend), ref, q)


def _refusals(idx64, idx48, wide, tmp_path):
    from repro_torch.dist.sharded import ShardedIndex
    from repro_torch.serving.kv_cache import PagedKVCache
    k = wide[:4]
    p = np.arange(4)
    kv = PagedKVCache.create(n_pages=64, expected_requests=8, device="cpu")
    wal = IngestWAL(tmp_path / "r.wal")
    pipe = EpochPipeline(idx64)
    return {
        "Index.ingest": lambda: idx48.ingest(k, p),
        "Index.ingest (64-bit index)": lambda: idx64.ingest(k, p),
        "Index.insert": lambda: idx48.insert(int(k[0]), 1),
        "Index.insert_batch": lambda: idx48.insert_batch(k, p),
        "Index.remove": lambda: idx48.remove(k),
        "Index.delete": lambda: idx64.delete(int(k[0])),
        "Index.update_batch": lambda: idx64.update_batch(k, p),
        "Index.build(shards=2)": lambda: Index.build(
            wide, shards=2, gap_rho=0.15, device="cpu"),
        "ShardedIndex.build": lambda: ShardedIndex.build(
            wide, shards=2, gap_rho=0.15, device="cpu"),
        "PagedKVCache.alloc_batch": lambda: kv.alloc_batch(
            np.array([2 ** 33]), np.array([0])),
        "PagedKVCache.alloc": lambda: kv.alloc(2 ** 33, 0),
        "IngestWAL.append": lambda: wal.append(k, p),
        "EpochPipeline.ingest": lambda: pipe.ingest(k, p),
        "MicroBatchQueue.submit_ingest": lambda: MicroBatchQueue(
            pipe).submit_ingest(k, p),
        "Index.build(float keys >= 2^53)": lambda: Index.build(
            np.array([1.0, 2.0 ** 53, 2.0 ** 60]), gap_rho=0.15,
            device="cpu"),
    }


REFUSED = ("Index.ingest", "Index.ingest (64-bit index)", "Index.insert",
           "Index.insert_batch", "Index.remove", "Index.delete",
           "Index.update_batch", "Index.build(shards=2)",
           "ShardedIndex.build", "PagedKVCache.alloc_batch",
           "PagedKVCache.alloc", "IngestWAL.append", "EpochPipeline.ingest",
           "MicroBatchQueue.submit_ingest",
           "Index.build(float keys >= 2^53)")


@pytest.mark.parametrize("entry", REFUSED)
def test_write_and_sharding_entry_points_refuse(adjacent, entry, tmp_path):
    """Every write or sharding entry point that meets keys needing the
    64-bit image raises ``ValueError`` naming the limit (never rounds);
    floats at or above 2^53 are refused at ``Index.build``.  Nothing is
    applied: the WAL stays empty, the index's epoch stays."""
    idx64 = adjacent[0]
    idx48, _ = _build(_keys(3, 5_000, 2 ** 40, 2 ** 47))
    wide = _keys(4, 64, 2 ** 50, 2 ** 63)
    epochs = (idx64.epoch, idx48.epoch)
    call = _refusals(idx64, idx48, wide, tmp_path)[entry]
    with pytest.raises(ValueError, match="2\\^53"):
        call()
    assert (idx64.epoch, idx48.epoch) == epochs
    assert not (tmp_path / "r.wal").exists() or (
        (tmp_path / "r.wal").stat().st_size == 0)


# ---------------------------------------------------------------------------
# the 64-bit kernel on the card


GPU_CASES = [(q_tile, flat_w, wide) for q_tile in (32, 256, 512)
             for flat_w in (0, 32, 256) for wide in (False, True)]


_CARD = {}


def _card_index(wide):
    """One 200k-key index on the card per payload width."""
    if wide not in _CARD:
        extra = [v + d for v in ADJACENT.values() for d in (0, 1)]
        keys = _keys(64, 200_000, 2 ** 52, 2 ** 64 - 8, extra)
        pay = np.random.default_rng(2).integers(
            0, 2 ** 40 if wide else 2 ** 30, keys.size)
        idx = Index.build(keys, method="pgm", eps=64, gap_rho=0.15,
                          sample_rate=0.01, payloads=pay,
                          rng=np.random.default_rng(1), device="cuda")
        idx.sync_device()
        _CARD[wide] = (idx, keys, pay, extra)
    return _CARD[wide]


@pytest.mark.gpu
@pytest.mark.parametrize("q_tile,flat_w,wide", GPU_CASES)
def test_u64_kernel_matches_plain_on_the_card(q_tile, flat_w, wide):
    """``fused_lookup64_kernel`` against ``fused_lookup_u64_plain`` on
    identical CUDA inputs (present, absent and out-of-range queries,
    ``NO_KEY`` padding): all seven outputs bit for bit, and the engine's
    answers equal to the plain reference's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx, keys, pay, extra = _card_index(wide)
    eng = idx._engine
    a = eng.arrays
    assert a.key_u64 and a.wide == wide
    q = _queries(keys, 9, extra + [0, 2 ** 64 - 2])
    qo = np.sort(k64.query_ordered(q)[0])
    n_pad = 8192
    qp = np.full(n_pad, k64.NO_KEY, np.int64)
    qp[:qo.size] = qo
    args = ops.fused_args_u64(torch.from_numpy(qp).cuda(), a, eng._elo,
                              eng._radix_table, eng._radix_key,
                              eng._radix_scale, q_tile=q_tile,
                              w_tile=eng.w_tile)
    statics = dict(q_tile=q_tile, w_tile=eng.w_tile, flat_w=flat_w,
                   max_chain=a.max_chain, n_slots=a.n_slots, wide=wide)
    launches = fused_lookup_u64.launches
    got = fused_lookup_u64(*args, **statics)
    want = fused_lookup_u64_plain(*args, **statics)
    torch.cuda.synchronize()
    assert fused_lookup_u64.launches == launches + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    res = idx.lookup(q)
    assert res.backend in ("fused", "device-oracle")
    _assert_exact(res, plain_kv.PlainKV(keys, pay), q)
