"""The index's consumers in the port against the reference's: the
paged-KV block table (the three ``PagedKVCache`` cases of
tests/test_serving.py) and the data substrate (tests/test_data_pipeline.py:
the packed store, key -> ordinal resolution, batches, streamed ingest,
the seekable sharded loader), each run on both packages with the same
inputs and compared exactly."""

import numpy as np
import pytest
import torch

from repro.data import IndexedTokenDataset as RefDataset
from repro.data import PackedTokenStore as RefStore
from repro.data import ShardedLoader as RefLoader
from repro.serving.kv_cache import PagedKVCache as RefKV
from repro_torch.data import (IndexedTokenDataset, PackedTokenStore,
                              ShardedLoader)
from repro_torch.serving.kv_cache import PagedKVCache, table_key

# ---------------------------------------------------------------------------
# paged KV cache


def _kv_pair(**kw):
    return RefKV.create(**kw), PagedKVCache.create(device="cpu", **kw)


def test_paged_kv_alloc_lookup_free():
    ref, port = _kv_pair(n_pages=256, page_size=16, expected_requests=16)
    assert port.index.device == torch.device("cpu")
    out = []
    for kv in (ref, port):
        phys = {}
        for rid in (3, 7, 11):
            for p in range(4):
                phys[(rid, p)] = kv.alloc(rid, p)
        got = kv.lookup_batch(np.array([3, 7, 11, 3]), np.array([0, 2, 3, 1]))
        assert list(got) == [phys[(3, 0)], phys[(7, 2)], phys[(11, 3)],
                             phys[(3, 1)]]
        kv.free_request(7, 4)
        got2 = kv.lookup_batch(np.array([7]), np.array([1]))
        assert got2[0] == -1
        assert kv.utilization < 12 / 256 + 1e-9
        out.append((phys, got, kv.free_pages, kv.allocated,
                    kv.insert_path_stats()))
    (phys_r, got_r, free_r, alloc_r, _), (phys_p, got_p, free_p,
                                          alloc_p, _) = out
    assert phys_r == phys_p and np.array_equal(got_r, got_p)
    assert free_r == free_p and alloc_r == alloc_p
    stats_r, stats_p = out[0][4], out[1][4]
    for k in ("gap_fraction_remaining", "chained_keys", "epoch"):
        assert stats_r[k] == stats_p[k], k
    ga, gb = ref.index.gapped, port.index.gapped
    assert np.array_equal(ga.slot_key, gb.slot_key)
    assert np.array_equal(ga.payload, gb.payload)


def test_paged_kv_composite_keys_above_2_24_on_device():
    """Composite keys beyond f32 exactness resolve on the device path
    (the ``fused`` stage: the CUDA kernel on the card, its plain version
    here) exactly as on the host, in both packages."""
    ref, port = _kv_pair(n_pages=4096, page_size=16, expected_requests=64)
    rng = np.random.default_rng(0)
    rids = np.unique(rng.integers(16, 2 ** 21, 300)).astype(np.int64)
    pages = np.arange(4)
    q_rids = np.repeat(rids, 4)
    q_pages = np.tile(pages, len(rids))
    assert float(table_key(int(q_rids.max()), 3)) > 2 ** 24
    outs = []
    for kv in (ref, port):
        phys = {}
        for rid in rids.tolist():
            got = kv.alloc_batch(np.full(4, rid), pages)
            for p, ph in zip(pages, got):
                phys[(rid, int(p))] = int(ph)
        want = np.array([phys[(r, p)] for r, p in zip(q_rids, q_pages)])
        got_dev = kv.lookup_batch(q_rids, q_pages, device=True)
        got_host = kv.lookup_batch(q_rids, q_pages, device=False)
        assert np.array_equal(got_host, want)
        assert np.array_equal(got_dev, want)
        miss = kv.lookup_batch(np.array([2 ** 21 + 7]), np.array([9]),
                               device=True)
        assert miss[0] == -1
        outs.append((want, got_dev))
    assert port.index._key_caps()[0]      # the pair representation
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1], outs[1][1])
    assert port.index.stats["lookups"] == ref.index.stats["lookups"]


def test_paged_kv_exhaustion():
    for kv in _kv_pair(n_pages=4, page_size=16, expected_requests=2):
        for p in range(4):
            kv.alloc(1, p)
        with pytest.raises(MemoryError):
            kv.alloc(1, 4)


def test_paged_kv_create_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache.create(n_pages=64, expected_requests=4)
    store = PackedTokenStore.synthetic(40, mean_len=8, vocab=100, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        IndexedTokenDataset.build(store, method="pgm", eps=16, gap_rho=0.2)


# ---------------------------------------------------------------------------
# data substrate


@pytest.fixture
def datasets():
    kw = dict(method="pgm", eps=16, sample_rate=0.5, gap_rho=0.2)
    ref = RefDataset.build(RefStore.synthetic(600, mean_len=64, vocab=1000,
                                              seed=0), **kw)
    port = IndexedTokenDataset.build(
        PackedTokenStore.synthetic(600, mean_len=64, vocab=1000, seed=0),
        device="cpu", **kw)
    return ref, port


def test_store_roundtrip(tmp_path):
    ref = RefStore.synthetic(50, mean_len=32, seed=1)
    store = PackedTokenStore.synthetic(50, mean_len=32, seed=1)
    assert np.array_equal(ref.tokens, store.tokens)
    assert np.array_equal(ref.sample_keys, store.sample_keys)
    store.save(str(tmp_path / "st"))
    for loaded in (PackedTokenStore.load(str(tmp_path / "st")),
                   RefStore.load(str(tmp_path / "st"))):
        assert np.array_equal(loaded.sample_keys, store.sample_keys)
        assert np.array_equal(loaded.doc(7), store.doc(7))


def test_ordinal_resolution_and_batches(datasets):
    ref, port = datasets
    assert port.index.device == torch.device("cpu")
    keys = port.store.sample_keys[::7].astype(np.float64)
    ords = port.ordinals(keys)
    assert np.array_equal(ords, np.arange(port.store.n_docs)[::7])
    assert np.array_equal(ords, ref.ordinals(keys))
    b = port.batch(keys[:8], seq_len=32)
    assert b.shape == (8, 32)
    assert np.array_equal(b, ref.batch(keys[:8], seq_len=32))
    for ds in (ref, port):
        with pytest.raises(KeyError):
            ds.ordinals(np.array([3.5]))
    # the device backend (prefer_device) resolves the same ordinals
    port.prefer_device = ref.prefer_device = True
    big = port.store.sample_keys[:520].astype(np.float64)
    assert np.array_equal(port.ordinals(big), ref.ordinals(big))


def test_streamed_ingest(datasets):
    out = []
    for ds in datasets:
        new_key = int(ds.store.sample_keys[10]) + 1  # interleaves
        doc = np.arange(20, dtype=np.uint32)
        path = ds.ingest(doc, new_key)
        o = ds.ordinals(np.array([float(new_key)]))
        assert np.array_equal(ds.store.doc(int(o[0])), doc)
        docs = [np.arange(i + 3, dtype=np.uint32) for i in range(12)]
        keys = ds.store.sample_keys[20:32].astype(np.int64) + 1
        rep = ds.ingest_batch(docs, keys)
        ords = ds.ordinals(keys.astype(np.float64))
        assert all(np.array_equal(ds.store.doc(int(o)), d)
                   for o, d in zip(ords, docs))
        out.append((path, int(o[0]), rep.n, rep.slot, rep.chain,
                    rep.epoch, ords))
    (a, b) = out
    assert a[:6] == b[:6] and np.array_equal(a[6], b[6])


@pytest.mark.parametrize("method,kw", [("fiting", dict(eps=8)),
                                       ("rmi", dict(n_leaf=32))])
def test_loader_determinism_seek_and_sharding(method, kw):
    ref_store = RefStore.synthetic(256, mean_len=40, vocab=500, seed=2)
    store = PackedTokenStore.synthetic(256, mean_len=40, vocab=500, seed=2)
    ref = RefDataset.build(ref_store, method=method, **kw)
    ds = IndexedTokenDataset.build(store, method=method, device="cpu", **kw)
    l1 = ShardedLoader(ds, global_batch=16, seq_len=32, seed=7)
    batches = [l1.next_batch() for _ in range(5)]
    r1 = RefLoader(ref, global_batch=16, seq_len=32, seed=7)
    for b in batches:
        want = r1.next_batch()
        assert sorted(b) == sorted(want)
        for k in b:
            assert np.array_equal(np.asarray(b[k]), np.asarray(want[k])), k
    l2 = ShardedLoader(ds, global_batch=16, seq_len=32, seed=7)
    l2.seek(3)
    assert np.array_equal(l2.next_batch()["tokens"], batches[3]["tokens"])
    shards = [ShardedLoader(ds, global_batch=16, seq_len=16, seed=1,
                            shard_id=i, n_shards=4).next_batch()["tokens"]
              for i in range(4)]
    full = ShardedLoader(ds, global_batch=16, seq_len=16, seed=1).next_batch()
    for i in range(4):
        assert np.array_equal(shards[i], full["tokens"][i::4])
