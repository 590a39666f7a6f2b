"""The port's range-sharded index against the reference's: every case
of tests/test_sharded_index.py run on both packages on the same numpy
inputs and compared — payloads, slots and found exact with the same
backend labels, ingest reports field for field, forced and watermark
splits (each shard's state and the router bounds), prime shard counts,
the ``FanoutUnavailable`` fallback, build validation, the route's
exactness at the boundaries — and ``convert.sharded_from_state``
carrying a written and split reference index across."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import Index as RefIndex
from repro.dist.sharded import ShardedIndex as RefSharded
from repro_torch import convert
from repro_torch.core import Index, IngestReport, LookupResult
from repro_torch.dist import ShardedIndex, ShardedIngestReport, ShardRouter
from repro_torch.kernels import shard_fanout


def _int_keys(lo, hi, n, seed=0):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(lo, hi, size=n)).astype(np.float64)


def _mixed_queries(keys, n_hit, n_miss, seed=1):
    rng = np.random.default_rng(seed)
    q = np.concatenate([rng.choice(keys, n_hit),
                        rng.choice(keys, n_miss) + 1.0])
    rng.shuffle(q)
    return q


NARROW = dict(lo=1 << 10, hi=1 << 22, n=25_000)   # f32-exact ints
WIDE = dict(lo=1 << 30, hi=1 << 45, n=20_000)     # f32 hi/lo pair ints


def _build3(keys, shards, **kw):
    """(reference sharded, port single, port sharded) over the same
    keys; the port's single index answers as the reference's
    (tests/test_torch_index.py)."""
    kw = dict(dict(method="pgm", eps=64, gap_rho=0.2), **kw)
    return (RefIndex.build(keys, shards=shards, **kw),
            Index.build(keys, device="cpu", **kw),
            Index.build(keys, shards=shards, device="cpu", **kw))


def _triple(width):
    cfg = NARROW if width == "narrow" else WIDE
    keys = _int_keys(cfg["lo"], cfg["hi"], cfg["n"], seed=3)
    ref, port1, port = _build3(keys, 4)
    assert isinstance(port, ShardedIndex)
    return keys, ref, port1, port, width


@pytest.fixture(scope="module", params=["narrow", "wide"])
def shared(request):
    """One build per width for the tests that only read."""
    return _triple(request.param)


@pytest.fixture(params=["narrow", "wide"])
def fresh(request):
    """A build per test, for the tests that write."""
    return _triple(request.param)


def _same(a, b, slots=True, label=True):
    assert isinstance(b, LookupResult)
    assert np.array_equal(np.asarray(a.payloads), b.payloads)
    assert np.array_equal(np.asarray(a.found), b.found)
    if slots:
        assert np.array_equal(np.asarray(a.slots), b.slots)
    if label:
        assert a.backend == b.backend
        assert a.epoch == b.epoch


def _same_shard_state(a, b):
    ga, gb = a.gapped, b.gapped
    assert np.array_equal(ga.slot_key, gb.slot_key)
    assert np.array_equal(ga.occupied, gb.occupied)
    assert np.array_equal(ga.payload, gb.payload)
    assert ga.n_keys == gb.n_keys and a.epoch == b.epoch
    for x, y in zip(ga.export_csr_links(), gb.export_csr_links()):
        assert np.array_equal(x, y)


def _same_topology(ref, port):
    assert len(ref.shards) == len(port.shards)
    assert np.array_equal(ref.router.bounds, port.router.bounds)
    assert ref.router._params == port.router._params
    assert np.array_equal(ref.router.device_params(),
                          port.router.device_params())
    assert ref.epoch == port.epoch and ref._mutations == port._mutations
    for a, b in zip(ref.shards, port.shards):
        _same_shard_state(a, b)


def _report_fields(rep):
    d = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)
         if f.name not in ("seconds", "per_shard")}
    d["per_shard"] = [(s, _report_fields(r)) for s, r in
                      getattr(rep, "per_shard", ())]
    return d


def test_lookup_bit_identity_both_paths(shared):
    keys, ref, port1, port, width = shared
    if width == "wide":
        assert port1._key_caps() == (True, True)
    q = _mixed_queries(keys, 3000, 1500)
    got = port.lookup(q)                          # >= 512: fan-out
    assert got.backend == "sharded-fanout"
    _same(ref.lookup(q), got)
    _same(port1.lookup(q), got, slots=False, label=False)
    got_host = port.lookup(q[:200])               # < 512: grouped host
    assert got_host.backend == "sharded-host"
    _same(ref.lookup(q[:200]), got_host)
    _same(port1.lookup(q[:200]), got_host, slots=False, label=False)
    # per-shard backends through the grouped path
    for backend in ("fused", "numpy-oracle"):
        _same(ref.lookup(q, backend=backend),
              port.lookup(q, backend=backend))
    # sharded slots are globalized per shard: same key -> same slot
    slots = got.slots[got.found]
    first = {}
    for k, s in zip(q[got.found], slots):
        first.setdefault(k, s)
        assert first[k] == s
    assert port.stats == {k: ref.stats[k] for k in port.stats}
    assert port.router.stats["routed"] == ref.router.stats["routed"]


def test_boundary_queries_route_and_resolve_exactly(shared):
    keys, ref, port1, port, _ = shared
    b = port.router.bounds
    q = np.concatenate([b, b - 1.0, b + 1.0, keys[:1], keys[-1:] + 17.0])
    q = np.tile(q, 64)  # over min_device_batch: exercises the fan-out
    got = port.lookup(q)
    assert got.backend == "sharded-fanout"
    _same(ref.lookup(q), got)
    _same(port1.lookup(q), got, slots=False, label=False)
    assert np.array_equal(port.router.route(b),
                          np.arange(1, len(port.shards)))
    assert np.array_equal(port.router.route(b - 1.0),
                          np.arange(0, len(port.shards) - 1))
    assert np.array_equal(port._fan.route_host(q), ref._fan.route_host(q))


def test_ingest_bit_identity(fresh):
    keys, ref, port1, port, _ = fresh
    rng = np.random.default_rng(7)
    lo, hi = float(keys[0]), float(keys[-1])
    new = np.unique(rng.integers(int(lo), int(hi), size=4000)
                    ).astype(np.float64) + 0.5  # interleaves everywhere
    pays = rng.integers(0, 1 << 30, size=new.shape[0])
    port.lookup(keys[:1024])        # frozen fan-out before the write
    rep_r = ref.ingest(new, pays)
    rep_p = port.ingest(new, pays)
    assert isinstance(rep_p, ShardedIngestReport)
    assert isinstance(rep_p, IngestReport)
    assert rep_p.device == "sharded" and rep_p.n == new.shape[0]
    assert rep_p.slot + rep_p.chain == rep_p.n
    assert len(rep_p.per_shard) >= 2
    assert _report_fields(rep_p) == _report_fields(rep_r)
    _same_topology(ref, port)
    port1.ingest(new, pays)
    q = np.concatenate([rng.choice(keys, 2000), rng.choice(new, 2000),
                        rng.choice(keys, 500) + 2.0])
    rng.shuffle(q)
    got = port.lookup(q)            # the fan-out rebuilds on the new tag
    assert port._fan.epochs == tuple(sh.epoch for sh in port.shards)
    _same(ref.lookup(q), got)
    _same(port1.lookup(q), got, slots=False, label=False)
    _same(ref.lookup(q[:100]), port.lookup(q[:100]))


def test_forced_split_state_identity(fresh):
    keys, ref, port1, port, _ = fresh
    n_before = len(port.shards)
    rec_r = ref.maybe_rebalance(force_shard=1)
    rec_p = port.maybe_rebalance(force_shard=1)
    assert rec_p is not None and rec_p["shard"] == 1
    assert len(port.shards) == n_before + 1
    assert abs(rec_p["n_left"] - rec_p["n_right"]) <= 1
    assert {k: v for k, v in rec_p.items() if k != "seconds"} == {
        k: v for k, v in rec_r.items() if k != "seconds"}
    assert all(sh.device == torch.device("cpu") for sh in port.shards)
    _same_topology(ref, port)
    q = _mixed_queries(keys, 2500, 1000, seed=11)
    got = port.lookup(q)
    _same(ref.lookup(q), got)
    _same(port1.lookup(q), got, slots=False, label=False)
    _same(ref.lookup(q[:150]), port.lookup(q[:150]))


def test_skewed_writes_trigger_watermark_split():
    keys = _int_keys(1 << 10, 1 << 22, 20_000, seed=5)
    ref, _p1, port = _build3(keys, 4)
    skew = np.arange(keys[0] + 0.25, keys[0] + 2500.0, 0.5)
    for idx in (ref, port):
        idx.min_split_keys = 2048
        idx.split_occupancy_factor = 1.5
    rep_r = ref.ingest(skew, np.arange(skew.shape[0]) + (1 << 22))
    rep_p = port.ingest(skew, np.arange(skew.shape[0]) + (1 << 22))
    assert port.stats["splits"] == ref.stats["splits"] >= 1
    assert len(port.shards) > 4
    assert port.stats["rebalance_seconds"] > 0.0
    assert _report_fields(rep_p) == _report_fields(rep_r)
    _same_topology(ref, port)
    r = port.lookup(skew[:600])
    assert bool(np.all(r.found))
    _same(ref.lookup(skew[:600]), r)
    r2 = port.lookup(keys[::37])
    assert bool(np.all(r2.found))
    _same(ref.lookup(keys[::37]), r2)


def test_prime_shard_count_degenerate_mesh():
    keys = _int_keys(1 << 10, 1 << 22, 9_000, seed=9)
    ref, port1, port = _build3(keys, 11, eps=32)
    q = _mixed_queries(keys, 1500, 500, seed=2)
    got = port.lookup(q)
    assert got.backend == "sharded-fanout"
    assert port._fan.D == 1 and port._fan.S == 11
    _same(ref.lookup(q), got)
    _same(port1.lookup(q), got, slots=False, label=False)


def test_fanout_unavailable_falls_back_to_host_groups(monkeypatch):
    keys = _int_keys(1 << 10, 1 << 20, 6_000, seed=4)
    kw = dict(method="pgm", eps=64, gap_rho=0.2)
    single = Index.build(keys, device="cpu", **kw)
    ref = RefSharded.build(keys, shards=2, **kw)
    port = ShardedIndex.build(keys, shards=2, device="cpu", **kw)
    built = []

    def refuse(cls, *a, **k):
        built.append(1)
        raise shard_fanout.FanoutUnavailable("forced by test")

    monkeypatch.setattr(shard_fanout.ShardFanout, "build",
                        classmethod(refuse))
    q = _mixed_queries(keys, 800, 200, seed=3)
    got = port.lookup(q)
    assert got.backend == "sharded-host"
    _same(single.lookup(q), got, slots=False, label=False)
    ref_got = ref.lookup(q, backend="fused")   # the same grouped path
    assert ref_got.backend == "sharded-host"
    _same(ref_got, got)
    with pytest.raises(RuntimeError, match="fan-out unavailable"):
        port.lookup(q, backend="fanout")
    # the failed build is negative-cached per epoch tag
    assert port._fan_failed_tag is not None and len(built) == 1


def test_fanout_refuses_aliasing_and_non_plm_shards():
    # keys past 2^48 alias in the f32 pair: the fan-out refuses them,
    # the handle serves the exact grouped path
    keys = 2.0 ** 50 + 2.0 ** 25 + np.arange(0, 4_000, 1.0)
    port = Index.build(keys, shards=2, method="pgm", eps=64, gap_rho=0.2,
                       device="cpu")
    with pytest.raises(shard_fanout.FanoutUnavailable, match="alias"):
        shard_fanout.ShardFanout.build(port.shards, port.router.bounds,
                                       port.router.device_params())
    assert port.lookup(keys[:600]).backend == "sharded-host"
    # a gapped build always has a PLM; a shard whose mechanism exports
    # none is refused before anything is stacked
    copy = __import__("copy")
    shard = port.shards[0]
    shard.mech = copy.copy(shard.mech)
    shard.mech.plm = None
    with pytest.raises(shard_fanout.FanoutUnavailable, match="PLM"):
        shard_fanout.ShardFanout.build(port.shards, port.router.bounds,
                                       port.router.device_params())


def test_build_validation(monkeypatch):
    keys = np.arange(100, dtype=np.float64)
    for bad in (dict(shards=2, gap_rho=0.0), dict(shards=64, gap_rho=0.2),
                dict(shards=2, gap_rho=0.2, payloads=np.arange(3))):
        with pytest.raises(ValueError):
            RefSharded.build(keys, **bad)
        with pytest.raises(ValueError):
            ShardedIndex.build(keys, device="cpu", **bad)
    with pytest.raises(ValueError):  # unsorted
        ShardedIndex.build(keys[::-1], shards=2, gap_rho=0.2, device="cpu")
    with pytest.raises(ValueError):
        ShardRouter(np.array([3.0, 2.0]))
    # cuda by default, which raises without it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedIndex.build(keys, shards=2, gap_rho=0.2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Index.build(keys, shards=2, gap_rho=0.2)


@pytest.mark.parametrize("key_wide", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_router_boundary_exactness(key_wide, seed):
    """The device route (learned prediction + exact bisect backstop)
    equals searchsorted over the rounded boundaries, on, just below and
    just above every boundary, and equals the reference's route."""
    rng = np.random.default_rng(seed)
    hi = (1 << 47) if key_wide else (1 << 23)
    vals = np.unique(rng.integers(0, hi, size=int(rng.integers(4, 400))
                                  )).astype(np.float64)
    n_b = int(rng.integers(1, max(2, vals.size // 2)))
    idx = np.linspace(0, vals.size - 1, n_b + 2)[1:-1]
    bounds = np.unique(vals[np.round(idx).astype(int)])
    rb = shard_fanout._round_key_repr(bounds, key_wide)
    assert np.all(np.diff(rb) > 0)
    q = np.unique(np.concatenate([vals, bounds, bounds - 1.0,
                                  bounds + 1.0]))
    router = ShardRouter(bounds, lo_key=float(vals[0]))
    s = bounds.size + 1
    qh, ql = shard_fanout.split_key_pair(q)
    bh, bl = shard_fanout.split_key_pair(bounds)
    if not key_wide:
        ql, bl = np.zeros_like(ql), np.zeros_like(bl)
    r_trips = int(np.ceil(np.log2(max(s - 1, 2)))) + 1
    dst, _ = shard_fanout._route_block(
        torch.from_numpy(qh), torch.from_numpy(ql), torch.from_numpy(bh),
        torch.from_numpy(bl), torch.from_numpy(router.device_params()),
        s, r_trips, key_wide)
    want = np.searchsorted(rb, shard_fanout._round_key_repr(q, key_wide),
                           side="right")
    assert np.array_equal(dst.numpy(), want)
    assert np.array_equal(router.route(q), np.searchsorted(
        bounds, q, side="right"))


def test_abort_telemetry_on_ingest_report():
    """The fused write graph's abort reason and counter ride the shard
    handle's IngestReport alike in both packages."""
    init = np.arange(0, 1_000_000, 100, dtype=np.float64)
    reps = []
    for idx in (RefIndex.build(init, method="pgm", eps=32, gap_rho=0.2),
                Index.build(init, method="pgm", eps=32, gap_rho=0.2,
                            device="cpu")):
        idx.fused_ingest_enabled = True
        idx.sync_device()
        batch = np.setdiff1d(np.arange(50_001, 50_001 + 620,
                                       dtype=np.float64), init)[:512]
        rep = idx.ingest(batch, 3_000_000 + np.arange(batch.size))
        idx.sync_device()
        spread = (init + 50.0)[::19][:512]
        rep2 = idx.ingest(spread, 4_000_000 + np.arange(spread.size))
        reps.append((rep, rep2, idx.stats["fused_abort_total"]))
    (r1, r2, n_r), (p1, p2, n_p) = reps
    assert p1.device != "fused" and len(p1.abort_reasons) >= 1
    assert p1.fused_aborts == 1 and n_p == n_r == 1
    assert p2.abort_reasons == () and p2.fused_aborts == 1
    assert _report_fields(p1) == _report_fields(r1)
    assert _report_fields(p2) == _report_fields(r2)


def _shard_state(sh):
    """A reference shard's snapshot leaves + PLM arrays, as
    ``convert.index_from_state`` takes them."""
    ga = sh.gapped
    offsets, lkeys, lpays = ga.export_csr_links()
    plm = sh.mech.plm
    state = {"keys": sh.keys, "slot_key": ga.slot_key,
             "occupied": ga.occupied, "payload": ga.payload,
             "offsets": offsets, "chain_keys": lkeys,
             "chain_payloads": lpays}
    state.update({f: getattr(plm, f) for f in convert.PLM_LEAVES})
    meta = {"method": sh.method, "n_keys": int(ga.n_keys),
            "rho": float(ga.rho), "epoch": int(sh.epoch),
            "gap_rho": float(sh.gap_rho),
            "sample_rate": float(sh.sample_rate),
            "plm_n_keys": int(plm.n_keys)}
    return state, meta


def test_sharded_from_state_carries_a_written_split_index(tmp_path):
    import json
    keys = _int_keys(1 << 30, 1 << 45, 20_000, seed=12)
    ref = RefIndex.build(keys, shards=3, method="pgm", eps=64, gap_rho=0.2)
    rng = np.random.default_rng(13)
    new = np.setdiff1d(np.unique(rng.integers(int(keys[0]), int(keys[-1]),
                                              3_000)) + 0.5, keys)
    ref.ingest(new, (1 << 40) + np.arange(new.size))
    ref.maybe_rebalance(force_shard=2)
    ref.save_snapshot(tmp_path / "ck", step=3, wal_lsn=9)
    manifest = json.loads((tmp_path / "ck" / "sharded_manifest.json")
                          .read_text())
    port = convert.sharded_from_state(
        manifest, [_shard_state(sh) for sh in ref.shards], device="cpu")
    assert isinstance(port, ShardedIndex) and len(port.shards) == 4
    _same_topology(ref, port)
    # the port's copies share no memory with the reference's state
    assert not np.shares_memory(port.shards[0].gapped.slot_key,
                                ref.shards[0].gapped.slot_key)
    q = np.concatenate([_mixed_queries(keys, 2000, 800, seed=14),
                        new[::3]])
    _same(ref.lookup(q), port.lookup(q))
    _same(ref.lookup(q[:300]), port.lookup(q[:300]))
    more = np.setdiff1d(new[:-1] + 0.25, new)[:500]
    rep_r = ref.ingest(more, np.arange(more.size))
    rep_p = port.ingest(more, np.arange(more.size))
    assert _report_fields(rep_p) == _report_fields(rep_r)
    _same_topology(ref, port)
    with pytest.raises(ValueError, match="shard states"):
        convert.sharded_from_state(manifest, [], device="cpu")
