"""The port's shard fan-out against the reference's, on the same numpy
inputs: the fused rank-router search and its epilogue against the
reference's ``_fused_pipeline`` (slot, found and the escape mask
exact), the host escape patch, the stacked shard images array for
array, the learned route with its exact backstop, a send buffer small
enough to drop rows (patched on the host), and D = 2 and D = 4 devices
stood in on the CPU, equal to D = 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Index as RefIndex
from repro.dist.sharded import ShardRouter as RefRouter
from repro.kernels import ops as ref_ops
from repro.kernels import shard_fanout as ref_sf
from repro_torch.core import Index
from repro_torch.dist import ShardRouter
from repro_torch.kernels import freeze, ops, shard_fanout

WIDTHS = {"narrow": 2 ** 22, "wide": 2 ** 40}


def _keys(span, n, seed):
    rng = np.random.default_rng(seed)
    return np.unique(rng.choice(span, n, replace=False)).astype(np.float64)


def _written_pair(width, *, wide_payloads, n=25_000, seed=0):
    """The same build and the same writes (chains included) in both
    packages; payloads past int32 when ``wide_payloads``."""
    keys = _keys(WIDTHS[width], n, seed)
    kw = dict(method="pgm", eps=64, gap_rho=0.15)
    ref = RefIndex.build(keys, **kw)
    port = Index.build(keys, device="cpu", **kw)
    rng = np.random.default_rng(seed + 1)
    # midpoints land in gaps; a run of 40 neighbours in one gap chains
    mids = np.setdiff1d(keys[:-1] + np.floor(np.diff(keys) * 0.5), keys)
    wide_gap = np.flatnonzero(np.diff(keys) > 41)[100]
    new = np.concatenate([rng.choice(mids, 2_000, replace=False),
                          keys[wide_gap] + 1.0 + np.arange(40)])
    new = np.setdiff1d(new, keys)
    base = (3 << 40) if wide_payloads else 1_000_000
    pays = base + np.arange(new.size)
    for idx in (ref, port):
        idx.ingest(new, pays)
    return keys, new, ref, port


def _queries(keys, new, seed=2):
    rng = np.random.default_rng(seed)
    return rng.permutation(np.concatenate([
        rng.choice(keys, 2_000), rng.choice(new, 800),
        rng.choice(keys, 600) + 0.5, keys[:1] - 3.0, keys[-1:] + 9.0]))


def _graph_inputs(ref):
    """The reference's frozen images and rank router, as numpy."""
    arr, st = ref_ops._freeze_numpy(ref)
    tbl, scl, trips, _meta = ref_ops.build_rank_router(
        arr["slot_key"], arr["slot_key_lo"] if st["key_wide"] else None)
    return arr, st, tbl, scl, trips


@pytest.mark.parametrize("width", ["narrow", "wide"])
@pytest.mark.parametrize("wide_payloads", [False, True])
@pytest.mark.parametrize("trips", ["table", 1])
def test_fused_search_and_epilogue_match_reference(width, wide_payloads,
                                                   trips):
    keys, new, ref, _port = _written_pair(width,
                                          wide_payloads=wide_payloads)
    assert ref.gapped.links.max_chain > 1
    arr, st, tbl, scl, t_tab = _graph_inputs(ref)
    assert st["key_wide"] == (width == "wide")
    assert st["wide"] == wide_payloads
    trips = t_tab if trips == "table" else 1   # 1: most queries escape
    q = _queries(keys, new)
    qh, ql = ref_ops._split_queries(q, st["key_wide"])
    if not st["key_wide"]:
        ql = np.zeros_like(qh)
    names = ("slot_key", "slot_key_lo", "payload", "payload_hi",
             "link_offsets", "link_keys", "link_keys_lo", "link_payloads",
             "link_payload_hi")
    want = ref_ops._fused_pipeline(
        jnp.asarray(qh), jnp.asarray(ql),
        *[jnp.asarray(arr[k]) for k in names],
        jnp.asarray(tbl), jnp.asarray(scl), trips=trips,
        max_chain=st["max_chain"], wide=st["wide"],
        key_wide=st["key_wide"])
    got = ops.fused_pipeline(
        torch.from_numpy(qh), torch.from_numpy(ql),
        *[torch.from_numpy(np.ascontiguousarray(arr[k])) for k in names],
        torch.from_numpy(tbl), torch.from_numpy(scl), trips=trips,
        max_chain=st["max_chain"], wide=st["wide"],
        key_wide=st["key_wide"])
    for name, w, g in zip(("out", "out_hi", "slot", "resolved", "fb"),
                          want, got):
        assert np.array_equal(np.asarray(w), g.numpy()), name
    fb = got[4].numpy()
    assert fb.any() == (trips == 1)
    # the host finish: the flagged rows patched, payloads recombined
    host = ref_ops.host_fallback_views(ref_ops._to_device(arr, st))
    mine = ops.host_fallback_views(freeze.to_device(arr, st, "cpu"))
    for k, v in host.items():
        assert np.array_equal(np.asarray(v), np.asarray(mine[k])), k
    w_fin = ref_ops._finish_fused_host(*want, q.size, st["wide"], q,
                                       lambda: host)
    g_fin = ops.finish_fused_host(*got, q.size, st["wide"], q,
                                  lambda: mine)
    for w, g in zip(w_fin[:3], g_fin[:3]):
        assert np.array_equal(np.asarray(w), g)
    assert w_fin[3] == g_fin[3] == int(fb.sum())
    # and the patched answers are the host oracle's
    pay, _slot, found = ref.gapped.lookup_batch(q, full=True)
    assert np.array_equal(g_fin[0].astype(np.int64), pay)
    assert np.array_equal(g_fin[2], found)


@pytest.mark.parametrize("width", ["narrow", "wide"])
def test_resolve_escapes_host_matches_reference(width):
    keys, new, ref, _port = _written_pair(width, wide_payloads=True)
    arr, st, *_ = _graph_inputs(ref)
    host = ref_ops.host_fallback_views(ref_ops._to_device(arr, st))
    q = _queries(keys, new, seed=5)
    want = ref_ops.resolve_escapes_host(host, q)
    got = ops.resolve_escapes_host(host, q)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g)
    assert got[1].sum() > 2_500   # hits, chain hits among them


def _sharded_pair(width, shards, n=25_000, seed=3, **kw):
    keys = _keys(WIDTHS[width], n, seed)
    kw = dict(dict(method="pgm", eps=64, gap_rho=0.2), **kw)
    ref = RefIndex.build(keys, shards=shards, **kw)
    port = Index.build(keys, shards=shards, device="cpu", **kw)
    return keys, ref, port


@pytest.mark.parametrize("width", ["narrow", "wide"])
def test_stack_shard_images_equal_reference(width):
    keys, ref, port = _sharded_pair(width, 4)
    rng = np.random.default_rng(4)
    new = np.setdiff1d(rng.uniform(keys[0], keys[-1], 3_000).round() + 0.5,
                       keys)
    for idx in (ref, port):   # chains and wide payloads in some shards
        idx.ingest(new, (5 << 40) + np.arange(new.size))
    want, w_st = ref_sf.stack_shard_images(ref.shards)
    got, g_st = shard_fanout.stack_shard_images(port.shards)
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        assert np.array_equal(want[k], got[k]), k
    for k in w_st:
        assert np.array_equal(w_st[k], g_st[k]), k


@pytest.mark.parametrize("key_wide", [False, True])
def test_route_block_matches_reference(key_wide):
    rng = np.random.default_rng(6)
    span = 2 ** 44 if key_wide else 2 ** 23
    vals = np.unique(rng.choice(span, 40_000, replace=False)
                     ).astype(np.float64)
    bounds = vals[np.linspace(0, vals.size - 1, 9)[1:-1].astype(int)]
    q = np.concatenate([vals, bounds, bounds - 1.0, bounds + 1.0,
                        [np.inf] * 64])
    router = RefRouter(bounds, lo_key=float(vals[0]))
    port_router = ShardRouter(bounds, lo_key=float(vals[0]))
    rp = router.device_params()
    assert np.array_equal(rp, port_router.device_params())
    s = bounds.size + 1
    r_trips = int(np.ceil(np.log2(max(s - 1, 2)))) + 1
    qh, ql = ref_ops.split_key_pair(q)
    bh, bl = ref_ops.split_key_pair(bounds)
    if not key_wide:
        ql, bl = np.zeros_like(ql), np.zeros_like(bl)
    w_dst, w_mis = ref_sf._route_block(
        jnp.asarray(qh), jnp.asarray(ql), jnp.asarray(bh), jnp.asarray(bl),
        jnp.asarray(rp), s, r_trips, key_wide)
    g_dst, g_mis = shard_fanout._route_block(
        torch.from_numpy(qh), torch.from_numpy(ql), torch.from_numpy(bh),
        torch.from_numpy(bl), torch.from_numpy(rp), s, r_trips, key_wide)
    assert g_dst.dtype == torch.int32
    assert np.array_equal(np.asarray(w_dst), g_dst.numpy())
    rb = ref_sf._round_key_repr(bounds, key_wide)
    exact = np.searchsorted(rb, ref_sf._round_key_repr(q, key_wide),
                            side="right")
    assert np.array_equal(g_dst.numpy(), exact)
    # the prediction's product and sum: XLA-CPU may fuse them, so the
    # mispredict counts agree as a rate
    assert abs(int(w_mis) - int(g_mis)) <= 0.005 * q.size
    assert 0 < int(g_mis) < q.size


@pytest.mark.parametrize("width", ["narrow", "wide"])
def test_small_cap_drops_rows_and_patches_them(width):
    keys, ref, port = _sharded_pair(width, 4, n=20_000)
    q = _queries(keys, keys[::7] + 0.5, seed=8)
    want = ref.lookup(q)
    fan = port._fanout()
    bucket = fan._bucket(q.size)
    cap = fan._cap_for(bucket)
    fan._cap_for = lambda b: 16        # far below a shard's share
    got = port.lookup(q)
    assert got.backend == "sharded-fanout"
    assert fan.stats["cap_overflows"] == 1
    assert fan._cap_boost[bucket] == 4
    assert got.fallbacks >= q.size - 4 * 16   # 16 rows a shard kept
    for f in ("payloads", "slots", "found"):
        assert np.array_equal(getattr(want, f), getattr(got, f)), f
    del fan._cap_for                   # the learned boost sizes the next
    assert fan._cap_for(bucket) == min(4 * cap, bucket)
    again = port.lookup(q)
    assert fan.stats["cap_overflows"] == 1
    assert np.array_equal(again.payloads, want.payloads)


@pytest.mark.parametrize("n_dev,shards", [(2, 4), (4, 4), (4, 8), (4, 6)])
def test_devices_stand_in_on_the_cpu(monkeypatch, n_dev, shards):
    keys, ref, port = _sharded_pair("wide", shards, n=20_000)
    q = _queries(keys, keys[::5] + 0.5, seed=9)
    one = port.lookup(q)
    assert port._fan.D == 1
    monkeypatch.setattr(shard_fanout, "fanout_devices",
                        lambda dev: [torch.device("cpu")] * n_dev)
    port._fan = None
    got = port.lookup(q)
    d = shard_fanout.largest_divisor_leq(shards, n_dev)
    assert got.backend == "sharded-fanout" and port._fan.D == d
    assert len(port._fan.stacked) == d
    assert all(p["slot_key"].shape[0] == shards // d
               for p in port._fan.stacked)
    want = ref.lookup(q)
    for r in (want, got):
        for f in ("payloads", "slots", "found"):
            assert np.array_equal(getattr(one, f), getattr(r, f)), f
    # with rows dropped from every block's send buffer as well
    port._fan._cap_for = lambda b: 16
    dropped = port.lookup(q)
    assert port._fan.stats["cap_overflows"] == 1
    for f in ("payloads", "slots", "found"):
        assert np.array_equal(getattr(one, f), getattr(dropped, f)), f
