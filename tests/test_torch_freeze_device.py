"""The freeze on the device (``kernels.delta.freeze_on_device``) against
the host freeze (``freeze_state`` on the CPU): the window bounds bit
for bit (``bounds.query_window_bounds_device`` against
``query_window_bounds``), the images element for element
(``freeze.freeze_headroom_device``), the statics, the engine's radix
and rank routers (table, scale, trips, meta) and the ``HostMirror``'s
images and sources.

The CPU cases run the device functions with ``device="cpu"`` over PGM
and FITing, sample rates 1.0 and 0.01, f32-pair keys (below 2^32),
clustered keys below 2^40 and in [2^50, 2^52) (where the pairs are
inexact), narrow keys (below 2^24) and 64-bit keys
(``core.keys64``), narrow and wide payloads, at the default chunks and
at chunks of 97 keys and slots.  A forced PLM adds hundreds of segment
boundaries (the 97-key chunks cross them), empty segments (first, in
key gaps, last) and negative slopes.  A write after a device freeze
(a delta with its incremental bound refresh, then a declined delta's
refreeze) leaves the same arrays, bounds and labels as after a host
freeze.  The ``gpu`` case freezes 2M keys on the card, holds it to the
host freeze and its peak to the engine's tensors plus 1 MB (the last
image's chunk), with the chunks scaled from 32M keys to 2M; it skips
without a card.  This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Index
from repro_torch.kernels import bounds, delta, freeze, place

SMALL_CHUNK = 97
TAIL_BUDGET = 1 << 20           # the freeze's bytes beyond its images
BUDGET_KEYS = 32_000_000        # the chunks are sized for 32M keys
# kind: (key domain, clusters); payload bits per case below
KINDS = {"pair": ((0, 1 << 32), 0), "clustered": ((0, 1 << 40), 300),
         "inexact": ((1 << 50, 1 << 52), 300),   # pairs inexact past 2^48
         "narrow": ((0, 1 << 24), 300), "u64": ((1 << 60, 1 << 63), 300)}


@pytest.fixture(autouse=True)
def one_thread():
    # the CPU path runs many small torch ops; a thread pool on a shared
    # host costs each of them milliseconds
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(kind, n, seed):
    rng = np.random.default_rng(seed)
    (lo, hi), runs = KINDS[kind]
    if not runs:
        k = np.unique(rng.choice(hi, n, replace=False))
    else:   # runs of near-consecutive integers, far apart
        starts = np.sort(rng.integers(lo // 1024, hi // 1024, runs)) * 1024
        step = rng.integers(1, 3, runs)
        k = np.unique(np.concatenate(
            [s + np.arange(n // runs) * st for s, st in zip(starts, step)]))
    return k.astype(np.uint64 if kind == "u64" else np.float64)


def _index(kind, method="pgm", rate=0.01, pay_bits=30, n=20_000, seed=1,
           device="cpu"):
    x = _keys(kind, n, seed)
    pay = np.random.default_rng(seed + 1).integers(0, 1 << pay_bits, x.size)
    return Index.build(x, method=method, eps=64, gap_rho=0.15,
                       sample_rate=rate, payloads=pay, device=device,
                       rng=np.random.default_rng(3))


def _bits(a):
    return np.asarray(a, np.float64).view(np.int64)


def _assert_bounds_equal(idx, slot_key=None):
    lo, hi = bounds.query_window_bounds(idx)
    if slot_key is None:
        slot_key = torch.from_numpy(np.ascontiguousarray(
            idx.gapped.slot_key))
    dlo, dhi = bounds.query_window_bounds_device(idx, slot_key)
    assert dlo.dtype == dhi.dtype == np.float64
    assert np.array_equal(_bits(lo), _bits(dlo))
    assert np.array_equal(_bits(hi), _bits(dhi))
    return lo, hi


def _tensor_equal(a, b):
    return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


def _assert_freeze_equal(host, dev, where="cpu"):
    (he, hm), (de, dm) = host, dev
    for f in freeze._NP_FIELDS:
        assert _tensor_equal(getattr(he.arrays, f), getattr(de.arrays, f)), f
    for f in ("n_slots", "max_chain", "wide", "key_wide", "key_u64"):
        assert getattr(he.arrays, f) == getattr(de.arrays, f), f
    assert hm.statics == dm.statics
    # the engine: bounds, their statics, routers
    assert np.array_equal(_bits(he.err_lo), _bits(de.err_lo))
    assert np.array_equal(_bits(he.err_hi), _bits(de.err_hi))
    for f in ("_elo", "_ehi", "_radix_table", "_radix_scale"):
        assert _tensor_equal(getattr(he, f), getattr(de, f)), f
    assert (he._trips, he._flat_w, he._fused_flat_w, he._rank_trips,
            he._rank_meta) == (de._trips, de._flat_w, de._fused_flat_w,
                               de._rank_trips, de._rank_meta)
    if he.u64:
        assert _tensor_equal(he._radix_key, de._radix_key)
        assert de._rank_table is None
    else:
        assert np.array_equal(he._rank_np, de._rank_np)
        assert he._rank_np.dtype == de._rank_np.dtype
        for f in ("_rank_table", "_rank_scale"):
            assert _tensor_equal(getattr(he, f), getattr(de, f)), f
    # the mirror
    assert hm.images.keys() == dm.images.keys()
    for f, img in hm.images.items():
        assert img.dtype == dm.images[f].dtype, f
        assert np.array_equal(img, dm.images[f]), f
        t = getattr(de.arrays, f)
        assert t.is_cuda or not np.shares_memory(dm.images[f], t.numpy()), f
    assert hm.sources.keys() == dm.sources.keys()
    for f, v in hm.sources.items():
        assert v.dtype == dm.sources[f].dtype
        assert np.array_equal(v, dm.sources[f]), f
    assert (hm.links_at_freeze, hm.n_keys_at_freeze) == (
        dm.links_at_freeze, dm.n_keys_at_freeze)
    assert (hm.freeze_device, dm.freeze_device) == ("host", where)


def _freezes(idx, device="cpu"):
    host = delta.freeze_state(idx, device) if device == "cpu" else None
    before = delta.device_freezes
    stages = {}
    dev = delta.freeze_on_device(idx, device, stages=stages)
    assert delta.device_freezes == before + 1
    assert set(stages) == {"images", "upload", "bounds", "routers",
                           "mirror"}
    return host, dev


@pytest.mark.parametrize("chunk", ["default", "97"])
@pytest.mark.parametrize("kind,pay_bits", [("pair", 30), ("clustered", 40),
                                           ("inexact", 30), ("narrow", 40),
                                           ("u64", 40)])
@pytest.mark.parametrize("method", ["pgm", "fiting"])
@pytest.mark.parametrize("rate", [1.0, 0.01])
def test_device_freeze_equals_host_freeze(rate, method, kind, pay_bits,
                                          chunk, monkeypatch):
    if chunk == "97":
        monkeypatch.setattr(place, "CHUNK_KEYS", SMALL_CHUNK)
        monkeypatch.setattr(freeze, "IMAGE_CHUNK", SMALL_CHUNK)
        monkeypatch.setattr(freeze, "TAIL_CHUNK", SMALL_CHUNK)
        monkeypatch.setattr(bounds, "RANK_CHUNK", SMALL_CHUNK)
    idx = _index(kind, method, rate, pay_bits)
    _assert_bounds_equal(idx)
    host, dev = _freezes(idx)
    _assert_freeze_equal(host, dev)
    arrays = dev[0].arrays
    assert arrays.key_u64 == (kind == "u64")
    assert arrays.key_wide == (kind in ("pair", "clustered", "inexact"))
    assert arrays.wide == (pay_bits > 31)


def _force_segments(idx, rng, n_split=150):
    """Rewrite the index's PLM: ``n_split`` segments split at a key gap
    into an empty segment and the rest of the line, an empty first
    segment, two empty segments past the last key, and a negative slope
    on every 7th segment.  The freeze reads the PLM as it is."""
    plm = idx.mech.plm
    u64 = idx.gapped.slot_key.dtype == np.int64
    x = np.asarray(idx.keys, np.float64)
    gaps = np.flatnonzero(np.diff(x) > 8.0 * max(1.0, np.spacing(x[-1])))
    picks = np.sort(rng.choice(gaps, n_split, replace=False))
    first = list(plm.seg_first_key)
    slope, icept = list(plm.slope), list(plm.icept)
    err_lo, err_hi = list(plm.err_lo), list(plm.err_hi)
    new = [(x[0] - 3.0 * (x[1] - x[0]), 0)]   # empty before the keys
    for i in picks:
        a, b = x[i], x[i + 1]
        s = int(plm.segment_of(np.array([a]))[0])
        new += [(a + (b - a) / 4.0, s), (a + (b - a) * 0.75, s)]
    span = x[-1] - x[0]
    new += [(x[-1] + span / 8.0, -1), (x[-1] + span / 4.0, -1)]
    for key, s in new:
        first.append(key)
        s = s if s >= 0 else len(plm.slope) - 1
        slope.append(plm.slope[s])
        icept.append(plm.icept[s] + plm.slope[s] * (key - plm.seg_first_key[s]))
        err_lo.append(plm.err_lo[s])
        err_hi.append(plm.err_hi[s])
    order = np.argsort(np.asarray(first), kind="stable")
    plm.seg_first_key = np.asarray(first, np.float64)[order]
    plm.slope = np.asarray(slope, np.float64)[order]
    plm.icept = np.asarray(icept, np.float64)[order]
    plm.err_lo = np.asarray(err_lo, np.float64)[order]
    plm.err_hi = np.asarray(err_hi, np.float64)[order]
    plm.slope[3::7] = -np.abs(plm.slope[3::7]) - 0.25
    # the segments the keys route to, as the freeze routes them
    fk = plm.seg_first_key
    if u64:
        from repro_torch.core import keys64
        fk = keys64.seg_first_ordered(fk)
        xr = keys64.to_ordered(idx.keys)
    else:
        xr = x
    routed = np.unique(np.clip(np.searchsorted(fk, xr, side="right") - 1,
                               0, fk.size - 1))
    return plm.n_segments, plm.n_segments - routed.size


@pytest.mark.parametrize("chunk", ["default", "97"])
@pytest.mark.parametrize("kind,pay_bits", [("pair", 40), ("narrow", 30),
                                           ("u64", 30)])
def test_forced_segments_empty_and_negative(kind, pay_bits, chunk,
                                            monkeypatch):
    if chunk == "97":
        monkeypatch.setattr(place, "CHUNK_KEYS", SMALL_CHUNK)
        monkeypatch.setattr(freeze, "IMAGE_CHUNK", SMALL_CHUNK)
        monkeypatch.setattr(freeze, "TAIL_CHUNK", SMALL_CHUNK)
        monkeypatch.setattr(bounds, "RANK_CHUNK", SMALL_CHUNK)
    idx = _index(kind, "pgm", 0.01, pay_bits)
    k, empty = _force_segments(idx, np.random.default_rng(11))
    assert k > 300 and empty >= 150
    assert np.count_nonzero(idx.mech.plm.slope < 0) >= 40
    lo, hi = _assert_bounds_equal(idx)
    # the bounds moved from the PLM's own: the terms reached them
    assert not np.array_equal(lo, idx.mech.plm.err_lo)
    host, dev = _freezes(idx)
    _assert_freeze_equal(host, dev)


@pytest.mark.parametrize("max_widen", [None, 32.0, 0.5])
def test_bounds_without_and_with_clamp(max_widen):
    idx = _index("clustered", "fiting", 1.0)
    _force_segments(idx, np.random.default_rng(5), n_split=40)
    lo, hi = bounds.query_window_bounds(idx, max_widen=max_widen)
    dlo, dhi = bounds.query_window_bounds_device(
        idx, torch.from_numpy(np.ascontiguousarray(idx.gapped.slot_key)),
        max_widen=max_widen)
    assert np.array_equal(_bits(lo), _bits(dlo))
    assert np.array_equal(_bits(hi), _bits(dhi))


def test_cpu_index_freezes_on_the_host():
    idx = _index("pair")
    before = delta.device_freezes
    idx.sync_device()
    assert delta.device_freezes == before
    assert idx.stats["freeze_device"] == "host"
    assert not delta.freezes_on_device(idx, "cpu")
    assert delta.freezes_on_device(idx, "cuda")
    static = Index.build(_keys("pair", 5_000, 2), method="pgm", eps=64,
                         device="cpu")
    assert not delta.freezes_on_device(static, "cuda")   # no gapped array


def _labels(a, b, calls):
    """The same calls on both indexes; the reports and sync stats
    agree, and so do the device arrays, bounds and mirrors."""
    for call in calls:
        ra, rb = call(a), call(b)
        if hasattr(ra, "device"):
            assert (ra.device, ra.placement, ra.slot, ra.chain) == (
                rb.device, rb.placement, rb.slot, rb.chain)
    keep = ("refreezes", "delta_updates", "delta_elems", "ingests",
            "bound_refreshes")
    assert {k: a.stats.get(k) for k in keep} == {
        k: b.stats.get(k) for k in keep}
    ea, eb = a._engine, b._engine
    for f in freeze._NP_FIELDS:
        assert _tensor_equal(getattr(ea.arrays, f), getattr(eb.arrays, f)), f
    assert np.array_equal(_bits(ea.err_lo), _bits(eb.err_lo))
    assert np.array_equal(_bits(ea.err_hi), _bits(eb.err_hi))
    assert np.array_equal(ea._rank_np, eb._rank_np)
    assert a._mirror.images.keys() == b._mirror.images.keys()
    for f, img in a._mirror.images.items():
        assert np.array_equal(img, b._mirror.images[f]), f
    for f, v in a._mirror.sources.items():
        assert np.array_equal(v, b._mirror.sources[f]), f
    return b.stats


def test_writes_after_device_freeze_equal_host_freeze(monkeypatch):
    """``on`` freezes through ``freeze_on_device`` (on the CPU), ``off``
    through the host path; the same writes give the same state."""
    rng = np.random.default_rng(9)
    keys = np.unique(rng.choice(2 ** 22, 25_000, replace=False)
                     ).astype(np.float64)
    off = Index.build(keys, method="pgm", eps=64, gap_rho=0.15,
                      rng=np.random.default_rng(2), device="cpu")
    on = Index.build(keys, method="pgm", eps=64, gap_rho=0.15,
                     rng=np.random.default_rng(2), device="cpu")
    monkeypatch.setattr(delta, "freezes_on_device",
                        lambda index, device: index is on)
    off.sync_device()
    on.sync_device()
    assert (off.stats["freeze_device"], on.stats["freeze_device"]) == (
        "host", "cpu")
    q = rng.choice(keys, 2000)
    # inserts between keys: a delta and its incremental bound refresh
    new = np.setdiff1d(keys[100:3000:3] + 0.5, keys)
    st = _labels(off, on, [lambda i: i.ingest(new, np.arange(new.size)),
                           lambda i: i.lookup(q)])
    assert st["delta_updates"] == 1 and st["refreezes"] == 1
    assert st.get("bound_refreshes", 0) == 1
    # a small payload update: a pure payload delta
    st = _labels(off, on, [
        lambda i: i.update_batch(keys[:50], np.arange(50)),
        lambda i: i.lookup(q)])
    assert st["delta_updates"] == 2 and st["refreezes"] == 1
    # an int64 payload past the narrow i32 freeze declines the delta:
    # the refreeze runs on each side's path
    devs = delta.device_freezes
    st = _labels(off, on, [
        lambda i: i.update_batch(keys[:600],
                                 (np.int64(1) << 40) + np.arange(600)),
        lambda i: i.lookup(q)])
    assert st["refreezes"] == 2 and delta.device_freezes == devs + 1
    assert on._engine.arrays.wide and on.stats["freeze_device"] == "cpu"
    # and a delta after that refreeze
    st = _labels(off, on, [lambda i: i.ingest(new + 0.25,
                                              np.arange(new.size)),
                           lambda i: i.lookup(q)])
    assert st["delta_updates"] == 3
    a, b = off.lookup(q), on.lookup(q)
    assert np.array_equal(a.payloads, b.payloads)
    assert np.array_equal(a.found, b.found) and a.found.all()


@pytest.mark.gpu
def test_cuda_freeze_equals_host_freeze_within_budget(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 2_000_000
    # the 32M-key configuration scaled to n keys: the bounds' and the
    # images' chunks (the last image's and the rank count's stay)
    for mod, name in ((place, "CHUNK_KEYS"), (freeze, "IMAGE_CHUNK")):
        monkeypatch.setattr(mod, name, getattr(mod, name) * n // BUDGET_KEYS)
    for kind, pay_bits in (("pair", 30), ("u64", 30), ("clustered", 40)):
        idx = _index(kind, "pgm", 0.01, pay_bits, n=n, seed=6,
                     device="cuda")
        assert delta.freezes_on_device(idx, "cuda")
        host = delta.freeze_state(idx, "cpu")   # the host path
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = delta.device_freezes
        idx.refreeze()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        held = torch.cuda.memory_allocated() - base
        assert delta.device_freezes == before + 1
        assert idx.stats["freeze_device"] == "cuda"
        assert 0 < peak <= held + TAIL_BUDGET, (kind, peak, held)
        assert held >= idx._engine.arrays.nbytes()
        _assert_freeze_equal(host, (idx._engine, idx._mirror), "cuda")
        slot_key = torch.from_numpy(np.ascontiguousarray(
            idx.gapped.slot_key)).cuda()
        _assert_bounds_equal(idx, slot_key)
        del idx, host, slot_key
