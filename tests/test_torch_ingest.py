"""The write slice as a whole: the same batches through the reference's
``Index`` and the port's ``Index`` (both on the CPU) give equal
``IngestReport``s, ``GappedArray`` states, epochs, stats and lookups;
the fused single-dispatch ingest gives the reference's ``reasons``
bitmask and every gated output, array for array; and a reference index
that has been written to, carried across with
``convert.index_from_state``, takes further writes identically.

Inputs are made with numpy from a seed and handed to both packages.
All comparisons are exact.
"""

import numpy as np
import pytest

from repro.core import Index as RefIndex
from repro_torch import convert
from repro_torch.core import Index
from test_torch_index import _ref_state


def _state_equal(g1, g2):
    return (np.array_equal(g1.slot_key, g2.slot_key)
            and np.array_equal(g1.occupied, g2.occupied)
            and np.array_equal(g1.payload, g2.payload)
            and g1.n_keys == g2.n_keys
            and all(np.array_equal(a, b) for a, b in
                    zip(g1.export_csr_links(), g2.export_csr_links())))


def _report(rep):
    d = dict(vars(rep))
    del d["seconds"]
    return d


def _stats(idx):
    return {k: v for k, v in idx.stats.items()
            if k not in ("retrains", "freeze_seconds", "freeze_stages",
                         "freeze_device")}


def _both(keys, fused, **kw):
    kw = dict(dict(method="pgm", eps=64, gap_rho=0.15), **kw)
    ref = RefIndex.build(keys, rng=np.random.default_rng(1), **kw)
    port = Index.build(keys, rng=np.random.default_rng(1), device="cpu",
                       **kw)
    for idx in (ref, port):
        idx.fused_ingest_enabled = fused
        idx.sync_device()
    return ref, port


def _lookups_equal(ref, port, q):
    a, b = ref.lookup(q), port.lookup(q)
    assert a.backend == b.backend
    assert np.array_equal(a.payloads, b.payloads)
    assert np.array_equal(a.slots, b.slots)
    assert np.array_equal(a.found, b.found)
    assert np.array_equal(b.payloads, port.gapped.lookup_batch(q))


def _spread(keys, n):
    mids = np.setdiff1d(keys[:-1] + np.rint(np.diff(keys) * 0.5), keys)
    return mids[:: max(1, len(mids) // n)][:n]


@pytest.mark.parametrize("span", [2 ** 22, 2 ** 40],
                         ids=["narrow", "wide"])
def test_write_sequence_matches_reference(span):
    """Mixed ingest / remove / update / scalar batches on the CPU
    default (two-dispatch: device placements + delta sync)."""
    rng = np.random.default_rng(11)
    allk = np.unique(rng.choice(span, 33_000, replace=False)
                     ).astype(np.float64)
    perm = rng.permutation(allk.size)
    init, held = np.sort(allk[perm[:23_000]]), allk[perm[23_000:]]
    ref, port = _both(init, None)
    assert port.fused_ingest_enabled is None  # cpu engine: fused off
    labels = set()
    pos = 0
    for step, n in enumerate([4096, 512, 2048, 1024, 600, 100]):
        batch = held[pos:pos + n]
        pay = 1_000_000 + pos + np.arange(n)
        pos += n
        r1, r2 = ref.ingest(batch, pay), port.ingest(batch, pay)
        assert _report(r1) == _report(r2)
        labels.add((r2.device, r2.placement))
        if step == 1:
            dk = rng.choice(init, 700, replace=False)
            assert ref.remove(dk) == port.remove(dk)
            uk = rng.choice(np.setdiff1d(init, dk), 500, replace=False)
            up = 5 + np.arange(500)
            assert ref.update_batch(uk, up) == port.update_batch(uk, up)
        if step == 3:
            k = float(held[-1])
            assert ref.insert(k, 77) == port.insert(k, 77)
            assert ref.delete(float(init[3])) == port.delete(float(init[3]))
            assert ref.update(float(init[4]), 9) == port.update(
                float(init[4]), 9)
            dk = init[10:40]
            assert ref.delete_batch(dk) == port.delete_batch(dk)
        assert ref.epoch == port.epoch
        assert _state_equal(ref.gapped, port.gapped)
        q = np.concatenate([rng.choice(init, 2000), batch,
                            np.floor(rng.uniform(init[0], init[-1], 500)),
                            [init[0] - 3.0, init[-1] + 3.0]])
        _lookups_equal(ref, port, q)
        assert ref.device_epoch == port.device_epoch
    assert _stats(ref) == _stats(port)
    # the batches covered the device placement, the host fallback (a
    # batch under min_device_batch) and both device follow-ups
    assert ("delta", "device") in labels and ("delta", "host") in labels
    assert any(d == "refreeze" for d, _ in labels)
    # the engines' write-side mirrors agree too
    re, pe = ref._engine, port._engine
    assert np.array_equal(re.err_lo, pe.err_lo)
    assert np.array_equal(re.err_hi, pe.err_hi)
    assert np.array_equal(re._rank_np, pe._rank_np)


# ---------------------------------------------------------------------------
# the fused single-dispatch ingest
# ---------------------------------------------------------------------------


def _fused_outputs_equal(ref, port, keys, pays):
    """One fused ingest on each engine (the reference's
    ``_fused_ingest_xla`` with use_pallas=False): primitives, escape,
    ok, reasons and every gated output equal, array for array.

    One stated exception, the window-bound residual ``dlt = p - y1``
    with ``y1 = slope * (x - seg_key) + icept`` (reference
    gap_place.py:585-587): XLA on the CPU contracts it into an FMA,
    torch (and the card) rounds the product and the sum separately.  So
    the port's ``dlt`` is held exactly to a numpy evaluation with
    separate roundings, and to the reference's within one f32 spacing
    of ``y1`` (|y1| <= n_slots); the bounds ``elo``/``ehi`` it widens are
    held exactly to the port's own ``dlt`` and within the same spacing
    of the reference's.
    """
    rp, re, rok, rreasons, rst = ref._engine.fused_ingest(keys, pays)
    eng = port._engine
    elo0, ehi0 = eng._elo.clone().numpy(), eng._ehi.clone().numpy()
    pp, pe, pok, preasons, pst = eng.fused_ingest(keys, pays)
    assert (rok, rreasons) == (pok, preasons)
    assert np.array_equal(re, pe)
    for f in rp:
        assert np.array_equal(rp[f], pp[f]), f
    assert rst.keys() == pst.keys()
    host = {f: (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
            for f, v in pst.items()}
    for f in rst:
        a, b = np.asarray(rst[f]), host[f]
        assert a.dtype == b.dtype or a.ndim == 0, f
        if f not in ("dlt", "elo", "ehi"):
            assert np.array_equal(a, b), f
    a = eng.arrays
    tol = np.spacing(np.float32(a.n_slots))
    seg = host["seg"].astype(np.int64)
    x = np.asarray(keys, np.float32)
    y1 = a.seg_slope.numpy()[seg] * (x - a.seg_first_key.numpy()[seg])
    y1 = y1 + a.seg_icept.numpy()[seg]
    assert np.array_equal(host["dlt"], pp["p"].astype(np.float32) - y1)
    assert np.abs(np.asarray(rst["dlt"]) - host["dlt"]).max() <= tol
    if pok:
        cand = pp["free"] & pp["bracket"]
        np.minimum.at(elo0, seg[cand], host["dlt"][cand] - np.float32(1))
        np.maximum.at(ehi0, seg[cand], host["dlt"][cand] + np.float32(1))
    for f, want in (("elo", elo0), ("ehi", ehi0)):
        assert np.array_equal(host[f], want), f
        assert np.abs(np.asarray(rst[f]) - host[f]).max() <= tol, f
    return pok, preasons


def _fused_case(ref, port, keys, pays, expect_ok):
    ok, reasons = _fused_outputs_equal(ref, port, keys, pays)
    assert ok == expect_ok
    r1, r2 = ref.ingest(keys, pays), port.ingest(keys, pays)
    assert _report(r1) == _report(r2)
    assert _state_equal(ref.gapped, port.gapped)
    assert _stats(ref) == _stats(port)
    return r2, reasons


@pytest.mark.parametrize("span,seed", [(2 ** 22, 3), (2 ** 40, 5)],
                         ids=["narrow", "wide"])
def test_fused_accepted_then_split_commit(span, seed):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.choice(span, 25_000, replace=False)
                     ).astype(np.float64)
    ref, port = _both(keys, True, gap_rho=0.2)
    batch = _spread(keys, 3_000)              # closure-trivial
    pays = 1_000_000 + np.arange(batch.size)
    rep, reasons = _fused_case(ref, port, batch, pays, True)
    assert rep.device == "fused" and reasons == 0 and rep.chain > 0
    q = np.concatenate([batch, rng.choice(keys, 2000)])
    _lookups_equal(ref, port, q)
    # a clean batch whose last row collides with its last slot
    # candidate: the gate vetoes the batch (collision group), the
    # prefix before that candidate commits in-graph and the two rows
    # after it replay on the host
    live = np.sort(np.concatenate([keys, batch]))
    clean = np.setdiff1d(live[:-1] + np.rint(np.diff(live) * 0.3), live)
    clean = clean[:: len(clean) // 2048][:2048]
    prims, _esc = port._engine.ingest_place(clean)
    j = np.flatnonzero(prims["free"] & prims["bracket"])[-1]
    assert j > clean.size * 7 // 8 and clean[j] + 1.0 not in live
    batch2 = np.concatenate([clean, [clean[j] + 1.0]])
    pays2 = 2_000_000 + np.arange(batch2.size)
    rep2, reasons2 = _fused_case(ref, port, batch2, pays2, False)
    assert reasons2 & 4  # collision_group
    assert rep2.placement == "device-split"
    assert rep2.device == "fused+delta"
    assert port.stats["split_commits"] == 1
    _lookups_equal(ref, port, np.concatenate([batch2, q]))


def test_fused_collision_abort_and_duplicates():
    init = np.arange(0, 1_000_000, 100, dtype=np.float64)
    ref, port = _both(init, True, eps=32, gap_rho=0.2)
    batch = np.setdiff1d(np.arange(50_001, 50_001 + 620, dtype=np.float64),
                         init)[:512]          # crowded: collision groups
    pays = 3_000_000 + np.arange(batch.size)
    rep, reasons = _fused_case(ref, port, batch, pays, False)
    assert reasons & 4  # collision_group
    assert rep.device != "fused" and "collision_group" in rep.abort_reasons
    # an in-batch duplicate aborts in-graph and the host replay raises
    # the same KeyError on both sides
    dup = np.concatenate([_spread(init, 600), [150.0, 150.0]])
    ok, reasons = _fused_outputs_equal(ref, port, dup,
                                       np.arange(dup.size))
    assert not ok and reasons & 2  # dup_batch
    for idx in (ref, port):
        with pytest.raises(KeyError):
            idx.ingest(dup, np.arange(dup.size))
    assert _state_equal(ref.gapped, port.gapped)
    assert _stats(ref) == _stats(port)


def test_fused_abort_on_link_headroom_overflow():
    keys = np.arange(0, 24_000, 2, dtype=np.float64)
    ref, port = _both(keys, True, gap_rho=0.01)
    assert int(port._engine.arrays.link_keys.shape[0]) <= 128
    batch = _spread(keys, 1_024)              # chain demand beyond cap
    pays = 4_000_000 + np.arange(batch.size)
    rep, reasons = _fused_case(ref, port, batch, pays, False)
    assert reasons & (128 | 256)  # chain_overflow / link_overflow
    assert rep.device == "refreeze"
    _lookups_equal(ref, port, np.concatenate([batch, keys[::3]]))


def test_written_reference_index_carries_across():
    """A reference index after ingests, converted, then written on both
    sides: equal reports, states and lookups."""
    rng = np.random.default_rng(23)
    allk = np.unique(rng.choice(2 ** 40, 30_000, replace=False)
                     ).astype(np.float64)
    perm = rng.permutation(allk.size)
    init, held = np.sort(allk[perm[:22_000]]), allk[perm[22_000:]]
    ref = RefIndex.build(init, method="pgm", eps=64, gap_rho=0.15,
                         sample_rate=0.05, rng=np.random.default_rng(3))
    ref.ingest(held[:3000], 9_000_000 + np.arange(3000))
    ref.remove(init[::50])
    state, meta = _ref_state(ref)
    port = convert.index_from_state(state, meta, device="cpu")
    assert port.epoch == ref.epoch > 0
    ref.sync_device()
    port.sync_device()
    for lo, hi in ((3000, 7096), (7096, 8000)):
        b = held[lo:hi]
        r1 = ref.ingest(b, lo + np.arange(b.size))
        r2 = port.ingest(b, lo + np.arange(b.size))
        assert _report(r1) == _report(r2)
        assert _state_equal(ref.gapped, port.gapped)
        _lookups_equal(ref, port, np.concatenate([b, init[::7]]))
