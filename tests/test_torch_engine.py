"""The port's ``batched_lookup`` and ``QueryEngine`` on the CPU against
the reference's ``batched_lookup(backend="fused-pallas",
interpret=True)`` / its ``QueryEngine`` on the Pallas kernel in
interpret mode, and against ``GappedArray.lookup_batch``.  Payloads,
slots and found are bit-identical (no tolerance).  The cases are those
of tests/test_fused_lookup.py.

The reference's graph implementations too: ``batched_lookup(backend=
"fused")`` against the reference's ``"fused"``, and a
``QueryEngine(fused_impl="xla")`` against the reference's default CPU
engine (whose ``fused_impl`` is ``"xla"``) — lookups, stage labels,
fallback counts, placement primitives and fused-ingest ``ok`` /
``reasons``, all exact — alone and under an ``Index``."""

import numpy as np
import pytest

from repro.core import Index as RefIndex
from repro.kernels import batched_lookup as ref_batched_lookup
from repro.kernels import from_learned_index as ref_freeze
from repro.kernels.ops import QueryEngine as RefEngine
from repro.kernels.ops import query_window_bounds as ref_bounds
from repro_torch.core import Index
from repro_torch.kernels import freeze, ops
from repro_torch.kernels.lookup import fused_lookup


def _mixed_queries(rng, keys, extra=(), n_hit=1500, n_miss=400):
    lo, hi = keys[0], keys[-1]
    miss = np.setdiff1d(
        np.round(rng.uniform(lo, hi, 4 * n_miss)), keys)[:n_miss]
    parts = [rng.choice(keys, n_hit), miss,
             [keys[0] - 10.0, keys[-1] + 10.0]]
    parts += [np.asarray(e, np.float64) for e in extra]
    return np.concatenate(parts)


def _both(keys, n_mids=3000, payloads=None, gap_rho=0.15):
    kw = dict(method="pgm", eps=64, gap_rho=gap_rho, payloads=payloads)
    ref = RefIndex.build(keys, **kw)
    port = Index.build(keys, device="cpu", **kw)
    mids = np.setdiff1d(keys[:-1] + np.rint(np.diff(keys) * 0.5),
                        keys)[:n_mids]
    for idx in (ref, port):
        idx.gapped.insert_batch(mids, 7_000_000 + np.arange(len(mids)))
    return ref, port, mids


def _assert_same(got, want, label=""):
    for g, w, f in zip(got[:3], want[:3], ("payloads", "slots", "found")):
        assert np.array_equal(np.asarray(g), np.asarray(w)), (label, f)


@pytest.mark.parametrize("seed,wide", [(0, False), (1, False),
                                       (2, True), (3, True)])
def test_batched_lookup_bit_identical(seed, wide):
    rng = np.random.default_rng(seed)
    span = 2 ** 40 if wide else 2 ** 22
    keys = np.unique(rng.choice(span, 25_000, replace=False)
                     ).astype(np.float64)
    ref, port, mids = _both(keys)
    arrs = freeze.from_learned_index(port, "cpu")
    assert arrs.key_wide == wide and arrs.max_chain > 0
    plm = port.mech.plm
    # every key of the longest chain: hits at max_chain
    off, ck, _ = port.gapped.links.csr()
    s = int(np.argmax(np.diff(off)))
    longest = ck[off[s]:off[s + 1]]
    assert longest.size == port.gapped.links.max_chain
    q = _mixed_queries(rng, keys, extra=[mids[:800], mids[:50] + 1.0,
                                         longest])
    want = ref_batched_lookup(ref_freeze(ref), ref.mech.plm.err_lo, q,
                              backend="fused-pallas",
                              err_hi_by_seg=ref.mech.plm.err_hi,
                              interpret=True)
    got = ops.batched_lookup(arrs, plm.err_lo, q, backend="fused-pallas",
                             err_hi_by_seg=plm.err_hi)
    _assert_same(got, want, "fused")
    host = port.gapped.lookup_batch(q, full=True)
    assert np.array_equal(got[0], host[0])
    assert np.array_equal(got[2], host[2])
    oracle = ops.batched_lookup(arrs, plm.err_lo, q, backend="oracle")
    _assert_same(oracle, want, "oracle")
    # sorted fast path (skips the sort)
    qs = np.sort(q)
    got_s = ops.batched_lookup(arrs, plm.err_lo, qs,
                               backend="fused-pallas",
                               err_hi_by_seg=plm.err_hi, queries_sorted=True)
    want_s = ref_batched_lookup(ref_freeze(ref), ref.mech.plm.err_lo, qs,
                                backend="fused-pallas",
                                err_hi_by_seg=ref.mech.plm.err_hi,
                                interpret=True, queries_sorted=True)
    _assert_same(got_s, want_s, "sorted")


def test_wide_payloads_roundtrip():
    rng = np.random.default_rng(5)
    keys = np.unique(rng.choice(2 ** 22, 12_000, replace=False)
                     ).astype(np.float64)
    pay = (np.int64(3) << 40) + np.arange(keys.size, dtype=np.int64)
    ref, port, _ = _both(keys, n_mids=1500, payloads=pay, gap_rho=0.2)
    for idx in (ref, port):  # chained payloads past i32 too
        idx.gapped.links.chain_payloads[:] = (
            (np.int64(5) << 40) + idx.gapped.links.chain_payloads)
        idx.gapped._invalidate()
    arrs = freeze.from_learned_index(port, "cpu")
    assert arrs.wide
    q = _mixed_queries(rng, keys, n_hit=1000, n_miss=200)
    truth = port.gapped.lookup_batch(q)
    assert truth.max() > np.iinfo(np.int32).max
    got = ops.batched_lookup(arrs, port.mech.plm.err_lo, q,
                             backend="fused-pallas",
                             err_hi_by_seg=port.mech.plm.err_hi)
    want = ref_batched_lookup(ref_freeze(ref), ref.mech.plm.err_lo, q,
                              backend="fused-pallas",
                              err_hi_by_seg=ref.mech.plm.err_hi,
                              interpret=True)
    assert got[0].dtype == np.int64
    assert np.array_equal(got[0], truth)
    _assert_same(got, want)


@pytest.mark.parametrize("wide", [False, True])
def test_query_engine_matches_reference_engine(wide):
    rng = np.random.default_rng(8 + wide)
    span = 2 ** 40 if wide else 2 ** 22
    keys = np.unique(rng.choice(span, 15_000, replace=False)
                     ).astype(np.float64)
    ref, port, mids = _both(keys, n_mids=2000)
    r_eng = RefEngine.from_index(ref, fused_impl="pallas", interpret=True)
    eng = ops.QueryEngine.from_index(port, "cpu")
    assert eng.backend == "fused"
    for n_q in (512, 1000, 2048):
        q = np.concatenate([rng.choice(keys, n_q - 100), mids[:100]])
        want = r_eng.lookup(q)
        got = eng.lookup(q)
        _assert_same(got, want, n_q)
        assert eng.last_stage == r_eng.last_stage
        assert np.array_equal(got[0], port.gapped.lookup_batch(q))
    assert eng.stats["calls"] == 3
    assert eng.stats["buckets"] == {512, 1024, 2048}
    # the CPU run never launched the kernel
    assert fused_lookup.launches == 0


def test_overflow_redispatches_to_oracle_and_boosts_capacity():
    """Window bounds shifted 3000 slots to the right: nearly every query
    escapes, the compaction buffer overflows, the batch re-runs on the
    oracle stage (exact), and the bucket's capacity boost sticks."""
    rng = np.random.default_rng(12)
    keys = np.unique(rng.choice(2 ** 22, 15_000, replace=False)
                     ).astype(np.float64)
    ref, port, _ = _both(keys, n_mids=1000)
    lo, hi = ref_bounds(ref)
    r_eng = RefEngine(ref_freeze(ref), lo + 3000.0, hi + 3000.0,
                      fused_impl="pallas", interpret=True)
    eng = ops.QueryEngine(freeze.from_learned_index(port, "cpu"),
                          lo + 3000.0, hi + 3000.0)
    q = rng.choice(keys, 2048)
    want = r_eng.lookup(q)
    got = eng.lookup(q)
    _assert_same(got, want)
    assert np.array_equal(got[0], port.gapped.lookup_batch(q))
    assert eng.last_stage == r_eng.last_stage == "oracle"
    assert eng.stats["oracle_escapes"] == 1 == r_eng.stats["oracle_escapes"]
    assert eng._cap_boost == r_eng._cap_boost == {2048: 4}


# ---------------------------------------------------------------------------
# the reference's graph implementations: backend="fused", fused_impl="xla"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,wide", [(0, False), (2, True)])
def test_batched_lookup_fused_graph_matches_reference(seed, wide):
    """``backend="fused"`` is the rank-router graph with the host patch
    in both packages: payloads, slots, found and the patched-query count
    equal, with no oracle escape."""
    rng = np.random.default_rng(seed)
    span = 2 ** 40 if wide else 2 ** 22
    keys = np.unique(rng.choice(span, 25_000, replace=False)
                     ).astype(np.float64)
    ref, port, mids = _both(keys)
    arrs = freeze.from_learned_index(port, "cpu")
    q = _mixed_queries(rng, keys, extra=[mids[:800], mids[:50] + 1.0])
    esc0 = ops._ESCAPES.count
    for qq, qs in ((q, False), (np.sort(q), True)):
        want = ref_batched_lookup(ref_freeze(ref), ref.mech.plm.err_lo, qq,
                                  backend="fused",
                                  err_hi_by_seg=ref.mech.plm.err_hi,
                                  queries_sorted=qs)
        got = ops.batched_lookup(arrs, port.mech.plm.err_lo, qq,
                                 backend="fused",
                                 err_hi_by_seg=port.mech.plm.err_hi,
                                 queries_sorted=qs)
        _assert_same(got, want, "fused graph")
        assert got[3] == want[3]
        assert np.array_equal(got[0], port.gapped.lookup_batch(qq))
    assert ops._ESCAPES.count == esc0
    assert fused_lookup.launches == 0
    with pytest.raises(ValueError, match="unknown backend"):
        ops.batched_lookup(arrs, port.mech.plm.err_lo, q, backend="triton")


def _xla_engines(port_idx, ref_idx):
    """The reference's default CPU engine (``fused_impl="xla"``) and the
    port's ``"xla"`` engine over the same headroom freeze."""
    from repro.kernels import ops as ref_ops
    from repro_torch.kernels import delta
    r_eng, _ = ref_ops.freeze_state(ref_idx)
    assert r_eng.fused_impl == "xla"
    eng, _ = delta.freeze_state(port_idx, "cpu", fused_impl="xla")
    return r_eng, eng


@pytest.mark.parametrize("wide", [False, True])
def test_xla_engine_lookups_match_reference_default_engine(wide):
    rng = np.random.default_rng(20 + wide)
    span = 2 ** 40 if wide else 2 ** 22
    keys = np.unique(rng.choice(span, 15_000, replace=False)
                     ).astype(np.float64)
    ref, port, mids = _both(keys, n_mids=2000)
    r_eng, eng = _xla_engines(port, ref)
    assert eng.fused_impl == "xla"
    for n_q in (300, 1000, 2048, 5000):
        q = np.concatenate([rng.choice(keys, n_q - 100), mids[:100]])
        for backend in (None, "oracle"):
            want = r_eng.lookup(q, backend=backend)
            got = eng.lookup(q, backend=backend)
            _assert_same(got, want, (n_q, backend))
            assert int(got[3]) == int(want[3])
            assert eng.last_stage == r_eng.last_stage
            assert np.array_equal(got[0], port.gapped.lookup_batch(q))
    for f in ("calls", "fallbacks", "oracle_escapes", "buckets"):
        assert eng.stats[f] == r_eng.stats[f], f
    assert fused_lookup.launches == 0


def test_fused_impl_is_checked_and_defaults_to_the_kernel():
    keys = np.arange(0, 40_000, 4, dtype=np.float64)
    port = Index.build(keys, method="pgm", eps=64, gap_rho=0.15,
                       device="cpu")
    assert ops.QueryEngine.from_index(port, "cpu").fused_impl == "kernel"
    assert port.sync_device().fused_impl == "kernel"
    with pytest.raises(ValueError, match="fused_impl"):
        ops.QueryEngine.from_index(port, "cpu", fused_impl="pallas")
    from repro_torch.kernels import ops_gap
    with pytest.raises(ValueError, match="impl"):
        ops_gap.ingest_place(port.sync_device().arrays, keys[:4] + 1.0,
                             impl="triton")


@pytest.fixture
def xla_freeze(monkeypatch):
    """Every refreeze of a port ``Index`` builds a ``fused_impl="xla"``
    engine (the handle freezes through ``delta.freeze_state``)."""
    import functools

    from repro_torch.kernels import delta
    monkeypatch.setattr(delta, "freeze_state", functools.partial(
        delta.freeze_state, fused_impl="xla"))


@pytest.mark.parametrize("span,seed", [(2 ** 22, 3), (2 ** 40, 5)],
                         ids=["narrow", "wide"])
def test_xla_engine_placement_and_fused_ingest_match_reference(
        span, seed, xla_freeze):
    """Placement primitives and escapes, then one fused ingest on each
    default CPU engine: ``ok``, ``reasons`` and every gated output as
    ``test_torch_ingest._fused_outputs_equal`` holds them (exact, but
    for the one FMA of the window-bound residual it names), for an
    accepted batch and a vetoed one.  No kernel launches."""
    from repro_torch.kernels.gap_place import ingest_place as place_kernel
    from test_torch_ingest import _both as _both_w
    from test_torch_ingest import _fused_outputs_equal, _spread
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.choice(span, 25_000, replace=False)
                     ).astype(np.float64)
    ref, port = _both_w(keys, True, gap_rho=0.2)
    assert port._engine.fused_impl == "xla"
    batch = _spread(keys, 3_000)
    rp, re = ref._engine.ingest_place(batch)
    pp, pe = port._engine.ingest_place(batch)
    assert np.array_equal(re, pe)
    for f in rp:
        assert np.array_equal(rp[f], pp[f]), f
    ok, reasons = _fused_outputs_equal(ref, port, batch,
                                       1_000_000 + np.arange(batch.size))
    assert ok and reasons == 0
    crowded = np.setdiff1d(np.floor(keys[100] + np.arange(700) * 0.25),
                           keys)[:512]
    ok, reasons = _fused_outputs_equal(ref, port, crowded,
                                       np.arange(crowded.size))
    assert not ok and reasons  # a veto (the same bits on both sides)
    assert place_kernel.launches == 0


@pytest.mark.parametrize("fused", [None, True], ids=["two_dispatch",
                                                      "fused"])
def test_index_over_xla_engine_matches_reference(fused, xla_freeze):
    """An ``Index`` whose engine is ``fused_impl="xla"`` ingests and
    looks up like the reference's CPU ``Index``: reports, states,
    epochs, stats and lookups with their stage labels, all equal."""
    from test_torch_ingest import _both as _both_w
    from test_torch_ingest import (_lookups_equal, _report, _spread,
                                   _state_equal, _stats)
    rng = np.random.default_rng(31)
    allk = np.unique(rng.choice(2 ** 40, 30_000, replace=False)
                     ).astype(np.float64)
    perm = rng.permutation(allk.size)
    init, held = np.sort(allk[perm[:22_000]]), allk[perm[22_000:]]
    ref, port = _both_w(init, fused, gap_rho=0.2)
    assert port._engine.fused_impl == "xla"
    batches = [_spread(init, 2_000), held[:4096], held[4096:4608]]
    labels = set()
    for step, batch in enumerate(batches):
        pay = 1_000_000 * (step + 1) + np.arange(batch.size)
        r1, r2 = ref.ingest(batch, pay), port.ingest(batch, pay)
        assert _report(r1) == _report(r2)
        labels.add(r2.device)
        if step == 0:
            dk = rng.choice(init, 500, replace=False)
            assert ref.remove(dk) == port.remove(dk)
        assert ref.epoch == port.epoch
        assert _state_equal(ref.gapped, port.gapped)
        q = np.concatenate([rng.choice(init, 3000), batch,
                            np.floor(rng.uniform(init[0], init[-1], 500))])
        _lookups_equal(ref, port, q)
        assert port._engine.fused_impl == "xla"
    assert _stats(ref) == _stats(port)
    assert ("fused" in labels) == bool(fused)
