"""The port's ``batched_lookup`` and ``QueryEngine`` on the CPU against
the reference's ``batched_lookup(backend="fused-pallas",
interpret=True)`` / its ``QueryEngine`` on the Pallas kernel in
interpret mode, and against ``GappedArray.lookup_batch``.  Payloads,
slots and found are bit-identical (no tolerance).  The cases are those
of tests/test_fused_lookup.py."""

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
    got = ops.batched_lookup(arrs, plm.err_lo, q, backend="fused",
                             err_hi_by_seg=plm.err_hi)
    _assert_same(got, want, "fused")
    host = port.gapped.lookup_batch(q, full=True)
    assert np.array_equal(got[0], host[0])
    assert np.array_equal(got[2], host[2])
    oracle = ops.batched_lookup(arrs, plm.err_lo, q, backend="oracle")
    _assert_same(oracle, want, "oracle")
    # sorted fast path (skips the sort)
    qs = np.sort(q)
    got_s = ops.batched_lookup(arrs, plm.err_lo, qs, backend="fused",
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
    got = ops.batched_lookup(arrs, port.mech.plm.err_lo, q, backend="fused",
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
