"""Window bounds, the radix and rank routers and the tile/window sizing
rules.

numpy copies of ``repro.kernels.ops``' ``query_window_bounds``,
``build_radix_router``, ``build_rank_router``, ``auto_q_tile``,
``_bisect_trips``, ``_flat_width`` and ``_fused_flat_width``;
tests/test_torch_freeze.py holds each equal to the reference's.
``build_radix_router`` reads ``IndexArrays`` tensors back to the host
(its only change).  ``query_window_bounds`` also serves the 64-bit
image (``core.keys64``): over ordered keys it routes, predicts and
spans segments with the kernel's exact arithmetic
(``keys64.exact_dx``); ``build_radix_router_u64`` is that image's
router.
"""

from __future__ import annotations

import numpy as np

from ..core import keys64 as _k64
from .freeze import split_key_pair

__all__ = ["query_window_bounds", "build_radix_router",
           "build_radix_router_u64", "build_rank_router", "auto_q_tile"]


def _host(t) -> np.ndarray:
    """f64 host copy of a tensor or array."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


def build_radix_router(arrays, r_size: int = 1 << 14):
    """Approximate radix segment router: ``(table, scale)`` numpy pair.

    One multiply + one table gather replaces the exact segment-routing
    searchsorted (mis-routes near bucket boundaries only shift the
    predicted window, and the kernel's escape flags catch that).  ``scale`` carries kmin as an f32 hi/lo
    pair so wide-key subtraction keeps its relative precision.
    """
    segk = _host(arrays.seg_first_key)
    if arrays.key_wide:
        segk = segk + _host(arrays.seg_first_key_lo)
    finite = segk[np.isfinite(segk)]
    sk = _host(arrays.slot_key)
    if arrays.key_wide:
        sk = sk + _host(arrays.slot_key_lo)
    sk_fin = sk[np.isfinite(sk)]
    kmin = float(finite[0]) if finite.size else 0.0
    kmax = float(sk_fin[-1]) if sk_fin.size else kmin + 1.0
    scale = (r_size - 1) / max(kmax - kmin, 1e-9)
    buckets = kmin + np.arange(r_size, dtype=np.float64) / scale
    table = np.clip(
        np.searchsorted(segk, buckets, side="right") - 1,
        0, segk.shape[0] - 1,
    ).astype(np.int32)
    kmin_hi, kmin_lo = split_key_pair(np.array([kmin]))
    return table, np.array([kmin_hi[0], kmin_lo[0], scale], np.float32)


def build_radix_router_u64(arrays, r_size: int = 1 << 14):
    """``build_radix_router`` of the 64-bit image: ``(table, kmin,
    scale)`` with ``kmin`` the ordered first segment key (int64) and
    ``scale`` float64; a query's bucket is ``clip(exact_dx(q, kmin) *
    scale)``, truncated, as the kernel computes it."""
    segk = arrays.seg_first_key.detach().cpu().numpy()
    sk = arrays.slot_key.detach().cpu().numpy()
    segk = segk[segk != _k64.NO_KEY]
    sk = sk[sk != _k64.NO_KEY]
    kmin = segk[:1] if segk.size else np.zeros(1, np.int64)
    kmax = sk[-1:] if sk.size else kmin
    scale = (r_size - 1) / max(float(_k64.exact_dx(kmax, kmin)[0]), 1e-9)
    buckets = np.arange(r_size, dtype=np.float64) / scale
    table = np.clip(
        np.searchsorted(_k64.exact_dx(segk, kmin[0]), buckets,
                        side="right") - 1,
        0, max(segk.shape[0] - 1, 0)).astype(np.int32)
    return table, kmin.astype(np.int64), np.array([scale], np.float64)


def build_rank_router(slot_key, slot_key_lo=None, r_bits: int = 16,
                      trips_pct: float = 99.0):
    """Bucket -> slot-rank table for the fused XLA search.

    ``table[b]`` is the rank (searchsorted-left) of bucket b's lower key
    boundary in the frozen slot-key array, so a query hashing to bucket
    b has its predecessor slot in ``[table[b] - 1, table[b+1] - 1]`` —
    the whole route/predict/window chain becomes two gathers into one
    (r_size + 1)-entry table.  Returns ``(table, scale, trips, meta)``:
    ``scale`` is the f32 [kmin_hi, kmin_lo, scale] device triple,
    ``trips`` a bisect budget covering the ``trips_pct`` percentile
    bucket occupancy (denser buckets escape through the bracket
    validation in ``_fused_search`` — sound, fallback-only), and
    ``meta`` the f64 (kmin, scale, r_size) used for incremental row
    refreshes (``QueryEngine.refresh_rank_rows``).
    """
    sk = np.asarray(slot_key, np.float64)
    if slot_key_lo is not None and np.asarray(slot_key_lo).size:
        sk = sk + np.asarray(slot_key_lo, np.float64)
    fin = sk[np.isfinite(sk)]
    kmin = float(fin[0]) if fin.size else 0.0
    kmax = float(fin[-1]) if fin.size else kmin + 1.0
    r_size = 1 << r_bits
    scale = r_size / max(kmax - kmin, 1e-9)
    bounds = kmin + np.arange(r_size + 1, dtype=np.float64) / scale
    table = np.searchsorted(sk, bounds, side="left").astype(np.int32)
    # top boundary: include every slot <= kmax (duplicated max keys)
    table[-1] = np.searchsorted(sk, kmax, side="right")
    occ = (table[1:] - table[:-1]).astype(np.float64)
    p = float(np.percentile(occ, trips_pct)) if occ.size else 1.0
    trips = int(max(1, np.ceil(np.log2(p + 3.0)) + 1))
    trips = min(trips, int(np.ceil(np.log2(max(sk.shape[0], 2)))) + 1)
    kmin_hi, kmin_lo = split_key_pair(np.array([kmin]))
    return (table, np.array([kmin_hi[0], kmin_lo[0], scale], np.float32),
            trips, (kmin, scale, r_size))


def query_window_bounds(index, max_widen: float = 32.0, segments=None,
                        base=None):
    """Per-segment error bounds valid for ABSENT queries too.

    The plm's finalized (err_lo, err_hi) only bound present keys; a query
    q between keys can fall outside [y_hat(q)+err_lo, y_hat(q)+err_hi]
    because its predecessor's slot was bounded against a *different*
    y_hat.  For monotone segment lines the exact correction is:

      * pairs (x_i, x_{i+1}) in segment s: q in (x_i, x_{i+1}) has
        pred slot_i and y_hat(q) < y_hat(x_{i+1}), so the lower bound
        needs min(slot_i - y_hat(x_{i+1}));
      * queries in s below its first key (pred = last key of the
        previous segment, slot_p): lower term slot_p - y_hat_s(first
        key), upper term slot_p - y_hat_s(segment start boundary);
      * queries in s above its last key: lower term
        slot_last - y_hat_s(next segment boundary);
      * empty segments: both boundary terms with pred slot_p.

    Windows stay CORRECT without this (escaped queries fall back), just
    larger: this tightens the miss-heavy case.  Segments with negative
    slope (non-monotone line) keep a widened conservative bound.
    ``max_widen`` clamps the per-segment widening: queries landing in
    extreme key gaps (which would force huge static windows) are left to
    the compacted fallback instead — rare by construction, and the clamp
    keeps the common-case window narrow enough for the loop-free flat
    search.  Returns (err_lo_q, err_hi_q) float64 (K,).

    Incremental mode (``segments`` + ``base``): recompute ONLY the given
    segment rows, starting from the plm's finalized bounds for those
    rows and the ``base`` (err_lo, err_hi) arrays for everything else —
    the per-segment terms depend only on that segment's keys and its
    immediate key-order neighbors, so a delta update that touched a few
    segments refreshes in O(touched keys) instead of O(n + K)
    (the ROADMAP "stale-window refresh" item; driven by
    ``Index._refresh_window_bounds``).
    """
    plm = index.mech.plm
    K = int(plm.n_segments)
    slope = np.asarray(plm.slope, np.float64)
    icept = np.asarray(plm.icept, np.float64)
    if _k64.is_u64(index.keys):   # ordered keys, the kernel's arithmetic
        first_key = _k64.seg_first_ordered(plm.seg_first_key)
        x = _k64.to_ordered(index.keys)
        key_dx = _k64.exact_dx

        def predict(v):
            return _k64.predict_ordered(plm, v, first_key)[0]
    else:
        first_key = np.asarray(plm.seg_first_key, np.float64)
        x = np.asarray(index.keys, np.float64)
        predict = index.mech.predict

        def key_dx(a, b):
            return a - b
    n = x.shape[0]
    if segments is None:
        seg_list = np.arange(K)
        err_lo = np.array(plm.err_lo, np.float64).copy()
        err_hi = np.array(plm.err_hi, np.float64).copy()
    else:
        seg_list = np.unique(np.clip(np.asarray(segments, np.int64),
                                     0, K - 1))
        if base is None:
            raise ValueError("incremental refresh needs the base bounds")
        err_lo = np.asarray(base[0], np.float64).copy()
        err_hi = np.asarray(base[1], np.float64).copy()
        # touched rows restart from the plm's finalized bounds (exactly
        # what the full recompute would start them from)
        err_lo[seg_list] = np.asarray(plm.err_lo, np.float64)[seg_list]
        err_hi[seg_list] = np.asarray(plm.err_hi, np.float64)[seg_list]

    # key span per segment via key-boundary bisection (keys below the
    # first boundary clip into segment 0, matching plm.segment_of)
    b_lo_arr = first_key[seg_list]
    has_hi = seg_list + 1 < K    # the last segment has no upper boundary
    b_hi_arr = first_key[np.minimum(seg_list + 1, K - 1)]
    i0_arr = np.where(seg_list == 0, 0,
                      np.searchsorted(x, b_lo_arr, side="left"))
    i1_arr = np.where(has_hi, np.searchsorted(x, b_hi_arr, side="left"),
                      n) - 1

    # slots + predictions only for the involved keys (each segment's
    # span plus its predecessor key)
    if segments is None:
        inv = np.arange(n)
    else:
        spans = [np.arange(max(int(i0_arr[j]) - 1, 0), int(i1_arr[j]) + 1)
                 for j in range(seg_list.shape[0])]
        inv = (np.unique(np.concatenate(spans)) if spans
               else np.zeros(0, np.int64))
    slot_g = np.zeros(n, np.float64)
    y_g = np.zeros(n, np.float64)
    if inv.size:
        if index.gapped is not None:
            slot_g[inv] = (np.searchsorted(index.gapped.slot_key, x[inv],
                                           side="right") - 1)
        else:
            slot_g[inv] = inv
        y_g[inv] = np.asarray(predict(x[inv]), np.float64)

    def yhat_at(s, v):  # segment s's line evaluated at key value v
        return slope[s] * key_dx(v, first_key[s]) + icept[s]

    for j, s in enumerate(seg_list):
        i0, i1 = int(i0_arr[j]), int(i1_arr[j])
        has_keys = i0 <= i1 and i0 < n
        p = i0 - 1  # last key strictly before segment s
        b_lo, b_hi, hi_ok = b_lo_arr[j], b_hi_arr[j], bool(has_hi[j])
        if slope[s] < 0:  # non-monotone line: conservative widening
            span = abs(slope[s]) * (
                float(key_dx(b_hi, b_lo)) if hi_ok else 0.0)
            err_lo[s] -= span
            err_hi[s] += span
            continue
        if has_keys:
            if i1 > i0:  # consecutive-pair terms within the segment
                err_lo[s] = min(err_lo[s],
                                float(np.min(slot_g[i0:i1]
                                             - y_g[i0 + 1:i1 + 1])))
            if p >= 0:
                err_lo[s] = min(err_lo[s], slot_g[p] - y_g[i0])
                err_hi[s] = max(err_hi[s], slot_g[p] - yhat_at(s, b_lo))
            if hi_ok:
                err_lo[s] = min(err_lo[s], slot_g[i1] - yhat_at(s, b_hi))
        elif p >= 0:
            if hi_ok:
                err_lo[s] = min(err_lo[s], slot_g[p] - yhat_at(s, b_hi))
            err_hi[s] = max(err_hi[s], slot_g[p] - yhat_at(s, b_lo))
    if max_widen is not None:
        err_lo[seg_list] = np.maximum(
            err_lo[seg_list],
            np.asarray(plm.err_lo, np.float64)[seg_list] - max_widen)
        err_hi[seg_list] = np.minimum(
            err_hi[seg_list],
            np.asarray(plm.err_hi, np.float64)[seg_list] + max_widen)
    return err_lo, err_hi


def auto_q_tile(n_q: int, n_slots: int, w_tile: int) -> int:
    """Pick q_tile so a sorted-query tile's slot span ~fits the 2*w_tile
    window: span ~= n_slots * q_tile / n_q.  Clamped to [32, 512]."""
    t = max(32, min(512, int(n_q * w_tile / max(n_slots, 1))))
    return 1 << (t.bit_length() - 1)  # floor to a power of two


def _bisect_trips(err_lo: np.ndarray, err_hi: np.ndarray) -> int:
    """Static trip count covering the widest per-segment search window."""
    lo = np.asarray(err_lo, np.float64)
    hi = np.asarray(err_hi, np.float64)
    w = hi - lo
    w = w[np.isfinite(w)]
    widest = float(np.max(w)) if w.size else 0.0
    return int(min(32, max(1, np.ceil(np.log2(widest + 4.0)) + 1)))


def _flat_width(err_lo: np.ndarray, err_hi: np.ndarray) -> int:
    """Power-of-two flat-search width covering the p95 segment window,
    or 0 when typical windows are too wide for the loop-free mode."""
    w = np.asarray(err_hi, np.float64) - np.asarray(err_lo, np.float64)
    w = w[np.isfinite(w)]
    if w.size == 0:
        return 16
    p95 = float(np.percentile(w, 95))
    fw = 1 << max(3, int(np.ceil(np.log2(p95 + 6.0))))
    return fw if fw <= 32 else 0


def _fused_flat_width(err_lo: np.ndarray, err_hi: np.ndarray,
                      cap: int = 256) -> int:
    """Flat-window width for the fused backend (p95 window, pow2).

    The fused path tolerates much wider flat windows than the legacy
    multi-op one (cap 256 vs 32): its window is ONE parallel gather
    whose latency hides behind prefetch, whereas the bisect it replaces
    is a chain of serially-dependent probes — at small/medium batch the
    dependent-load latency, not the compare count, is the bottleneck.
    Beyond ``cap`` (p95 windows wider than the compare budget) returns 0
    and the fused path delegates to the fixed-trip bisect.
    """
    w = np.asarray(err_hi, np.float64) - np.asarray(err_lo, np.float64)
    w = w[np.isfinite(w)]
    if w.size == 0:
        return 16
    p95 = float(np.percentile(w, 95))
    fw = 1 << max(3, int(np.ceil(np.log2(p95 + 6.0))))
    return fw if fw <= cap else 0
