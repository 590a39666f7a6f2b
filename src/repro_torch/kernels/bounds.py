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

The freeze of a CUDA index takes its passes over every key and slot to
the card, with results equal bit for bit: ``query_window_bounds_device``
is the full recompute of ``query_window_bounds`` in torch ops.  The
routers read the slot images where they are: ``build_rank_router``
counts on the images' device, the radix routers read the segment first
keys and one slot key.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import keys64 as _k64
from ..spans import span
from . import place as _place
from .freeze import split_key_pair
from .lookup import exact_dx as _exact_dx_t

__all__ = ["query_window_bounds", "query_window_bounds_device",
           "build_radix_router", "build_radix_router_u64",
           "build_rank_router", "auto_q_tile"]

_I64_MIN = np.iinfo(np.int64).min
RANK_CHUNK = 1 << 14   # slot keys a rank count reads at once (128 KB)


def _host(t) -> np.ndarray:
    """f64 host copy of a tensor or array."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


def _last_slot(arrays) -> int:
    """Position of the last slot that holds a key (-1 if none): the slot
    image is sorted, its key-less slots (+inf, or ``NO_KEY`` on the
    64-bit image) last, so one search on the device finds it."""
    sk = arrays.slot_key
    end = sk.new_full((1,), _k64.NO_KEY if arrays.key_u64 else np.inf)
    return int(torch.searchsorted(sk, end)) - 1


def _slot_f64(arrays, i: int) -> float:
    """The float64 key of slot ``i`` of a float image (``hi + lo``)."""
    v = arrays.slot_key[i:i + 1].double()
    if arrays.key_wide:
        v = v + arrays.slot_key_lo[i:i + 1].double()
    return float(v)


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
    kmin = float(finite[0]) if finite.size else 0.0
    last = _last_slot(arrays)
    kmax = _slot_f64(arrays, last) if last >= 0 else kmin + 1.0
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
    segk = segk[segk != _k64.NO_KEY]
    kmin = segk[:1] if segk.size else np.zeros(1, np.int64)
    last = _last_slot(arrays)
    kmax = (arrays.slot_key[last:last + 1].cpu().numpy() if last >= 0
            else kmin)
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

    The images may be tensors, searched on their device, or arrays.
    The keys ``hi + lo`` are sorted, their finite run where ``hi`` is
    finite, so two searches of ``hi`` find ``kmin`` and ``kmax``, and a
    boundary's rank is the count of keys below it, summed over chunks
    of ``RANK_CHUNK`` keys of that run: nothing is read back but the
    table, and the device holds under 1 MB beyond it.
    """
    hi = _tensor(slot_key)
    lo = (_tensor(slot_key_lo) if slot_key_lo is not None
          and len(slot_key_lo) else None)

    def keys(a, b):   # float64 keys of slots [a, b)
        v = hi[a:b].to(torch.float64, copy=True)
        return v if lo is None else v.add_(lo[a:b])

    first = int(torch.searchsorted(hi, hi.new_tensor([-np.inf]),
                                   right=True))
    end = int(torch.searchsorted(hi, hi.new_tensor([np.inf])))
    if end > first:
        kmin, kmax = float(keys(first, first + 1)), float(keys(end - 1, end))
    else:
        kmin, kmax = 0.0, 1.0
    r_size = 1 << r_bits
    scale = r_size / max(kmax - kmin, 1e-9)
    bounds = kmin + np.arange(r_size, dtype=np.float64) / scale
    bd = torch.from_numpy(bounds).to(hi.device)
    table = torch.full((r_size,), first, dtype=torch.int32,
                       device=hi.device)
    rank = torch.empty_like(table)
    for a in range(first, end, RANK_CHUNK):
        torch.searchsorted(keys(a, min(a + RANK_CHUNK, end)), bd,
                           out_int32=True, out=rank)
        table += rank
    # top boundary: include every slot <= kmax (duplicated max keys)
    table = np.append(table.cpu().numpy(), np.int32(end))
    occ = (table[1:] - table[:-1]).astype(np.float64)
    p = float(np.percentile(occ, trips_pct)) if occ.size else 1.0
    trips = int(max(1, np.ceil(np.log2(p + 3.0)) + 1))
    trips = min(trips, int(np.ceil(np.log2(max(hi.shape[0], 2)))) + 1)
    kmin_hi, kmin_lo = split_key_pair(np.array([kmin]))
    return (table, np.array([kmin_hi[0], kmin_lo[0], scale], np.float32),
            trips, (kmin, scale, r_size))


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.require(a, requirements=("C", "W")))


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


def query_window_bounds_device(index, slot_key: torch.Tensor,
                               max_widen: float = 32.0, stages=None):
    """``query_window_bounds(index)``, the full recompute, with its
    passes over the keys on ``slot_key``'s device: the same float64
    ``(err_lo, err_hi)``, bit for bit, on the host.

    ``slot_key`` is the gapped array's slot keys (float64, or ordered
    int64 for 64-bit keys) on the device; the index's mechanism predicts
    through its PLM (``place.PLM_METHODS``).  Keys stream in chunks of
    ``place.CHUNK_KEYS``: a key's slot is ``searchsorted(slot_key, x,
    right) - 1`` and its prediction ``place.route_predict``'s, the
    host's arithmetic op for op.  Slots rise with the keys, so per
    segment the last key's slot is the segment's largest, and the slot
    of the key before a segment (``p`` in ``query_window_bounds``) is
    the largest slot of the segments before it.  The pair terms carry
    one key across chunks; every term is a ``scatter_reduce`` min or max
    over segment ids (no term is -0.0, so the order of the minima leaves
    their bits as the host's are).  The negative-slope widening and
    the clamp run on the host over the K rows.  ``stages`` gains the
    keys' copies as ``upload`` and the rest as ``bounds``."""
    plm = index.mech.plm
    K = int(plm.n_segments)
    dev = slot_key.device
    u64 = _k64.is_u64(index.keys)
    # uint64 keys go up as int64 and are ordered (top bit flipped) there
    x = (index.keys.view(np.int64) if u64
         else np.asarray(index.keys, np.float64))
    f64, i64 = torch.float64, torch.int64
    with span("freeze.bounds", stages):
        first, slope, icept = _place.plm_tables(plm, dev, u64)
        inf = torch.full((K,), np.inf, dtype=f64, device=dev)
        pair_lo = inf.clone()
        y_first = inf.clone()
        last = torch.full((K,), _I64_MIN, dtype=i64, device=dev)
        has = torch.zeros(K, dtype=torch.bool, device=dev)
        carry_seg = torch.full((1,), -1, dtype=i64, device=dev)
        carry_slot = torch.zeros(1, dtype=i64, device=dev)
    step = _place.CHUNK_KEYS
    for a in range(0, x.shape[0], step):
        with span("freeze.upload", stages):
            xd = torch.from_numpy(np.ascontiguousarray(x[a:a + step])
                                  ).to(dev)
        with span("freeze.bounds", stages):
            if u64:   # not in place: on the host, xd is the keys' memory
                xd = xd ^ int(_I64_MIN)
            slot = torch.searchsorted(slot_key, xd, right=True).sub_(1)
            y, seg = _place.route_predict(xd, first, slope, icept)
            del xd
            same = seg == torch.cat([carry_seg, seg[:-1]])
            # consecutive pairs inside a segment: slot_i - y_hat(x_i+1)
            # (masks by where, not by indexing: no sync with the host)
            term = torch.cat([carry_slot, slot[:-1]]).double().sub_(y)
            pair_lo.scatter_reduce_(0, seg, term.masked_fill_(~same, np.inf),
                                    "amin")
            # a segment's first key is the one key starting it
            y_first.scatter_reduce_(0, seg, y.masked_fill_(same, np.inf),
                                    "amin")
            has[seg] = True
            last.scatter_reduce_(0, seg, slot, "amax")
            carry_seg, carry_slot = seg[-1:].clone(), slot[-1:].clone()
            del y, seg, slot, same, term
    with span("freeze.bounds", stages):
        s = torch.arange(K, device=dev)
        has_hi = s + 1 < K
        nxt = first[(s + 1).clamp_(max=K - 1)]
        dx = _exact_dx_t if u64 else torch.sub
        y_lo = slope * dx(first, first) + icept   # the line at b_lo
        y_hi = slope * dx(nxt, first) + icept     # ... at b_hi
        # the slot of the last key before each segment, where one is
        incl = _place._running_max(last, int(_I64_MIN))
        p_slot = torch.cat([incl.new_full((1,), _I64_MIN),
                            incl[:-1]]).double()
        has_p = (torch.cumsum(has, 0) - has.long()) > 0
        last_d = last.double()
        t_lo = pair_lo
        for mask, term in ((has & has_p, p_slot - y_first),
                           (has & has_hi, last_d - y_hi),
                           (~has & has_p & has_hi, p_slot - y_hi)):
            t_lo = torch.minimum(t_lo, torch.where(mask, term, inf))
        t_hi = torch.where(has_p, p_slot - y_lo, -inf)
        t_lo, t_hi = t_lo.cpu().numpy(), t_hi.cpu().numpy()

        slope_h = np.asarray(plm.slope, np.float64)
        if u64:
            first_h = _k64.seg_first_ordered(plm.seg_first_key)
            dx_h = _k64.exact_dx
        else:
            first_h = np.asarray(plm.seg_first_key, np.float64)
            dx_h = np.subtract
        b_hi = first_h[np.minimum(np.arange(K) + 1, K - 1)]
        widen = np.abs(slope_h) * np.where(np.arange(K) + 1 < K,
                                           dx_h(b_hi, first_h), 0.0)
        err_lo = np.array(plm.err_lo, np.float64)
        err_hi = np.array(plm.err_hi, np.float64)
        neg = slope_h < 0   # non-monotone line: conservative widening
        err_lo = np.where(neg, err_lo - widen,
                          np.where(t_lo < err_lo, t_lo, err_lo))
        err_hi = np.where(neg, err_hi + widen,
                          np.where(t_hi > err_hi, t_hi, err_hi))
        if max_widen is not None:
            err_lo = np.maximum(
                err_lo, np.asarray(plm.err_lo, np.float64) - max_widen)
            err_hi = np.minimum(
                err_hi, np.asarray(plm.err_hi, np.float64) + max_widen)
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
