"""Lookup engine: the torch code around the CUDA lookup kernels.

Counterpart of the ``"fused-pallas"``, ``"pallas"``, ``"xla"`` and
``"oracle"`` stages of ``repro.kernels.ops._pipeline``, of
``_route_segment``, ``_xla_window_lookup``, ``_compact_fallback``,
``_fused_fixup`` and ``batched_lookup``, and of ``QueryEngine`` (its
lookup side, and its write side: delta swaps, bound and rank-row
refreshes, ingest placement and the fused ingest).  ``pipeline`` names
the reference's ``"fused-pallas"`` stage ``"fused"``; the entry points
take the reference's names (``batched_lookup``'s five backends, the
engine's ``fused_impl``).  One batch on the kernel stage is:

    sort -> radix route + window base per query -> tile schedule
    (``tile_block``) -> ONE launch of the fused kernel -> fixup of the
    escaped queries by the full-array oracle -> unsort

The legacy stages, requested explicitly (the handle's ``"pallas"`` and
``"xla-windowed"`` backends):

* ``"pallas"`` (narrow keys only): sort -> ``predict_ref`` tile
  schedule -> ONE launch of the legacy kernel (``lookup_kernel``) ->
  compacted fallback -> epilogue -> unsort;
* ``"xla"``: per-query window from the error bounds -> flat rank count
  or fixed-trip bisect -> compacted fallback -> epilogue, in torch ops.

Each re-resolves only the queries its search flagged, in a buffer of at
most ``fb_cap`` queries; when more escape, the batch is overflowed and
the caller re-runs it on the oracle stage (counted in ``stats``, with a
sticky per-bucket capacity boost in the engine).

The reference's fused-XLA graph is here too, in torch ops: the
rank-router search ``fused_search`` (two gathers into the bucket ->
slot-rank table of ``bounds.build_rank_router``, a fixed-trip bisect,
the bracket validation that flags escapes), ``fused_pipeline`` (the
search and the epilogue) and the host patch of the flagged queries
(``host_fallback_views``, ``resolve_escapes_host``,
``finish_fused_host``).  ``batched_lookup(backend="fused")`` runs it,
as the reference's does; so does the engine's ``"fused"`` stage under
``QueryEngine(fused_impl="xla")``, and the shard fan-out
(``shard_fanout.py``) over stacked shard images.

The 64-bit image (``IndexArrays.key_u64``, ``core.keys64``) is served by
``QueryEngine`` on two stages: ``"fused"`` (one launch of
``lookup.fused_lookup_u64``, ``fused_args_u64``) and ``"oracle"``; its
queries are ordered int64, sorted with one int64 sort, and the fixup and
the oracle are the narrow-key ones, whose compares and
``torch.searchsorted`` are exact on int64.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..spans import span
from .bounds import (_bisect_trips, _flat_width, _fused_flat_width,
                     auto_q_tile, build_radix_router, build_radix_router_u64,
                     build_rank_router, query_window_bounds)
from .freeze import IndexArrays, _pad_pow, split_key_pair
from .lookup import (NO_KEY, _clip, _slot_clip_hi, fused_lookup,
                     fused_lookup_u64, lookup_kernel, route_segment,
                     window_line_u64)
from .ref import (_bisect, _pair_bisect, _peq, _ple, _take, epilogue,
                  epilogue_parts, oracle_search, predict_ref)

__all__ = ["QueryEngine", "batched_lookup", "BACKENDS", "FUSED_IMPLS",
           "FB_FRAC", "fused_search",
           "fused_pipeline", "host_fallback_views", "resolve_escapes_host",
           "finish_fused_host"]

FB_FRAC = 0.02  # compaction buffer sizing: ~2% of the batch
_NO_F32 = np.zeros(0, np.float32)
U64_STAGES = ("fused", "oracle")   # the stages of the 64-bit image


def split_queries(queries, key_wide: bool):
    """Host-side query split matching the frozen key representation."""
    q64 = np.asarray(queries, np.float64)
    if key_wide:
        return split_key_pair(q64)
    return q64.astype(np.float32), _NO_F32


def recombine_i64(out, out_hi, n_q: int, wide: bool) -> np.ndarray:
    """(lo, hi) i32 pair tensors -> host int64 payloads."""
    lo = out[:n_q].cpu().numpy().astype(np.int64)
    if not wide:
        return lo
    hi = out_hi[:n_q].cpu().numpy().astype(np.int64)
    return (hi << 32) | (lo & 0xFFFFFFFF)


def tile_schedule(qs, qls, a: IndexArrays, icept_fold, radix_table,
                  radix_scale, *, q_tile: int, w_tile: int):
    """Per-tile window block: the lowest window base among the tile's
    sorted queries, quantized to ``w_tile`` and clipped so the (b, b+1)
    block pair stays inside the padded slot keys."""
    seg = route_segment(qs, qls, radix_table, radix_scale, a.key_wide)
    dx = qs - a.seg_first_key[seg]
    if a.key_wide:
        dx = dx + (qls - a.seg_first_key_lo[seg])
    lo = _clip(a.seg_slope[seg] * dx + icept_fold[seg],
               _slot_clip_hi(a.n_slots))
    return tile_blocks(lo, a, q_tile=q_tile, w_tile=w_tile)


def tile_blocks(lo, a: IndexArrays, *, q_tile: int, w_tile: int):
    """The lowest window base of each tile of ``q_tile`` sorted queries,
    quantized to ``w_tile`` blocks and clipped to the last block pair
    (``lo`` is already clipped to the slots, NaN to 0)."""
    tile_lo = lo.view(-1, q_tile).amin(dim=1)
    m_pad = a.slot_key.shape[0]
    return torch.clamp(torch.floor(tile_lo / w_tile).int(),
                       0, m_pad // w_tile - 2)


def fused_args(qs, qls, a: IndexArrays, err_lo_pad, radix_table,
               radix_scale, *, q_tile: int, w_tile: int) -> tuple:
    """The kernel's 18 tensor arguments for a sorted, tile-padded batch:
    the folded intercepts, the tile schedule and the frozen images."""
    icept_fold = a.seg_icept + err_lo_pad - 1.0
    tile_block = tile_schedule(qs, qls, a, icept_fold, radix_table,
                               radix_scale, q_tile=q_tile, w_tile=w_tile)
    return (qs, qls, tile_block, radix_table, radix_scale,
            a.seg_first_key, a.seg_first_key_lo, a.seg_slope, icept_fold,
            a.slot_key, a.slot_key_lo, a.payload, a.payload_hi,
            a.link_offsets, a.link_keys, a.link_keys_lo, a.link_payloads,
            a.link_payload_hi)


def fused_args_u64(qs, a: IndexArrays, err_lo_pad, radix_table, radix_key,
                   radix_scale, *, q_tile: int, w_tile: int) -> tuple:
    """``fused_args`` of the 64-bit image: ``fused_lookup_u64``'s 15
    tensor arguments.  The tile schedule takes each query's window base
    as the kernel does (``lookup.window_line_u64``, clipped)."""
    icept_fold = a.seg_icept + err_lo_pad - 1.0
    lo = _clip(window_line_u64(qs, radix_table, radix_key, radix_scale,
                               a.seg_first_key, a.seg_slope, icept_fold),
               float(a.n_slots - 1))
    tile_block = tile_blocks(lo, a, q_tile=q_tile, w_tile=w_tile)
    return (qs, tile_block, radix_table, radix_key, radix_scale,
            a.seg_first_key, a.seg_slope, icept_fold, a.slot_key,
            a.payload, a.payload_hi, a.link_offsets, a.link_keys,
            a.link_payloads, a.link_payload_hi)


def fused_statics(a: IndexArrays, *, q_tile: int, w_tile: int,
                  flat_w: int) -> dict:
    """The kernel's static arguments for the frozen images ``a``."""
    return dict(q_tile=q_tile, w_tile=w_tile, flat_w=flat_w,
                max_chain=a.max_chain, n_slots=a.n_slots,
                key_wide=a.key_wide, wide=a.wide)


def fused_fixup(qs, qls, slot, resolved, out, out_hi, fb_loc, fb_cnt,
                a: IndexArrays, *, q_tile: int, fb_cap: int):
    """Re-resolve the kernel's escaped queries with the full-array
    oracle and the epilogue, in place.  Returns ``(fb_count,
    overflow)``; on overflow (more than ``fb_cap`` escapes) nothing is
    patched — the caller re-dispatches the batch to the oracle stage."""
    fb_count = int(fb_cnt.sum().item())
    if fb_count == 0 or fb_count > fb_cap:
        return fb_count, fb_count > fb_cap
    t = fb_cnt.shape[0]
    jj = torch.arange(q_tile, device=qs.device)
    valid = jj[None, :] < fb_cnt[:, None]
    qid = (torch.arange(t, device=qs.device)[:, None] * q_tile
           + fb_loc.view(t, q_tile).long())
    idx = qid[valid]                      # tile order, then local order
    q_fb = qs[idx]
    ql_fb = qls[idx] if a.key_wide else qls
    slot_f, found_f = oracle_search(q_fb, ql_fb, a.slot_key, a.slot_key_lo,
                                    a.key_wide)
    out_f, out_hi_f, res_f = epilogue(q_fb, ql_fb, slot_f, found_f, a,
                                      a.max_chain)
    slot[idx] = slot_f
    resolved[idx] = res_f
    out[idx] = out_f
    if a.wide:
        out_hi[idx] = out_hi_f
    return fb_count, False


def compact_fallback(q, ql, slot, found, fb, a: IndexArrays, *,
                     fb_cap: int):
    """Re-resolve ONLY the flagged queries with the full-array oracle,
    in place, in a buffer of at most ``fb_cap`` (the reference's
    cumsum + scatter compaction, as the flagged indices in order).
    Skipped when no flag is set.  Returns ``(fb_count, overflow)``; on
    overflow nothing is patched — the caller re-runs the batch on the
    oracle stage, as the reference's callers do with its results."""
    fb_count = int(fb.sum().item())
    if fb_count == 0 or fb_count > fb_cap:
        return fb_count, fb_count > fb_cap
    idx = torch.nonzero(fb).squeeze(1)
    slot_f, found_f = oracle_search(q[idx], ql[idx] if a.key_wide else ql,
                                    a.slot_key, a.slot_key_lo, a.key_wide)
    slot[idx] = slot_f
    found[idx] = found_f
    return fb_count, False


def route_segment_exact(q, ql, a: IndexArrays):
    """Exact segment routing (the branch of the reference's
    ``_route_segment`` without a radix table): searchsorted over the
    segment first keys, or a pair bisect when keys are wide."""
    segk = a.seg_first_key
    k_pad = segk.shape[0]
    if a.key_wide:
        trips = int(np.ceil(np.log2(max(k_pad, 2)))) + 1
        lo0 = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
        hi0 = torch.full(q.shape, k_pad - 1, dtype=torch.int32,
                         device=q.device)
        seg = _pair_bisect(segk, a.seg_first_key_lo, q, ql, lo0, hi0, trips)
        return seg.clamp(0, k_pad - 1).long()
    return (torch.searchsorted(segk, q, right=True) - 1).clamp(0, k_pad - 1)


def xla_window_lookup(q, ql, a: IndexArrays, err_lo_pad, err_hi_pad, *,
                      trips: int, flat_w: int, radix_table=None,
                      radix_scale=None):
    """Per-query bounded window search (the reference's
    ``_xla_window_lookup``, permutation-free): the error bounds give
    each query a slot window ``[lo0, hi0]``; a flat rank count over
    ``flat_w`` slots from ``lo0`` when ``flat_w > 0``, else a
    fixed-trip bisect.  Queries whose bracket escapes the window raise
    the fallback flag.  With ``radix_table`` the segment routing is the
    approximate radix route (sound: an edge rank raises the flag).
    Returns ``(slot i32, found, fb)``."""
    sk, skl = a.slot_key, a.slot_key_lo
    m_pad = sk.shape[0]
    wide = a.key_wide
    icept_lo = a.seg_icept + err_lo_pad - 1.0
    icept_hi = a.seg_icept + err_hi_pad + 1.0
    if radix_table is not None:
        seg = route_segment(q, ql, radix_table, radix_scale, wide)
    else:
        seg = route_segment_exact(q, ql, a)
    dx = q - a.seg_first_key[seg]
    if wide:
        dx = dx + (ql - a.seg_first_key_lo[seg])
    sl = a.seg_slope[seg]
    clip_hi = _slot_clip_hi(a.n_slots)
    lo0 = _clip(torch.floor(sl * dx + icept_lo[seg]), clip_hi).int()
    hi0 = _clip(torch.ceil(sl * dx + icept_hi[seg]), clip_hi).int()
    hi0 = torch.maximum(hi0, lo0)
    finite = torch.isfinite(q)

    if flat_w:
        offs = torch.arange(flat_w, device=q.device)
        idx = (lo0.long()[:, None] + offs).clamp(max=m_pad - 1)
        ks = sk[idx]
        edge = (lo0.long() + flat_w).clamp(max=m_pad - 1)
        if wide:
            ksl = skl[idx]
            le = _ple(ks, ksl, q[:, None], ql[:, None])
            eq = _peq(ks, ksl, q[:, None], ql[:, None])
            at_edge = _ple(sk[edge], skl[edge], q, ql)
        else:
            le = ks <= q[:, None]
            eq = ks == q[:, None]
            at_edge = sk[edge] <= q
        rank = le.sum(dim=1).int()
        slot = lo0 - 1 + rank
        found = (slot >= 0) & eq.any(dim=1)
        fb_lo = (rank == 0) & (lo0 > 0)
        fb_hi = (rank == flat_w) & at_edge
        return slot, found, (fb_lo | fb_hi) & finite

    if wide:
        slot = _pair_bisect(sk, skl, q, ql, lo0 - 1, hi0, trips)
    else:
        slot = _bisect(lo0 - 1, hi0, trips,
                       lambda mid: sk[mid.clamp(0, m_pad - 1).long()] <= q)
    safe = slot.clamp(0, m_pad - 1).long()
    edge = (hi0 + 1).clamp(max=m_pad - 1).long()
    if wide:
        found = (slot >= 0) & _peq(sk[safe], skl[safe], q, ql)
        at_edge = _ple(sk[edge], skl[edge], q, ql)
    else:
        found = (slot >= 0) & (sk[safe] == q)
        at_edge = sk[edge] <= q
    fb_hi = (slot == hi0) & at_edge
    fb_lo = (slot == lo0 - 1) & (lo0 > 0)
    return slot, found, (fb_lo | fb_hi) & finite


def pallas_search(qs, a: IndexArrays, err_lo_pad, *, q_tile: int,
                  w_tile: int):
    """The legacy stage's search over sorted narrow queries: the
    ``predict_ref`` tile schedule, then one launch of the legacy kernel.
    Returns ``(slot, found, fb)`` with the +inf padding rows' flags
    masked (they hit the window edge and are sliced away)."""
    y_hat, seg = predict_ref(qs, a.seg_first_key, a.seg_slope, a.seg_icept)
    lo = _clip(y_hat + err_lo_pad[seg] - 1.0, _slot_clip_hi(a.n_slots))
    tile_block = tile_blocks(lo, a, q_tile=q_tile, w_tile=w_tile)
    slot, found, fb, _pred = lookup_kernel(
        qs, tile_block, a.seg_first_key, a.seg_slope, a.seg_icept,
        a.slot_key, q_tile=q_tile, w_tile=w_tile)
    return slot, found, fb & torch.isfinite(qs)


def fused_search(queries, queries_lo, slot_key, slot_key_lo, rank_table,
                 rank_scale, trips: int, key_wide: bool):
    """The rank-router search of the reference's fused-XLA graph
    (``_fused_search``): bucket ``clip(x * scale)`` (a product with no
    add after it, truncated), the window ``[table[b] - 1, table[b+1] -
    1]``, a ``trips``-step bisect in it, then the bracket validation
    ``slot_key[r] <= q < slot_key[r+1]``: a stale row or a truncated
    bisect raises the escape flag, never a wrong slot.

    Queries are 1-D against one image, or ``(S, n)`` against images
    stacked ``(S, m)`` with ``rank_table`` ``(S, r + 1)`` and
    ``rank_scale`` ``(S, 3)``.  Returns ``(slot i32, found, fb)``."""
    m_pad = slot_key.shape[-1]
    r = rank_table.shape[-1] - 1
    x = queries - rank_scale[..., 0, None]
    if key_wide:
        x = x + (queries_lo - rank_scale[..., 1, None])
    b = _clip(x * rank_scale[..., 2, None], float(r - 1)).long()
    lo0 = _take(rank_table, b) - 1
    hi0 = torch.maximum(_take(rank_table, b + 1) - 1, lo0)
    if key_wide:
        slot = _pair_bisect(slot_key, slot_key_lo, queries, queries_lo,
                            lo0, hi0, trips)
    else:
        slot = _bisect(lo0, hi0, trips, lambda mid: _take(
            slot_key, mid.clamp(0, m_pad - 1).long()) <= queries)
    safe = slot.clamp(0, m_pad - 1).long()
    nxt_i = (slot + 1).clamp(0, m_pad - 1).long()
    kr = _take(slot_key, safe)
    nxt = _take(slot_key, nxt_i)
    if key_wide:
        krl = _take(slot_key_lo, safe)
        nxtl = _take(slot_key_lo, nxt_i)
        found = (slot >= 0) & _peq(kr, krl, queries, queries_lo)
        ok_lo = (slot < 0) | _ple(kr, krl, queries, queries_lo)
        ok_hi = ~_ple(nxt, nxtl, queries, queries_lo) | (slot + 1 >= m_pad)
    else:
        found = (slot >= 0) & (kr == queries)
        ok_lo = (slot < 0) | (kr <= queries)
        ok_hi = (nxt > queries) | (slot + 1 >= m_pad)
    fb = ~(ok_lo & ok_hi) & torch.isfinite(queries)
    return slot, found, fb


def fused_pipeline(queries, queries_lo, slot_key, slot_key_lo, payload,
                   payload_hi, link_offsets, link_keys, link_keys_lo,
                   link_payloads, link_payload_hi, rank_table, rank_scale,
                   *, trips: int, max_chain: int, wide: bool,
                   key_wide: bool):
    """The fused-XLA dispatch (the reference's ``_fused_pipeline``):
    ``fused_search`` then the epilogue.  Returns ``(out, out_hi, slot,
    resolved, fb)``; the caller patches the flagged queries on the
    host (``finish_fused_host``)."""
    slot, found, fb = fused_search(queries, queries_lo, slot_key,
                                   slot_key_lo, rank_table, rank_scale,
                                   trips, key_wide)
    out, out_hi, resolved = epilogue_parts(
        queries, queries_lo, slot, found, payload, payload_hi,
        link_offsets, link_keys, link_keys_lo, link_payloads,
        link_payload_hi, max_chain, wide, key_wide)
    return out, out_hi, slot, resolved, fb


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def host_fallback_views(arrays: IndexArrays) -> dict:
    """Host (numpy, f64/i64) copies of the frozen images for the fused
    graph's O(#escapes) patch (keys as their pair sums when wide,
    payloads recombined from their i32 halves when wide)."""
    sk = _np(arrays.slot_key).astype(np.float64)
    if arrays.key_wide:
        sk = sk + _np(arrays.slot_key_lo).astype(np.float64)
    pay = _np(arrays.payload).astype(np.int64)
    if arrays.wide:
        pay = (pay & 0xFFFFFFFF) | (
            _np(arrays.payload_hi).astype(np.int64) << 32)
    lk = _np(arrays.link_keys).astype(np.float64)
    if arrays.key_wide:
        lk = lk + _np(arrays.link_keys_lo).astype(np.float64)
    lp = _np(arrays.link_payloads).astype(np.int64)
    if arrays.wide:
        lp = (lp & 0xFFFFFFFF) | (
            _np(arrays.link_payload_hi).astype(np.int64) << 32)
    return {"slot_key": sk, "payload": pay,
            "offsets": _np(arrays.link_offsets),
            "link_keys": lk, "link_payloads": lp,
            "max_chain": arrays.max_chain, "key_wide": arrays.key_wide}


def resolve_escapes_host(host: dict, q64: np.ndarray):
    """Exact host resolution of the fused graph's escaped queries (f64
    searchsorted + per-slot chain probe), O(#escapes x log).  Queries
    are first rounded into the FROZEN key representation (f32 hi/lo
    pair sum when wide, plain f32 when narrow), so the host compare
    agrees bit for bit with the device compare.  Returns ``(slot,
    resolved, payload_i64)``."""
    if host["key_wide"]:
        q_hi, q_lo = split_key_pair(q64)
        q64 = q_hi.astype(np.float64) + q_lo.astype(np.float64)
    else:
        q64 = np.asarray(q64, np.float64).astype(
            np.float32).astype(np.float64)
    sk = host["slot_key"]
    r = np.searchsorted(sk, q64, side="right").astype(np.int64) - 1
    safe = np.maximum(r, 0)
    found = (r >= 0) & (sk[safe] == q64)
    pay = np.where(found, host["payload"][safe], np.int64(-1))
    resolved = found.copy()
    if host["max_chain"] > 0 and host["link_keys"].size:
        off = host["offsets"]
        for j in np.flatnonzero((r >= 0) & ~found):
            s, e = int(off[r[j]]), int(off[r[j] + 1])
            if e > s:
                seg = host["link_keys"][s:e]
                p = int(np.searchsorted(seg, q64[j], side="right")) - 1
                if p >= 0 and seg[p] == q64[j]:
                    pay[j] = host["link_payloads"][s + p]
                    resolved[j] = True
    return r, resolved, pay


def finish_fused_host(out, out_hi, slot, found, fb, n_q: int, wide: bool,
                      queries, host_views):
    """Host finish of the fused graph: the outputs sliced to ``n_q``,
    payloads recombined to i64, and the flagged queries patched by
    ``resolve_escapes_host``.  ``host_views`` is a zero-argument
    callable, so the host copies are built only when a query escaped.
    Returns ``(payload_i64, slot, found, n_escapes)``."""
    with span("lookup.copy_out"):
        idx = np.flatnonzero(_np(fb)[:n_q])
        out_np = _np(out)[:n_q]
        if wide:
            out_np = ((_np(out_hi)[:n_q].astype(np.int64) << 32)
                      | (out_np.astype(np.int64) & 0xFFFFFFFF))
        slot_np = _np(slot)[:n_q]
        found_np = _np(found)[:n_q]
    if idx.size:
        with span("lookup.fixup"):
            out_np = np.array(out_np)
            slot_np = np.array(slot_np)
            found_np = np.array(found_np)
            r, res, pay = resolve_escapes_host(
                host_views(), np.asarray(queries, np.float64)[idx])
            out_np[idx] = pay
            slot_np[idx] = r
            found_np[idx] = res
    return out_np, slot_np, found_np, int(idx.size)


STAGES = ("fused", "pallas", "xla", "oracle")


def pipeline(qh, ql, a: IndexArrays, err_lo_pad, radix_table, radix_scale,
             *, stage: str, q_tile: int, w_tile: int, flat_w: int,
             fb_cap: int, assume_sorted: bool, err_hi_pad=None,
             trips: int = 1, radix: bool = False, radix_key=None):
    """One batch through ``stage`` (one of ``STAGES``).  Returns
    ``(out, out_hi, slot, resolved, fb_count, overflow)`` as tensors on
    the index's device (counts as ints).  ``err_hi_pad`` / ``trips`` /
    ``radix`` (radix routing) serve the "xla" stage; ``radix_key``
    (the radix origin) the 64-bit image's "fused" stage."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}")
    if a.key_u64 and stage not in U64_STAGES:
        raise ValueError(f"the 64-bit key image is served by the "
                         f"{U64_STAGES} stages, not {stage!r}")
    if stage == "oracle":
        with span("lookup.search"):
            slot, found = oracle_search(qh, ql, a.slot_key, a.slot_key_lo,
                                        a.key_wide)
        with span("lookup.fixup"):
            out, out_hi, resolved = epilogue(qh, ql, slot, found, a,
                                             a.max_chain)
        return out, out_hi, slot, resolved, 0, False
    if stage == "xla":  # permutation-free
        with span("lookup.search"):
            slot, found, fb = xla_window_lookup(
                qh, ql, a, err_lo_pad, err_hi_pad, trips=trips,
                flat_w=flat_w, radix_table=radix_table if radix else None,
                radix_scale=radix_scale if radix else None)
        with span("lookup.fixup"):
            fb_count, overflow = compact_fallback(qh, ql, slot, found, fb,
                                                  a, fb_cap=fb_cap)
            out, out_hi, resolved = epilogue(qh, ql, slot, found, a,
                                             a.max_chain)
        return out, out_hi, slot, resolved, fb_count, overflow
    if stage == "pallas" and a.key_wide:
        raise ValueError("the pallas backend does not support wide "
                         "(f32 hi/lo pair) keys; use 'xla'")
    if assume_sorted:
        qs, qls, order = qh, ql, None
    else:
        with span("lookup.sort"):
            if a.key_wide:  # lexsort: lo first, then a stable sort by hi
                o_lo = torch.sort(ql, stable=True).indices
                order = o_lo[torch.sort(qh[o_lo], stable=True).indices]
                qls = ql[order]
            else:
                order = torch.sort(qh, stable=True).indices
                qls = ql
            qs = qh[order]
    if stage == "fused":
        with span("lookup.search"):
            if a.key_u64:
                slot, res, out, out_hi, _fb, fb_loc, fb_cnt = \
                    fused_lookup_u64(
                        *fused_args_u64(qs, a, err_lo_pad, radix_table,
                                        radix_key, radix_scale,
                                        q_tile=q_tile, w_tile=w_tile),
                        q_tile=q_tile, w_tile=w_tile, flat_w=flat_w,
                        max_chain=a.max_chain, n_slots=a.n_slots,
                        wide=a.wide)
            else:
                slot, res, out, out_hi, _fb, fb_loc, fb_cnt = fused_lookup(
                    *fused_args(qs, qls, a, err_lo_pad, radix_table,
                                radix_scale, q_tile=q_tile, w_tile=w_tile),
                    **fused_statics(a, q_tile=q_tile, w_tile=w_tile,
                                    flat_w=flat_w))
        with span("lookup.fixup"):
            resolved = res.bool()
            fb_count, overflow = fused_fixup(qs, qls, slot, resolved, out,
                                             out_hi, fb_loc, fb_cnt, a,
                                             q_tile=q_tile, fb_cap=fb_cap)
    else:
        with span("lookup.search"):
            slot, found, fb = pallas_search(qs, a, err_lo_pad,
                                            q_tile=q_tile, w_tile=w_tile)
        with span("lookup.fixup"):
            fb_count, overflow = compact_fallback(qs, qls, slot, found, fb,
                                                  a, fb_cap=fb_cap)
            out, out_hi, resolved = epilogue(qs, qls, slot, found, a,
                                             a.max_chain)
    if order is None:
        return out, out_hi, slot, resolved, fb_count, overflow

    def unsort(x):
        y = torch.empty_like(x)
        y[order] = x
        return y

    with span("lookup.unsort"):
        out_hi = unsort(out_hi) if a.wide else out_hi
        return (unsort(out), out_hi, unsort(slot), unsort(resolved),
                fb_count, overflow)


def _pad_bounds(err, k_pad: int, device, dtype=np.float32) -> torch.Tensor:
    err = np.asarray(err, dtype)
    return torch.from_numpy(
        np.ascontiguousarray(_pad_pow(err, k_pad, dtype(0))[:k_pad])
    ).to(device)


class _EscapeCounter:
    count = 0


# overflowed batches ``batched_lookup`` re-ran on the oracle stage
_ESCAPES = _EscapeCounter()


def _rank_router(arrays: IndexArrays):
    """The rank router of ``arrays`` on its device, ``(table, scale,
    trips)``, built once per instance (the reference's
    ``_cached_rank_router``).  ``IndexArrays`` is frozen and a delta
    update makes a new instance, so a cached router never drifts."""
    cached = getattr(arrays, "_rank_router_cache", None)
    if cached is None:
        table, scale, trips, _meta = build_rank_router(
            arrays.slot_key, arrays.slot_key_lo if arrays.key_wide else None)
        dev = arrays.device
        cached = (torch.from_numpy(table).to(dev),
                  torch.from_numpy(scale).to(dev), trips)
        object.__setattr__(arrays, "_rank_router_cache", cached)
    return cached


BACKENDS = ("fused", "fused-pallas", "pallas", "xla", "oracle")
FUSED_IMPLS = ("kernel", "xla")


def batched_lookup(arrays: IndexArrays, err_lo_by_seg, queries, *,
                   q_tile: int = 0, w_tile: int = 2048,
                   use_kernel: bool = True, backend: Optional[str] = None,
                   err_hi_by_seg=None, queries_sorted: bool = False,
                   fb_frac: float = FB_FRAC):
    """Full device lookup: ``(payloads i64, slots, found, #fallbacks)``
    as host numpy arrays (payload -1 = miss).

    ``backend`` takes the reference's five names with its meanings:

    * "fused" — the rank-router graph in torch ops (``fused_pipeline``)
      and the host patch of its escapes (``finish_fused_host``); the
      fourth output counts the patched queries, and there is no oracle
      escape;
    * "fused-pallas" — the reference's name for the fused kernel: in
      the port, one launch of the CUDA ``fused_lookup`` kernel (its
      plain version for CPU tensors) and the fixup of its escapes;
    * "pallas" — the legacy kernel (narrow keys; wide-key arrays route
      to "xla");
    * "xla" — windowed rank / bisect in torch ops, permutation-free;
    * "oracle" — full-array search.

    Default: "pallas" when ``use_kernel`` else "oracle", as in the
    reference.  On compaction overflow a "fused-pallas" / "pallas" /
    "xla" batch is re-run on the oracle stage (``_ESCAPES`` counts it).
    """
    backend = backend or ("pallas" if use_kernel else "oracle")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    a = arrays
    if a.key_u64:
        raise ValueError("batched_lookup serves the float key images; "
                         "QueryEngine serves the 64-bit image")
    if backend == "pallas" and a.key_wide:
        backend = "xla"  # the legacy kernel is narrow-only
    qh_np, ql_np = split_queries(queries, a.key_wide)
    n_q = qh_np.shape[0]
    dev = a.device
    if backend == "fused":
        # one lean graph + O(#escapes) host patch; none of the kernel
        # stages' statics below apply
        rank_table, rank_scale, trips = _rank_router(a)
        out, out_hi, slot, found, fbm = fused_pipeline(
            torch.from_numpy(qh_np).to(dev), torch.from_numpy(ql_np).to(dev),
            a.slot_key, a.slot_key_lo, a.payload, a.payload_hi,
            a.link_offsets, a.link_keys, a.link_keys_lo, a.link_payloads,
            a.link_payload_hi, rank_table, rank_scale, trips=trips,
            max_chain=a.max_chain, wide=a.wide, key_wide=a.key_wide)
        return finish_fused_host(out, out_hi, slot, found, fbm, n_q, a.wide,
                                 queries, lambda: host_fallback_views(a))
    stage = "fused" if backend == "fused-pallas" else backend
    if q_tile <= 0:
        q_tile = auto_q_tile(n_q, a.n_slots, w_tile)
    tile_granular = stage in ("fused", "pallas")
    if tile_granular:
        qh_np = _pad_pow(qh_np, q_tile, np.float32(np.inf))
        if a.key_wide:
            ql_np = _pad_pow(ql_np, q_tile, np.float32(0))
    err_lo_np = np.asarray(err_lo_by_seg, np.float32)
    err_hi_np = (np.zeros_like(err_lo_np) if err_hi_by_seg is None
                 else np.asarray(err_hi_by_seg, np.float32))
    flat_w = (_fused_flat_width(err_lo_np, err_hi_np) if stage == "fused"
              else _flat_width(err_lo_np, err_hi_np))
    k_pad = int(a.seg_first_key.shape[0])
    table, scale = build_radix_router(a)
    fb_cap = int(min(qh_np.shape[0],
                     max(q_tile if tile_granular else 64,
                         int(np.ceil(fb_frac * qh_np.shape[0])))))
    out, out_hi, slot, found, fb, overflow = pipeline(
        torch.from_numpy(qh_np).to(dev), torch.from_numpy(ql_np).to(dev),
        a, _pad_bounds(err_lo_np, k_pad, dev),
        torch.from_numpy(table).to(dev), torch.from_numpy(scale).to(dev),
        stage=stage, q_tile=q_tile, w_tile=w_tile, flat_w=flat_w,
        fb_cap=fb_cap, assume_sorted=bool(queries_sorted),
        err_hi_pad=_pad_bounds(err_hi_np, k_pad, dev),
        trips=_bisect_trips(err_lo_np, err_hi_np))
    if stage != "oracle" and overflow:
        _ESCAPES.count += 1
        return batched_lookup(arrays, err_lo_by_seg, queries,
                              q_tile=q_tile, w_tile=w_tile,
                              backend="oracle", err_hi_by_seg=err_hi_by_seg,
                              fb_frac=fb_frac)
    return (recombine_i64(out, out_hi, n_q, a.wide),
            slot[:n_q].cpu().numpy(), found[:n_q].cpu().numpy(), fb)


class QueryEngine:
    """Persistent query engine over a frozen ``IndexArrays``.

    Pads batches up to power-of-two buckets (``min_bucket`` and up),
    keeps the padded error bounds and the radix router resident on the
    index's device, and picks per bucket: ``q_tile`` by
    ``auto_q_tile``, the flat width (for the fused stage the wide fused
    width up to ``fused_flat_max_bucket``, the legacy width above it;
    the legacy width for the "pallas" / "xla" stages) and the escape
    buffer ``fb_cap`` (``fb_frac`` of the bucket, at least one tile on
    the tile-granular stages or 64, times a sticky per-bucket boost
    after an overflow).

    Calls run the "fused" stage unless they ask for "pallas" (wide keys
    route it to "xla"), "xla" (below ``xla_min_bucket`` downgraded to
    "oracle" unless forced) or "oracle".  ``stats`` counts calls, fallbacks (escapes the fixup
    re-resolved) and oracle escapes (overflowed batches re-run on the
    oracle stage); ``last_stage`` names the stage that served the last
    call and ``last_escapes`` the escapes its first stage flagged (more
    than ``fb_cap`` when the call overflowed to the oracle stage).

    ``fused_impl`` picks what serves the "fused" stage, the placement
    and the fused ingest (the reference's switch, whose ``"pallas"`` is
    the port's ``"kernel"``):

    * ``"kernel"`` (the default, on the card and on the CPU) — the CUDA
      ``fused_lookup`` and ``ingest_place`` kernels, their plain
      versions for CPU tensors;
    * ``"xla"`` — the reference's graph implementations in torch ops on
      the arrays' device: the rank-router lookup graph with the host
      patch of its escapes (no compaction buffer, no oracle escape),
      ``gap_place.ingest_place_graph`` and the fused ingest over it.

    Nothing selects ``"xla"`` but the caller.

    Over the 64-bit image (``arrays.key_u64``) the engine takes ordered
    int64 queries (``core.keys64.query_ordered``), runs ``"fused"`` (the
    kernel only) or ``"oracle"``, keeps its bounds in float64 and has no
    rank router: that image serves no write.
    """

    def __init__(self, arrays: IndexArrays, err_lo_by_seg,
                 err_hi_by_seg=None, *, fused_impl: Optional[str] = None,
                 w_tile: int = 2048,
                 fb_frac: float = FB_FRAC, min_bucket: int = 256,
                 xla_min_bucket: int = 8192,
                 fused_flat_max_bucket: int = 8192):
        fused_impl = fused_impl or "kernel"
        if fused_impl not in FUSED_IMPLS:
            raise ValueError(f"unknown fused_impl {fused_impl!r}; "
                             f"expected one of {FUSED_IMPLS}")
        self.u64 = bool(arrays.key_u64)
        if self.u64 and fused_impl != "kernel":
            raise ValueError("the 64-bit key image is served by the "
                             "fused kernel (fused_impl='kernel')")
        self._bound_dtype = np.float64 if self.u64 else np.float32
        self.fused_impl = fused_impl
        self.arrays = arrays
        # the fused stage is the default; the legacy "pallas" / "xla"
        # stages stay as debug / reference backends
        self.backend = "fused"
        self.w_tile = w_tile
        self.fb_frac = fb_frac
        self.min_bucket = max(32, int(min_bucket))
        # below this bucket a non-forced "xla" request runs the oracle
        # stage (the legacy windowed path's extra ops cost more than the
        # full search they avoid)
        self.xla_min_bucket = int(xla_min_bucket)
        self.fused_flat_max_bucket = int(fused_flat_max_bucket)
        self.err_lo = np.asarray(err_lo_by_seg, self._bound_dtype)
        self.err_hi = (None if err_hi_by_seg is None
                       else np.asarray(err_hi_by_seg, self._bound_dtype))
        err_hi_np = (np.zeros_like(self.err_lo) if self.err_hi is None
                     else self.err_hi)
        dev = arrays.device
        self._upload_bounds(self.err_lo, err_hi_np)
        self._trips = _bisect_trips(self.err_lo, err_hi_np)
        self._flat_w = _flat_width(self.err_lo, err_hi_np)
        self._fused_flat_w = _fused_flat_width(self.err_lo, err_hi_np)
        self._rank_bounds_pair = None
        self._radix_key = None
        if self.u64:
            table, kmin, scale = build_radix_router_u64(arrays)
            self._radix_table = torch.from_numpy(table).to(dev)
            self._radix_key = torch.from_numpy(kmin).to(dev)
            self._radix_scale = torch.from_numpy(scale).to(dev)
            self._rank_np = self._rank_table = self._rank_scale = None
            self._rank_trips, self._rank_meta = 1, None
        else:
            table, scale = build_radix_router(arrays)
            self._radix_table = torch.from_numpy(table).to(dev)
            self._radix_scale = torch.from_numpy(scale).to(dev)
            # bucket -> slot-rank table of the fused graph (``fused_impl=
            # "xla"``); the fused ingest refreshes it in-graph and delta
            # syncs refresh its rows, as the reference's engine does
            self._rank_np, rk_scale, self._rank_trips, self._rank_meta = \
                build_rank_router(
                    arrays.slot_key,
                    arrays.slot_key_lo if arrays.key_wide else None)
            self._rank_table = torch.from_numpy(self._rank_np.copy()).to(
                dev)
            self._rank_scale = torch.from_numpy(rk_scale).to(dev)
        # sticky per-bucket escape-capacity boost: a workload that once
        # overflowed gets a larger buffer next time instead of paying
        # the oracle re-dispatch on every call
        self._cap_boost: dict = {}
        # lazy host copies for the graph's escape patch, rebuilt when
        # ``arrays`` is replaced
        self._host_cache = None
        self.last_stage: Optional[str] = None
        self.last_escapes = 0
        self.stats = {"calls": 0, "fallbacks": 0, "oracle_escapes": 0,
                      "buckets": set()}

    @classmethod
    def from_index(cls, index, device=None, *, w_tile: int = 2048,
                   seg_chunk: int = 512, max_chain: Optional[int] = None,
                   **kwargs):
        """Freeze an index (current capacities) with query-safe window
        bounds on ``device`` (cuda by default)."""
        from .freeze import from_learned_index
        arrays = from_learned_index(index, resolve_device(device),
                                    w_tile=w_tile, seg_chunk=seg_chunk,
                                    max_chain=max_chain)
        err_lo, err_hi = query_window_bounds(index)
        return cls(arrays, err_lo, err_hi, w_tile=w_tile, **kwargs)

    def swap_arrays(self, arrays: IndexArrays) -> None:
        """Adopt delta-updated tensors (same shapes and statics)."""
        self.arrays = arrays

    def _host_views(self) -> dict:
        cached = self._host_cache
        if cached is None or cached[0] is not self.arrays:
            cached = (self.arrays, host_fallback_views(self.arrays))
            self._host_cache = cached
        return cached[1]

    def _upload_bounds(self, err_lo: np.ndarray, err_hi: np.ndarray):
        k_pad = int(self.arrays.seg_first_key.shape[0])
        dev = self.arrays.device
        self._elo = _pad_bounds(err_lo, k_pad, dev, self._bound_dtype)
        self._ehi = _pad_bounds(err_hi, k_pad, dev, self._bound_dtype)

    def _set_bound_statics(self, err_lo, err_hi) -> None:
        self.err_lo = np.asarray(err_lo, self._bound_dtype)
        self.err_hi = np.asarray(err_hi, self._bound_dtype)
        self._trips = _bisect_trips(self.err_lo, self.err_hi)
        self._flat_w = _flat_width(self.err_lo, self.err_hi)
        self._fused_flat_w = _fused_flat_width(self.err_lo, self.err_hi)

    def refresh_bounds(self, err_lo, err_hi) -> None:
        """Adopt incrementally refreshed per-segment window bounds after
        a delta update (same K), re-uploading the resident copies and
        re-deriving the flat widths from them."""
        self._set_bound_statics(err_lo, err_hi)
        self._upload_bounds(self.err_lo, self.err_hi)

    def refresh_rank_rows(self, touched_keys, slot_key, slot_key_lo=None,
                          upload=True):
        """Refresh the rank table's rows for the buckets covering the
        touched key values against the CURRENT (host) slot keys.  A
        stale row is sound in the reference's fused-XLA search (its
        bracket validation turns it into fallbacks), so near-global
        churn skips the refresh.  ``upload=False`` refreshes only the
        host copy: the fused ingest already wrote the device table."""
        touched = np.asarray(touched_keys, np.float64)
        kmin, scale, r_size = self._rank_meta
        if touched.size == 0 or touched.size > r_size // 4:
            return
        touched = touched[np.isfinite(touched)]
        if touched.size == 0:
            return
        b = np.clip((touched - kmin) * scale, 0, r_size - 1).astype(np.int64)
        # one row of margin each side: the representation rounding below
        # can move a key across a bucket boundary
        rows = np.unique(np.clip(np.concatenate([b - 1, b, b + 1]),
                                 0, r_size))
        sk = np.asarray(slot_key, np.float64)
        if slot_key_lo is not None and np.asarray(slot_key_lo).size:
            sk = sk + np.asarray(slot_key_lo, np.float64)
        # round into the FROZEN device key representation, which the
        # table was built from
        if self.arrays.key_wide:
            sk_hi, sk_lo = split_key_pair(sk)
            sk = sk_hi.astype(np.float64) + sk_lo.astype(np.float64)
        else:
            sk = sk.astype(np.float32).astype(np.float64)
        bounds = kmin + rows.astype(np.float64) / scale
        vals = np.searchsorted(sk, bounds, side="left").astype(np.int32)
        top = rows == r_size
        if np.any(top):  # top boundary includes duplicated max keys
            fin = sk[np.isfinite(sk)]
            kmax = float(fin[-1]) if fin.size else kmin
            vals[top] = np.searchsorted(sk, kmax, side="right")
        self._rank_np[rows] = vals
        if upload:
            self._rank_table = torch.from_numpy(self._rank_np.copy()).to(
                self.arrays.device)

    def _rank_bounds(self):
        """Device f32-pair bucket-boundary keys for the fused ingest's
        in-graph rank-row refresh (built once per engine)."""
        if self._rank_bounds_pair is None:
            kmin, scale, r_size = self._rank_meta
            bounds = kmin + np.arange(int(r_size) + 1,
                                      dtype=np.float64) / scale
            bh, bl = split_key_pair(bounds)
            dev = self.arrays.device
            self._rank_bounds_pair = (torch.from_numpy(bh).to(dev),
                                      torch.from_numpy(bl).to(dev))
        return self._rank_bounds_pair

    def ingest_place(self, keys):
        """Per-key §5.3 placement primitives against the frozen arrays,
        with the escape mask (``ops_gap.ingest_place``): under
        ``fused_impl="kernel"`` the CUDA kernel on the card and its
        plain version on the CPU, under ``"xla"`` the placement graph."""
        from .ops_gap import ingest_place as _place
        return _place(self.arrays, keys, impl=self.fused_impl)

    def fused_ingest(self, keys, payloads):
        """The single-dispatch ingest against the frozen arrays
        (``ops_gap.fused_ingest``): ``(prims, escape, ok, reasons,
        state)``; on ``ok`` the caller commits ``state`` with
        ``adopt_fused_state``."""
        from .ops_gap import fused_ingest as _fused
        bh, bl = self._rank_bounds()
        return _fused(
            self.arrays, keys, payloads, rank_table=self._rank_table,
            rank_bounds_hi=bh, rank_bounds_lo=bl,
            rank_scale=self._rank_scale, elo=self._elo, ehi=self._ehi,
            max_chain=self.arrays.max_chain, impl=self.fused_impl,
            min_bucket=self.min_bucket)

    def adopt_fused_state(self, state: dict, err_lo=None,
                          err_hi=None) -> None:
        """Install the fused ingest's output tensors (same shapes and
        statics), with the in-graph refreshed rank table and window
        bounds.  Fields whose frozen image is zero-length stay so.
        ``err_lo``/``err_hi`` are the caller-updated host bound mirrors;
        the flat widths are re-derived from them (the device copies
        were written in-graph)."""
        from .delta import DELTA_FIELDS
        updates = {f: state[f] for f in DELTA_FIELDS
                   if int(getattr(self.arrays, f).shape[0])}
        self.arrays = dataclasses.replace(self.arrays, **updates)
        self._rank_table = state["rank_table"]
        self._elo = state["elo"]
        self._ehi = state["ehi"]
        if err_lo is not None:
            self._set_bound_statics(err_lo, err_hi)

    def bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b <<= 1
        return b

    def _fused_width_for(self, b: int) -> int:
        """The wide fused flat width up to ``fused_flat_max_bucket``,
        the compare-lean legacy width (or the whole window, 0) above."""
        return (self._fused_flat_w if b <= self.fused_flat_max_bucket
                else self._flat_w)

    def _dispatch(self, qj, qlj, stage, q_tile, fb_cap, queries_sorted,
                  flat_w):
        return pipeline(qj, qlj, self.arrays, self._elo, self._radix_table,
                        self._radix_scale, stage=stage, q_tile=q_tile,
                        w_tile=self.w_tile, flat_w=flat_w, fb_cap=fb_cap,
                        assume_sorted=queries_sorted, err_hi_pad=self._ehi,
                        trips=self._trips, radix=stage in ("xla", "fused"),
                        radix_key=self._radix_key)

    def lookup(self, queries, *, queries_sorted: bool = False,
               backend: Optional[str] = None, force_backend: bool = False):
        """``(payloads i64, slots, found, fb_count)`` as host numpy
        arrays sliced to ``len(queries)``.  ``backend`` overrides the
        engine default for this call ("fused" / "pallas" / "xla" /
        "oracle"); wide keys route "pallas" to "xla" (a capability,
        always applied); below ``xla_min_bucket`` an "xla" request runs
        the oracle stage unless ``force_backend``."""
        a = self.arrays
        with span("lookup.prepare"):
            if self.u64:
                qh, ql = np.asarray(queries, np.int64), _NO_F32
            else:
                qh, ql = split_queries(queries, a.key_wide)
            n_q = qh.shape[0]
            b = self.bucket(n_q)
            if b == n_q:
                qp, qlp = qh, ql
            else:
                qp = (np.full(b, NO_KEY, np.int64) if self.u64
                      else np.full(b, np.inf, np.float32))
                qp[:n_q] = qh  # +inf tail keeps sorted batches sorted
                if a.key_wide:
                    qlp = np.zeros(b, np.float32)
                    qlp[:n_q] = ql
                else:
                    qlp = ql
            q_tile = min(b, auto_q_tile(b, a.n_slots, self.w_tile))
            stage = backend or self.backend
            if stage not in STAGES:
                raise ValueError(f"unknown backend {stage!r}")
            if self.u64 and stage not in U64_STAGES:
                raise ValueError(f"the 64-bit key image is served by the "
                                 f"{U64_STAGES} stages, not {stage!r}")
            if stage == "pallas" and a.key_wide:
                stage = "xla"  # capability fallback (the legacy kernel)
            if (stage == "xla" and b < self.xla_min_bucket
                    and not force_backend):
                stage = "oracle"  # size-aware scheduling (see __init__)
            self.last_stage = stage
            boost = self._cap_boost.get(b, 1)
            tile_granular = stage in ("fused", "pallas")
            fb_cap = int(min(b, boost * max(
                q_tile if tile_granular else 64,
                int(np.ceil(self.fb_frac * b)))))
            flat_w = (self._fused_width_for(b) if stage == "fused"
                      else self._flat_w)
        dev = a.device
        with span("lookup.copy_in"):
            qj = torch.from_numpy(qp).to(dev)
            qlj = torch.from_numpy(qlp).to(dev)
        if stage == "fused" and self.fused_impl == "xla":
            # one lean graph returning the escape mask; the flagged
            # queries are patched on the host in O(#escapes), with no
            # compaction buffer and no oracle escape
            with span("lookup.search"):
                out, out_hi, slot, found, fbm = fused_pipeline(
                    qj, qlj, a.slot_key, a.slot_key_lo, a.payload,
                    a.payload_hi, a.link_offsets, a.link_keys,
                    a.link_keys_lo, a.link_payloads, a.link_payload_hi,
                    self._rank_table, self._rank_scale,
                    trips=self._rank_trips, max_chain=a.max_chain,
                    wide=a.wide, key_wide=a.key_wide)
            out, slot_h, found_h, n_fb = finish_fused_host(
                out, out_hi, slot, found, fbm, n_q, a.wide, queries,
                self._host_views)
            self.last_escapes = n_fb
            self.stats["calls"] += 1
            self.stats["fallbacks"] += n_fb
            self.stats["buckets"].add(b)
            return out, slot_h, found_h, n_fb
        out, out_hi, slot, found, fb, overflow = self._dispatch(
            qj, qlj, stage, q_tile, fb_cap, bool(queries_sorted), flat_w)
        self.last_escapes = int(fb)
        if stage != "oracle" and fb_cap < b and overflow:
            with span("lookup.oracle"):
                self.stats["oracle_escapes"] += 1
                self._cap_boost[b] = min(boost * 4, 64)  # sticky escalation
                self.last_stage = "oracle"  # the stage that actually served
                out, out_hi, slot, found, fb, _ = self._dispatch(
                    qj, qlj, "oracle", q_tile, fb_cap, bool(queries_sorted),
                    0)
        self.stats["calls"] += 1
        self.stats["fallbacks"] += int(fb)
        self.stats["buckets"].add(b)
        with span("lookup.copy_out"):
            return (recombine_i64(out, out_hi, n_q, a.wide),
                    slot[:n_q].cpu().numpy(), found[:n_q].cpu().numpy(),
                    int(fb))
