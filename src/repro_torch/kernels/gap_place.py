"""§5.3 ingest placement and Eq. 3 gap placement: the CUDA kernels'
wrappers, their plain torch versions, and the fused single-dispatch
ingest graph.

Counterpart of ``repro.kernels.gap_place``:

* the double-f32 ("pair") arithmetic ``_two_sum`` .. ``_dd_mul``
  (Dekker/Knuth error-free transforms, no FMA) and the pair compares
  and bisect, as torch functions;
* ``ingest_place`` launches ``csrc/ingest_place.cu`` (the port of the
  TPU kernel ``ingest_place_call``) for CUDA tensors and raises on
  anything the kernel does not take; for CPU tensors it runs
  ``ingest_place_plain``, the same function in torch ops (the
  reference's ``ingest_place_body``).  ``ingest_place.launches`` counts
  kernel launches;
* ``ingest_place_graph`` — the reference's fused-XLA placement
  (``_ingest_place_xla``): the same per-key body in torch ops on the
  device of its tensors, for ``QueryEngine(fused_impl="xla")``;
* ``fused_ingest_body`` — placement -> partition -> slot scatter +
  carried-key repair -> CSR merge -> rank-row / window-bound refresh,
  as torch ops; stage 1 is ``ingest_place`` (the reference's
  ``use_pallas`` arm: the kernel on CUDA, the plain version on the CPU)
  or, with ``use_kernel=False``, ``ingest_place_graph``;
* ``gap_place`` launches ``csrc/gap_place.cu`` (the port of the TPU
  kernel ``gap_place_call``, Eq. 3 target positions for sorted keys)
  for CUDA tensors; ``gap_place_plain`` is its torch version, and
  ``gap_place_brackets`` the per-chunk segment brackets the kernel
  routes in.  ``gap_place.launches`` counts kernel launches.

Narrow (f32-exact) indexes pass zero-length ``*_lo`` key tables; the
kernel and the plain version read them as zeros, as the reference's
``zeros_like`` tables are.  Every f32 operation below is one torch op,
so nothing is contracted into an FMA.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["ingest_place", "ingest_place_plain", "ingest_place_graph",
           "fused_ingest_body",
           "split_flags", "gap_place", "gap_place_brackets",
           "gap_place_plain"]

_SPLITTER = 4097.0  # 2^12 + 1 (Veltkamp split for f32)
_TOL_SCALE = 2e-9   # rounds to the f32 the reference's jnp.float32 gives
_I32MAX = 2 ** 31 - 1  # sort sentinel: above any slot/link index


# ---------------------------------------------------------------------------
# double-f32 (pair) arithmetic — error-free transforms, no fma needed
# ---------------------------------------------------------------------------


def _two_sum(a, b):
    """Knuth two-sum: s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _two_prod(a, b):
    """Dekker two-product via Veltkamp splitting: p + e == a * b."""
    p = a * b
    ca = _SPLITTER * a
    ah = ca - (ca - a)
    al = a - ah
    cb = _SPLITTER * b
    bh = cb - (cb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _dd_add2(ah, al, bh, bl):
    """(ah, al) + (bh, bl), renormalized."""
    s, e = _two_sum(ah, bh)
    e = e + (al + bl)
    return _two_sum(s, e)


def _dd_sub2(ah, al, bh, bl):
    return _dd_add2(ah, al, -bh, -bl)


def _dd_mul(ah, al, bh, bl):
    """(ah, al) * (bh, bl), renormalized (drops the al*bl term)."""
    p, e = _two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    return _two_sum(p, e)


# ---------------------------------------------------------------------------
# pair compares + fixed-trip bisect (lexicographic (hi, lo) order ==
# numeric order for pair-split keys — freeze.split_key_pair)
# ---------------------------------------------------------------------------


def _p_le(kh, kl, qh, ql):
    return (kh < qh) | ((kh == qh) & (kl <= ql))


def _p_lt(kh, kl, qh, ql):
    return (kh < qh) | ((kh == qh) & (kl < ql))


def _p_eq(kh, kl, qh, ql):
    return (kh == qh) & (kl == ql)


def _trips(n: int) -> int:
    """The reference's bisect trip count for an n-entry table."""
    return int(max(n, 2) - 1).bit_length() + 1


def _bisect_pair(kh, kl, qh, ql, trips: int, strict: bool, visit=None):
    """Rightmost index with key {<,<=} query over the whole array
    (-1 when none) — branchless fixed-trip bisect, pair-aware.
    ``visit(mids)``, when given, receives each trip's midpoints of the
    queries whose bracket is still open (the entries a bisect that
    stops when its bracket closes reads)."""
    n = kh.shape[0]
    cmp = _p_lt if strict else _p_le
    lo = torch.full(qh.shape, -1, dtype=torch.int64, device=qh.device)
    hi = torch.full(qh.shape, n - 1, dtype=torch.int64, device=qh.device)
    for _ in range(trips):
        upd = lo < hi
        mid = (lo + hi + 1) >> 1
        midc = mid.clamp(0, n - 1)
        if visit is not None:
            visit(midc[upd])
        go = cmp(kh[midc], kl[midc], qh, ql)
        lo = torch.where(upd & go, mid, lo)
        hi = torch.where(upd, torch.where(go, hi, mid - 1), hi)
    return lo


def _lo(t, like):
    """A zero-length lo table reads as zeros (narrow freeze)."""
    return t if t.shape[0] else torch.zeros_like(like)


# ---------------------------------------------------------------------------
# the placement primitives: plain version and kernel wrapper
# ---------------------------------------------------------------------------


def _place_plain(x_hi, x_lo, segk_hi, segk_lo, slope_hi, slope_lo,
                 icept_hi, icept_lo, slot_hi, slot_lo, link_offsets,
                 link_hi, link_lo, *, n_slots: int):
    """``ingest_place_body`` in torch ops: ``(p, pv, ub, free, bracket,
    escape)``, indices int64, masks bool."""
    segk_lo = _lo(segk_lo, segk_hi)
    slot_lo = _lo(slot_lo, slot_hi)
    link_lo = _lo(link_lo, link_hi)
    k_pad = segk_hi.shape[0]
    m_pad = slot_hi.shape[0]

    # --- segment routing (searchsorted-right - 1, clipped like host) ---
    seg = _bisect_pair(segk_hi, segk_lo, x_hi, x_lo, _trips(k_pad),
                       strict=False).clamp(0, k_pad - 1)

    # --- double-f32 prediction + rint with escape band -----------------
    dx_h, dx_l = _dd_sub2(x_hi, x_lo, segk_hi[seg], segk_lo[seg])
    sl_h = slope_hi[seg]
    ic_h = icept_hi[seg]
    m_h, m_l = _dd_mul(sl_h, slope_lo[seg], dx_h, dx_l)
    y_h, y_l = _dd_add2(m_h, m_l, ic_h, icept_lo[seg])
    rh = torch.round(y_h)  # half to even, as jnp.round and rintf
    d = (y_h - rh) + y_l
    step = (d > 0.5).long() - (d < -0.5).long()
    nf = float(n_slots)
    # clip, NaN -> -1 (fminf(fmaxf(rh, -1), n) in the kernel); a C cast
    # after the clip truncates, as astype(int32) does
    rh_c = torch.where(torch.isnan(rh), torch.full_like(rh, -1.0),
                       rh.clamp(-1.0, nf))
    p = (rh_c.long() + step).clamp(0, n_slots - 1)
    tol = ((sl_h * dx_h).abs() + ic_h.abs() + 4.0) * _TOL_SCALE
    ad = d.abs()
    escape = (ad - 0.5).abs() < tol
    escape |= ~torch.isfinite(y_h)
    escape |= (rh <= 0.0) & (ad > 0.4)
    escape |= (rh >= float(n_slots - 1)) & (ad > 0.4)

    # --- occupancy from the carried-key construction -------------------
    nx_h = slot_hi[p]
    nx_l = slot_lo[p]
    r_valid = p + 1 < m_pad
    r_i = (p + 1).clamp(max=m_pad - 1)
    r_h = torch.where(r_valid, slot_hi[r_i],
                      torch.full_like(nx_h, float("inf")))
    r_l = torch.where(r_valid, slot_lo[r_i], torch.zeros_like(nx_l))
    free = _p_eq(nx_h, nx_l, r_h, r_l)

    # --- run boundaries: key-run ub, slot-run pv -----------------------
    slot_trips = _trips(m_pad)
    ub = _bisect_pair(slot_hi, slot_lo, x_hi, x_lo, slot_trips,
                      strict=False)
    pv = _bisect_pair(slot_hi, slot_lo, nx_h, nx_l, slot_trips, strict=True)

    # --- bracket: prev boundary key (incl. chain max) < key < next -----
    pv_safe = pv.clamp(min=0)
    pm_h = slot_hi[pv_safe]
    pm_l = slot_lo[pv_safe]
    s0 = link_offsets[pv_safe]
    e0 = link_offsets[pv_safe + 1]
    l_pad = link_hi.shape[0]
    if l_pad:
        ci = (e0.long() - 1).clamp(0, l_pad - 1)
        cm_h = link_hi[ci]
        cm_l = link_lo[ci]
        bigger = (e0 > s0) & _p_lt(pm_h, pm_l, cm_h, cm_l)
        pm_h = torch.where(bigger, cm_h, pm_h)
        pm_l = torch.where(bigger, cm_l, pm_l)
    prev_ok = (pv < 0) | _p_lt(pm_h, pm_l, x_hi, x_lo)
    bracket = free & prev_ok & _p_lt(x_hi, x_lo, nx_h, nx_l)
    return p, pv, ub, free, bracket, escape


_ARG_NAMES = ("x_hi", "x_lo", "segk_hi", "segk_lo", "slope_hi", "slope_lo",
              "icept_hi", "icept_lo", "slot_hi", "slot_lo", "link_offsets",
              "link_hi", "link_lo")
_ARG_DTYPES = tuple(torch.int32 if n == "link_offsets" else torch.float32
                    for n in _ARG_NAMES)


def _check(args):
    dev = _build.check_1d(args, _ARG_NAMES, _ARG_DTYPES, "x_hi")
    (x_hi, x_lo, segk_hi, segk_lo, slope_hi, slope_lo, icept_hi, icept_lo,
     slot_hi, slot_lo, off, link_hi, link_lo) = args
    k_pad, m_pad = segk_hi.shape[0], slot_hi.shape[0]
    if x_lo.shape != x_hi.shape:
        raise ValueError("x_lo must match x_hi")
    if k_pad == 0 or m_pad == 0:
        raise ValueError("segment and slot tables must be non-empty")
    for name, t, n in (("segk_lo", segk_lo, k_pad),
                       ("slot_lo", slot_lo, m_pad),
                       ("link_lo", link_lo, link_hi.shape[0])):
        if t.shape[0] not in (0, n):
            raise ValueError(f"{name} must be empty or match its hi half")
    for name, t in (("slope_hi", slope_hi), ("slope_lo", slope_lo),
                    ("icept_hi", icept_hi), ("icept_lo", icept_lo)):
        if t.shape[0] != k_pad:
            raise ValueError(f"{name} must match segk_hi")
    if off.shape[0] < m_pad + 1:
        raise ValueError("link_offsets needs at least Mpad + 1 entries")
    return dev


def split_flags(flags):
    """flags = free | 2 * bracket | 4 * escape -> three bool masks."""
    return (flags & 1) != 0, (flags & 2) != 0, (flags & 4) != 0


def ingest_place_plain(x_hi, x_lo, segk_hi, segk_lo, slope_hi, slope_lo,
                       icept_hi, icept_lo, slot_hi, slot_lo, link_offsets,
                       link_hi, link_lo, *, n_slots: int):
    """The kernel's function in plain torch ops on any device:
    ``(p, pv, ub, flags)`` int32, flags = free | 2·bracket | 4·escape."""
    p, pv, ub, free, bracket, escape = _place_plain(
        x_hi, x_lo, segk_hi, segk_lo, slope_hi, slope_lo, icept_hi,
        icept_lo, slot_hi, slot_lo, link_offsets, link_hi, link_lo,
        n_slots=n_slots)
    flags = free.int() + 2 * bracket.int() + 4 * escape.int()
    return p.int(), pv.int(), ub.int(), flags


def ingest_place_graph(x_hi, x_lo, segk_hi, segk_lo, slope_hi, slope_lo,
                       icept_hi, icept_lo, slot_hi, slot_lo, link_offsets,
                       link_hi, link_lo, *, n_slots: int):
    """The reference's graph placement (``_ingest_place_xla``): the
    shared per-key body over the whole batch in torch ops, on whatever
    device the tensors are on.  ``(p, pv, ub, free, bracket, escape)``,
    indices int64, masks bool.  It serves ``fused_impl="xla"`` engines;
    the kernel wrapper below never falls back to it on the card."""
    return _place_plain(x_hi, x_lo, segk_hi, segk_lo, slope_hi, slope_lo,
                        icept_hi, icept_lo, slot_hi, slot_lo, link_offsets,
                        link_hi, link_lo, n_slots=n_slots)


def ingest_place(x_hi, x_lo, segk_hi, segk_lo, slope_hi, slope_lo,
                 icept_hi, icept_lo, slot_hi, slot_lo, link_offsets,
                 link_hi, link_lo, *, n_slots: int):
    """One launch of the ingest-place kernel: ``(p, pv, ub, flags)``
    int32 per key of ``x_hi``/``x_lo``.  CPU tensors run
    ``ingest_place_plain``; CUDA tensors launch the kernel or raise."""
    args = (x_hi, x_lo, segk_hi, segk_lo, slope_hi, slope_lo, icept_hi,
            icept_lo, slot_hi, slot_lo, link_offsets, link_hi, link_lo)
    dev = _check(args)
    if dev.type == "cpu":
        return ingest_place_plain(*args, n_slots=n_slots)
    if dev.type != "cuda":
        raise ValueError(f"ingest_place runs on cuda or cpu, not {dev}")
    return _launch(args, dev, n_slots=n_slots)


ingest_place.launches = 0


def _launch(args, dev, *, n_slots: int):
    """One launch: the four outputs are views of one int32 buffer."""
    fn = _build.entry("ingest_place", "p" * 14 + "i" * 8)
    n = args[0].shape[0]
    buf = torch.empty(4 * n, dtype=torch.int32, device=dev)
    segk_lo, slot_lo, link_hi, link_lo = args[3], args[9], args[11], args[12]
    err = _build.launch(
        fn, dev, *[t.data_ptr() for t in args], buf.data_ptr(), n,
        args[2].shape[0], args[8].shape[0], link_hi.shape[0], n_slots,
        int(segk_lo.shape[0] > 0), int(slot_lo.shape[0] > 0),
        int(link_lo.shape[0] > 0))
    if err != 0:
        raise RuntimeError(f"ingest_place kernel launch failed: CUDA error "
                           f"{err}")
    ingest_place.launches += 1
    return buf.view(4, n).unbind(0)


# ---------------------------------------------------------------------------
# the single-dispatch fused ingest graph
# ---------------------------------------------------------------------------


def _sort2(hi, lo):
    """Stable lexicographic sort by (hi, lo): the permutation.  Two
    stable sorts, least significant key first (``lax.sort(num_keys=2,
    is_stable=True)``).  Keys carry no -0.0 (``split_key_pair`` never
    yields one), so torch's order equals lax.sort's total order."""
    o_lo = torch.sort(lo, stable=True).indices
    return o_lo[torch.sort(hi[o_lo], stable=True).indices]


def _set_drop(buf, idx, vals):
    """``buf.at[idx].set(vals, mode="drop")`` in place: indices at or
    past the end are dropped."""
    keep = idx < buf.shape[0]
    buf[idx[keep]] = vals[keep]
    return buf


def _reverse_pair_min(hi, lo):
    """Suffix min in pair order (the reverse ``associative_scan`` of
    ``_p_min``).  The combine only picks one of its inputs, so a
    reverse cummin over the exact f64 recombination (pair-exact keys)
    picks the same pair."""
    k = hi.double() + lo.double()
    idx = torch.cummin(k.flip(0), dim=0).indices.flip(0)
    idx = k.shape[0] - 1 - idx
    return hi[idx], lo[idx]


def fused_ingest_body(
    x_hi, x_lo,                       # (B,) f32 pair, +inf padded
    pay_lo, pay_hi,                   # (B,) i32 payload pair (-1 padded)
    segk_hi, segk_lo,                 # (Kpad,) segment tables
    slope_hi, slope_lo,
    icept_hi, icept_lo,
    slot_hi, slot_lo,                 # (Mpad,) frozen slot keys
    spay_lo, spay_hi,                 # (Mpad,) i32 slot payload pair
    link_offsets,                     # (O,) i32 CSR offsets (tail=total)
    link_hi, link_lo,                 # (Lpad,) chain keys (+inf padded)
    lpay_lo, lpay_hi,                 # (Lpad,) i32 chain payload pair
    rank_table,                       # (R+1,) i32 fused-lookup rank rows
    rank_bounds_hi, rank_bounds_lo,   # (R+1,) f32 pair of bucket bounds
    rank_scale,                       # (3,) f32 (kmin_hi, kmin_lo, scale)
    elo, ehi,                         # (k_pad,) f32 per-seg window bounds
    *,
    n_slots: int,
    max_chain: int,
    key_wide: bool,
    use_kernel: bool = True,
):
    """The single-dispatch §5.3 ingest graph (the reference's
    ``fused_ingest_body``, same stages, same outputs): stage 1 is one
    ``ingest_place`` call — the kernel on CUDA, its plain version on
    the CPU — or, with ``use_kernel=False`` (the counterpart of the
    reference's ``use_pallas=False``), ``ingest_place_graph``.  The
    batch's ``reasons`` bitmask is read back once; every
    state output is the new image when it is 0 and the input buffer
    untouched otherwise (so an aborted batch computes no scatters).

    Returns ``(p, pv, ub, free, bracket, escape, ok, reasons, n_slot,
    n_chain, seg, dlt, slot_hi, slot_lo, spay_lo, spay_hi,
    link_offsets, link_hi, link_lo, lpay_lo, lpay_hi, rank_table, elo,
    ehi)``: per-key tensors, host ``ok``/``reasons``/counts, then the
    gated state.
    """
    dev = x_hi.device
    B = x_hi.shape[0]
    m_pad = slot_hi.shape[0]
    O = link_offsets.shape[0]
    l_pad = link_hi.shape[0]
    k_pad = segk_hi.shape[0]
    iota = torch.arange(B, device=dev)
    inf = float("inf")

    # ---- stage 1: placement primitives (the kernel or the graph) ------
    place_args = (x_hi, x_lo, segk_hi, segk_lo, slope_hi, slope_lo,
                  icept_hi, icept_lo, slot_hi, slot_lo, link_offsets,
                  link_hi, link_lo)
    if use_kernel:
        p, pv, ub, flags = ingest_place(*place_args, n_slots=n_slots)
        free, bracket, escape = split_flags(flags)
    else:
        p, pv, ub, free, bracket, escape = ingest_place_graph(
            *place_args, n_slots=n_slots)
    p, pv, ub = p.long(), pv.long(), ub.long()
    valid = torch.isfinite(x_hi)
    free &= valid
    bracket &= valid
    escape &= valid

    # ---- stage 2: batch key ranks + in-batch duplicate detection ------
    perm = _sort2(x_hi, x_lo)
    xs_hi, xs_lo = x_hi[perm], x_lo[perm]
    both_fin = torch.isfinite(xs_hi[1:]) & torch.isfinite(xs_hi[:-1])
    dup_batch = torch.any(both_fin & _p_eq(xs_hi[:-1], xs_lo[:-1],
                                           xs_hi[1:], xs_lo[1:]))
    rank = torch.empty(B, dtype=torch.int64, device=dev)
    rank[perm] = iota

    # ---- stage 3: closure-trivial partition + abort detection ---------
    pa = torch.where(valid, p, _I32MAX)
    o = torch.sort(pa, stable=True).indices
    ps_a, free_a = pa[o], free[o]
    eq = (ps_a[1:] == ps_a[:-1]) & (ps_a[1:] != _I32MAX)
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    isdup_s = torch.cat([eq, no]) | torch.cat([no, eq])
    grp_abort = torch.any(isdup_s & free_a)

    cand = free & bracket
    hard = valid & ~cand

    ubc = ub.clamp(0, m_pad - 1)
    slot_lo_r = _lo(slot_lo, slot_hi)
    bdup_any = torch.any(valid & (ub >= 0) & _p_eq(
        slot_hi[ubc], slot_lo_r[ubc], x_hi, x_lo))

    c_abort = torch.any(hard & (ub < 0))

    # D1 (chain capture)
    runmax = torch.full((n_slots + 1,), -1, dtype=torch.int64, device=dev)
    runmax.scatter_reduce_(0, torch.where(hard, ub + 1, 0),
                           torch.where(hard, rank, -1), "amax",
                           include_self=True)
    d1_any = torch.any(cand & (rank < runmax[(pv + 1).clamp(0, n_slots)]))

    # D4 (co-monotonicity)
    pc = torch.where(cand, p, _I32MAX)
    o = torch.sort(pc, stable=True).indices
    ps_c, rk_c = pc[o], rank[o]
    pv_c = torch.where(cand, pv, -2)[o]
    d4_any = torch.any((ps_c[1:] != _I32MAX) & (ps_c[:-1] != _I32MAX)
                       & (pv_c[1:] == pv_c[:-1]) & (rk_c[1:] <= rk_c[:-1]))

    # ---- stage 4: chain-arm counts + capacity checks ------------------
    cnt = torch.zeros(O, dtype=torch.int64, device=dev)
    cnt.index_add_(0, torch.where(hard, ub + 1, 0), hard.long())
    n_chain = hard.sum()
    n_slot = cand.sum()
    offs = link_offsets.long()
    L_old = offs[n_slots]
    ub1 = (ub + 1).clamp(0, O - 1)
    old_len = offs[ub1] - offs[ub.clamp(0, O - 1)]
    chain_over = torch.any(hard & (old_len + cnt[ub1] > max_chain))
    link_over = L_old + n_chain > l_pad

    # ---- stage 5: device CSR merge (the np.insert replacement) --------
    link_lo_r = _lo(link_lo, link_hi)
    ch_hi = torch.where(hard, x_hi, inf)
    ch_lo = torch.where(hard, x_lo, 0.0)
    o = _sort2(ch_hi, ch_lo)
    sh, sl_, spl, sph, jmask = ch_hi[o], ch_lo[o], pay_lo[o], pay_hi[o], \
        hard[o]
    pos = _bisect_pair(link_hi, link_lo_r, sh, sl_, _trips(l_pad),
                       strict=True) + 1
    posc = pos.clamp(0, l_pad - 1)
    edup_any = torch.any(jmask & (pos < L_old) & _p_eq(
        link_hi[posc], link_lo_r[posc], sh, sl_))

    reasons_t = torch.stack([
        torch.any(escape), dup_batch, grp_abort, bdup_any, c_abort, d1_any,
        d4_any, chain_over, link_over, edup_any]).long()
    reasons = int((reasons_t << torch.arange(10, device=dev)).sum().item())
    ok = reasons == 0

    # ---- stage 8: window-bound residuals (returned ungated) ----------
    seg = _bisect_pair(segk_hi, _lo(segk_lo, segk_hi), x_hi, x_lo,
                       _trips(k_pad), strict=False).clamp(0, k_pad - 1)
    y1 = slope_hi[seg] * (x_hi - segk_hi[seg]) + icept_hi[seg]
    dlt = p.float() - y1
    n_slot, n_chain = int(n_slot.item()), int(n_chain.item())
    head = (p.int(), pv.int(), ub.int(), free, bracket, escape, ok, reasons,
            n_slot, n_chain, seg.int(), dlt)
    if not ok:
        return head + (slot_hi, slot_lo, spay_lo, spay_hi, link_offsets,
                       link_hi, link_lo, lpay_lo, lpay_hi, rank_table, elo,
                       ehi)

    # stage 5, continued: merged link tables
    cj = torch.cumsum(jmask.long(), 0) - 1
    dst_new = torch.where(jmask, pos + cj, l_pad)
    pos_eff = torch.where(jmask, pos, l_pad + 1)  # sorted: jmask a prefix
    old_i = torch.arange(l_pad, device=dev)
    dst_old = old_i + torch.searchsorted(pos_eff, old_i, right=True)

    def merged(fill, old, new):
        buf = torch.full((l_pad,), fill, dtype=old.dtype, device=dev)
        _set_drop(buf, dst_old, old)
        return _set_drop(buf, dst_new, new)

    new_lhi = merged(inf, link_hi, sh)
    new_llo = merged(0.0, link_lo_r, sl_)
    new_lpl = merged(-1, lpay_lo, spl)
    new_lph = merged(-1, lpay_hi, sph)
    new_off = (offs + torch.cumsum(cnt, 0)).int()

    # ---- stage 6: slot arm — scatter + carried-key repair -------------
    nb_hi = torch.cat([slot_hi[1:], torch.full((1,), inf, device=dev)])
    nb_lo = torch.cat([slot_lo_r[1:], torch.zeros(1, device=dev)])
    occ_new = _p_lt(slot_hi, slot_lo_r, nb_hi, nb_lo)
    idx_c = torch.where(cand, p, m_pad)
    _set_drop(occ_new, idx_c, torch.ones_like(cand))
    sc_hi = _set_drop(slot_hi.clone(), idx_c, x_hi)
    sc_lo = _set_drop(slot_lo_r.clone(), idx_c, x_lo)
    new_shi, new_slo = _reverse_pair_min(
        torch.where(occ_new, sc_hi, inf), torch.where(occ_new, sc_lo, 0.0))
    new_pl = _set_drop(spay_lo.clone(), idx_c, pay_lo)
    new_ph = _set_drop(spay_hi.clone(), idx_c, pay_hi)

    # ---- stage 7: rank-row refresh against the NEW slot keys ----------
    r_size = rank_table.shape[0] - 1
    if key_wide:
        xb = (x_hi - rank_scale[0]) + (x_lo - rank_scale[1])
    else:
        xb = x_hi - rank_scale[0]
    b = torch.nan_to_num((xb * rank_scale[2]).clamp(0.0, float(r_size - 1)),
                         nan=0.0).long()
    rows = torch.cat([b - 1, b, b + 1]).clamp(0, r_size)
    rows_ok = valid.repeat(3) & (rows < r_size)
    vals = _bisect_pair(new_shi, new_slo, rank_bounds_hi[rows],
                        rank_bounds_lo[rows], _trips(m_pad),
                        strict=True) + 1
    new_rank = _set_drop(rank_table.clone(),
                         torch.where(rows_ok, rows, r_size + 1),
                         vals.to(rank_table.dtype))

    # ---- stage 8: window-bound widening for the inserted keys ---------
    segc = torch.where(cand, seg, k_pad)
    keep = segc < k_pad
    new_elo = elo.clone().scatter_reduce_(0, segc[keep], dlt[keep] - 1.0,
                                          "amin", include_self=True)
    new_ehi = ehi.clone().scatter_reduce_(0, segc[keep], dlt[keep] + 1.0,
                                          "amax", include_self=True)
    return head + (new_shi, new_slo, new_pl, new_ph, new_off, new_lhi,
                   new_llo, new_lpl, new_lph, new_rank, new_elo, new_ehi)


# ---------------------------------------------------------------------------
# Eq. 3 gap placement: kernel wrapper and plain version
# ---------------------------------------------------------------------------

_GAP_ARG_NAMES = ("keys_padded", "seg_first_key", "base", "x0", "scale")
GAP_CHUNK = 4096    # keys a CTA of csrc/gap_place.cu takes
GAP_ROW_CAP = 256   # table rows it stages for a chunk


def _check_gap(args):
    dev = _build.check_1d(args, _GAP_ARG_NAMES,
                          (torch.float32,) * len(_GAP_ARG_NAMES), "keys")
    k_pad = args[1].shape[0]
    if k_pad == 0:
        raise ValueError("the segment tables must be non-empty")
    if any(t.shape[0] != k_pad for t in args[2:]):
        raise ValueError("base, x0 and scale must match seg_first_key")
    return dev


def gap_place_plain(keys_padded, seg_first_key, base, x0, scale, *,
                    key_tile: int = 1024, seg_chunk: int = 512):
    """The kernel's function in plain torch ops on any device: Eq. 3
    target positions ``base[seg] + (x - x0[seg]) * scale[seg]`` with
    ``seg = searchsorted(seg_first_key, x, right) - 1``, clipped (the
    masked count of the reference's kernel: the table is sorted).
    ``key_tile`` / ``seg_chunk`` are the reference's tiling, accepted
    for its signature; one torch op per f32 step, so no FMA."""
    del key_tile, seg_chunk
    k_pad = seg_first_key.shape[0]
    seg = (torch.searchsorted(seg_first_key, keys_padded, right=True)
           - 1).clamp(0, k_pad - 1)
    return base[seg] + (keys_padded - x0[seg]) * scale[seg]


def gap_place_brackets(keys_padded, seg_first_key):
    """The brackets ``csrc/gap_place.cu`` routes in, per chunk of
    ``GAP_CHUNK`` keys, computed from its inputs with torch ops on any
    device: ``(lo, hi)``, the counts of segment first keys <= the
    chunk's least and greatest key (NaN skipped).  A chunk with ``lo ==
    hi`` lies in one segment and needs no search; the kernel stages the
    table rows ``[max(lo - 1, 0), min(hi, Kpad - 1)]`` when there are
    at most ``GAP_ROW_CAP`` of them."""
    x = keys_padded
    pad = (-x.shape[0]) % GAP_CHUNK
    x = torch.cat([x, x.new_full((pad,), float("nan"))]).view(-1, GAP_CHUNK)
    inf = float("inf")
    x_min = torch.where(x.isnan(), inf, x).amin(dim=1)
    x_max = torch.where(x.isnan(), -inf, x).amax(dim=1)
    return (torch.searchsorted(seg_first_key, x_min, right=True),
            torch.searchsorted(seg_first_key, x_max, right=True))


def gap_place(keys_padded, seg_first_key, base, x0, scale, *,
              key_tile: int = 1024, seg_chunk: int = 512):
    """One launch of the Eq. 3 kernel: f32 target positions for the
    sorted, +inf padded keys against the (Kpad,) tables of
    ``ops_gap.prepare_gap_tables``.  ``key_tile`` / ``seg_chunk`` are
    the reference's tiling (the padding ``gap_positions_device``
    applies), accepted for its signature.  CPU tensors run
    ``gap_place_plain``; CUDA tensors launch the kernel or raise.
    ``gap_place.launches`` counts kernel launches."""
    del key_tile, seg_chunk
    args = (keys_padded, seg_first_key, base, x0, scale)
    dev = _check_gap(args)
    if dev.type == "cpu":
        return gap_place_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"gap_place runs on cuda or cpu, not {dev}")
    fn = _build.entry("gap_place", "pppppp" + "ii")
    n = keys_padded.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=dev)
    err = _build.launch(fn, dev, *[t.data_ptr() for t in args],
                        out.data_ptr(), n, seg_first_key.shape[0])
    if err != 0:
        raise RuntimeError(f"gap_place kernel launch failed: CUDA error "
                           f"{err}")
    gap_place.launches += 1
    return out


gap_place.launches = 0
