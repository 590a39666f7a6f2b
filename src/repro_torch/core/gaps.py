"""Result-driven gap insertion and the gapped physical layout (paper §5).

Pipeline (``build_gapped``):

1. Learn a base mechanism with K segments on (x, y) — optionally on a
   sample (§5.4 "Combining Sampling and Gap Insertion").
2. **Result-driven position manipulation** (Eq. 3): per segment k, propose
   the hypothetical line through the gap-shifted endpoints; every key's
   target position is
   ``y^g = y_k1 + S_k + (x - x_k1) * (y_km - y_k1) (1 + rho) / (x_km - x_k1)``
   with ``S_k = sum of gaps inserted in earlier segments`` and gap budget
   ``rho * n`` overall.
3. Re-learn the mechanism on the gap-inserted pairs (x, y^g) — the data is
   now near-linear per segment, so the re-learned index is much more
   precise (this is the paper's information-bottleneck argument, §5.1).
4. **Physical key placement** (§5.2): place each key at its re-learned
   predicted slot ``round(M(x))``; prediction conflicts and monotonicity
   violations go to per-slot **linking arrays**; slot-key total order is
   maintained by giving unoccupied slots the key of the first occupied slot
   to their right ("empty payload sorts before non-empty").

Dynamic scenario (§5.3): inserts land on their predicted slot when it is
free and order-compatible (the gaps were *reserved in a data-dependent
way*, so this is the common case), otherwise they chain onto the upper-
bound slot's linking array.  Deletes/updates are local.  No retraining.

The frozen arrays (`slot_key`, `occupied`, CSR links) are exactly what the
jnp reference and the Pallas lookup kernel consume (``repro.kernels``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np

from .links import CSRLinks
from .mechanisms import PiecewiseLinearModel, _finalize_errors
from . import sampling as _sampling

__all__ = ["gap_positions", "GappedArray", "GapSnapshot", "build_gapped"]

_EMPTY = np.iinfo(np.int64).min  # payload marker for unoccupied slots


class _PinCell:
    """Shared refcount between a live ``GappedArray`` and the snapshots
    pinning its current arrays.  The live side checks ``count`` inside
    ``_invalidate`` (copy-on-write trigger); snapshots decrement on
    ``release`` so the auditor can prove no snapshot leaks."""

    __slots__ = ("count",)

    def __init__(self):
        self.count = 0


def _group_extreme(rids, vals, n_runs, fill, reducer):
    """Per-run extreme of ``vals`` grouped by run id (``fill`` for runs
    with no entries) — one argsort + reduceat over batch-sized arrays."""
    out = np.full(n_runs, fill)
    if rids.size:
        o = np.argsort(rids, kind="stable")
        r, v = rids[o], vals[o]
        starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
        out[r[starts]] = reducer.reduceat(v, starts)
    return out


def _seg_suffix_min(vals, segs):
    """Per-position min over the value suffix of its segment (positions
    ascending, segment ids non-decreasing and contiguous).

    Vectorized segmented reverse scan: dense value ranks plus an offset
    of n per segment make every later-segment entry unbeatable, so ONE
    global reverse ``minimum.accumulate`` realizes the per-segment
    reset, and the rank decodes back to the value."""
    n = vals.shape[0]
    if n == 0:
        return vals
    o = np.argsort(vals, kind="stable")
    rk = np.empty(n, np.int64)
    rk[o] = np.arange(n, dtype=np.int64)
    seg_d = np.cumsum(np.r_[True, segs[1:] != segs[:-1]]) - 1
    w = rk + seg_d * np.int64(n)
    wm = np.minimum.accumulate(w[::-1])[::-1]
    return vals[o[wm - seg_d * np.int64(n)]]


def gap_positions(
    x: np.ndarray,
    y: np.ndarray,
    plm: PiecewiseLinearModel,
    rho: float,
) -> np.ndarray:
    """Eq. 3 — target positions y^g for every key, fully vectorized.

    Segment boundaries come from ``plm`` (learned on (x, y) or a sample);
    anchoring points are each segment's first/last *present* key.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    seg = plm.segment_of(x)
    K = plm.n_segments
    # first/last data index per segment (segments may be empty under sampling)
    first = np.full(K, -1, np.int64)
    last = np.full(K, -1, np.int64)
    idx = np.arange(x.shape[0], dtype=np.int64)
    first = np.full(K, x.shape[0], np.int64)
    np.minimum.at(first, seg, idx)
    np.maximum.at(last, seg, idx)
    n = x.shape[0]
    present = first < n
    f_idx = np.minimum(first, n - 1)
    l_idx = np.clip(last, 0, n - 1)
    y_first = np.where(present, y[f_idx], 0.0)
    y_last = np.where(present, y[l_idx], 0.0)
    x_first = np.where(present, x[f_idx], 0.0)
    x_last = np.where(present, x[l_idx], 1.0)
    # gaps inserted inside segment j:  U_j = rho * (y_jm - y_j1)
    U = np.where(present, rho * (y_last - y_first), 0.0)
    S = np.concatenate([[0.0], np.cumsum(U)[:-1]])  # sum over j < k
    dx = np.where(x_last > x_first, x_last - x_first, 1.0)
    scale = (y_last - y_first) * (1.0 + rho) / dx
    yg = y_first[seg] + S[seg] + (x - x_first[seg]) * scale[seg]
    # monotonicity guard: numerical ties across segment boundaries
    return np.maximum.accumulate(yg)


@dataclasses.dataclass
class GappedArray:
    """First-level gapped array G + CSR linking arrays (paper §5.2).

    * ``slot_key[i]``: the total-order key of slot i.  Occupied slots hold
      ``min(A_i)``; unoccupied slots carry the key of the first occupied
      slot to their right (+inf past the last occupied slot).
    * ``payload[i]``: payload of the occupied slot's min key, or _EMPTY.
    * ``links``: ``CSRLinks`` — per-slot key-sorted chains stored natively
      as CSR (offsets / chain_keys / chain_payloads) arrays; the frozen
      device export is these arrays verbatim.
    * ``version``: monotone mutation counter — every dynamic op bumps it;
      the epoch-versioned ``repro.core.Index`` handle uses it to detect
      host/device divergence.
    """

    slot_key: np.ndarray           # (m,) float64
    occupied: np.ndarray           # (m,) bool
    payload: np.ndarray            # (m,) int64
    links: CSRLinks
    mech: object                   # re-learned mechanism (predicts slots)
    n_keys: int
    rho: float
    version: int = 0
    # live pin cell shared with outstanding ``GapSnapshot``s (refcount);
    # None when no snapshot pins the current arrays
    _pins: object = dataclasses.field(default=None, repr=False,
                                      compare=False)
    # build_gapped's cost breakdown {"learn_seconds", "place_seconds",
    # "n_fit"}: learn = base fit + Eq.3 targets + step-3 refit (O(n_s)
    # under sampling), place = physical placement + refinalize (O(n)
    # always).  None on restored / hand-built arrays.
    build_timings: object = dataclasses.field(default=None, repr=False,
                                              compare=False)

    # ------------------------------------------------------------------
    @property
    def n_slots(self) -> int:
        return int(self.slot_key.shape[0])

    @property
    def gap_fraction(self) -> float:
        return float(1.0 - self.occupied.mean())

    def link_stats(self) -> Tuple[int, int]:
        """(#chained keys, max chain length)."""
        return self.links.total, self.links.max_chain

    # ------------------------------------------------------------------
    # read path
    # ------------------------------------------------------------------
    def _upper_bound_slot(self, q: float) -> int:
        """Rightmost slot whose (total-order) key is <= q and occupied.

        Relies on the carried-key construction: the last slot with
        slot_key < q is always occupied; for slot_key == q the occupied
        slot is the last one of the equal run.
        """
        j = int(np.searchsorted(self.slot_key, q, side="right")) - 1
        while j >= 0 and not self.occupied[j]:
            j -= 1  # only possible at the very front (all-carried prefix)
        return j

    def lookup(self, q: float) -> Optional[int]:
        """Exact-match lookup -> payload or None (paper's read path)."""
        j = self._upper_bound_slot(q)
        if j < 0:
            return None
        if self.slot_key[j] == q:
            return int(self.payload[j])
        return self.links.find_payload(j, q)  # bounded chain bisect

    def _csr(self):
        """CSR link tables — free: they ARE the canonical storage."""
        return self.links.csr()

    def _invalidate(self):
        self.version += 1
        pins = self._pins
        if pins is not None and pins.count > 0:
            # copy-on-write: every mutator calls _invalidate() BEFORE
            # touching storage, so pinned snapshots keep the exact
            # pre-mutation arrays while the live side writes into fresh
            # private copies.  Paid once per pin, not once per mutation
            # (the cell detaches here; a new pin installs a new cell).
            self.slot_key = self.slot_key.copy()
            self.occupied = self.occupied.copy()
            self.payload = self.payload.copy()
            self.links.unshare()
            self._pins = None
        elif pins is not None:
            self._pins = None  # every snapshot released: nothing to copy

    # ------------------------------------------------------------------
    # snapshot pinning (serving-side isolation)
    # ------------------------------------------------------------------
    def pin_snapshot(self) -> "GapSnapshot":
        """Pin the current arrays into an immutable ``GapSnapshot``.

        O(1): no copies are made here — the snapshot references the live
        arrays by identity, and the first mutation after the pin pays a
        single copy-on-write inside ``_invalidate``.  Lookups through
        the snapshot are bit-identical to a quiesced lookup at this
        version forever, regardless of concurrent mutation of the live
        array.  Call ``release()`` when done serving from it."""
        self.links.flush()  # pending overlay empties before sharing CSR
        if self._pins is None:
            self._pins = _PinCell()
        self._pins.count += 1
        self.links.mark_shared()
        offsets, lkeys, lpays = self.links.csr()
        return GapSnapshot(self, offsets, lkeys, lpays, self._pins)

    def lookup_batch(self, qs: np.ndarray, bounded: bool = True,
                     full: bool = False) -> np.ndarray:
        """Vectorized batch lookup; -1 for misses (numpy kernel reference).

        ``bounded`` uses the mechanism's prediction + exponential search
        (the paper's correction step — cost scales with log|err|, which
        is where gap insertion's precision pays off); otherwise a plain
        full-array binary search.  ``full=True`` returns the triple
        ``(payloads, slots, found)`` — slots are first-level upper
        bounds, found covers slot AND chain hits (the typed-result
        contract of ``repro.core.Index.lookup``).
        """
        from . import sampling as _s

        qs = np.asarray(qs, np.float64)
        if bounded and getattr(self.mech, "plm", None) is not None:
            y_hat = self.mech.predict(qs)
            j, _probes = _s.exponential_search(self.slot_key, qs, y_hat)
        else:
            j = np.searchsorted(self.slot_key, qs, side="right") - 1
        out = np.full(qs.shape[0], -1, np.int64)
        ok = j >= 0
        hit = ok & (np.where(ok, self.slot_key[np.maximum(j, 0)], np.nan) == qs)
        out[hit] = self.payload[j[hit]]
        resolved = hit.copy()
        # vectorized chain scan over the CSR link tables for the misses
        miss = np.flatnonzero(ok & ~hit)
        if miss.size:
            offsets, lkeys, lpays = self._csr()
            start = offsets[j[miss]]
            end = offsets[j[miss] + 1]
            live = np.flatnonzero(end > start)
            start, end = start[live], end[live]
            midx = miss[live]
            t = 0
            max_t = int(np.max(end - start)) if live.size else 0
            while t < max_t and midx.size:
                idx = start + t
                in_chain = idx < end
                found = in_chain & (lkeys[np.minimum(idx, len(lkeys) - 1)]
                                    == qs[midx])
                out[midx[found]] = lpays[idx[found]]
                resolved[midx[found]] = True
                keep = in_chain & ~found
                start, end, midx = start[keep], end[keep], midx[keep]
                t += 1
        if full:
            return out, j.astype(np.int64), resolved
        return out

    def contains_batch(self, qs: np.ndarray) -> np.ndarray:
        """Vectorized membership test (present even when the stored
        payload is a sentinel like -1, which ``lookup_batch`` conflates
        with a miss)."""
        qs = np.asarray(qs, np.float64)
        j = np.searchsorted(self.slot_key, qs, side="right") - 1
        ok = j >= 0
        found = ok & (self.slot_key[np.maximum(j, 0)] == qs)
        miss = np.flatnonzero(ok & ~found)
        if miss.size:
            offsets, lkeys, _ = self._csr()
            start = offsets[j[miss]]
            end = offsets[j[miss] + 1]
            for t in range(int(np.max(end - start))):
                idx = np.minimum(start + t, max(len(lkeys) - 1, 0))
                hit = (start + t < end) & (lkeys[idx] == qs[miss])
                found[miss[hit]] = True
            # (bounded by the longest chain; chains are short by §5.2)
        return found

    # ------------------------------------------------------------------
    # dynamic path (paper §5.3) — host-side mutation, no retraining
    # ------------------------------------------------------------------
    def _prev_occupied(self, i: int) -> int:
        j = i
        while j >= 0 and not self.occupied[j]:
            j -= 1
        return j

    def _next_occupied(self, i: int) -> int:
        m = self.n_slots
        j = i
        while j < m and not self.occupied[j]:
            j += 1
        return j  # == m when none

    def insert(self, key: float, payload: int) -> str:
        """Insert via predicted position.  Returns 'slot'|'chain' (path taken)."""
        self._invalidate()
        m = self.n_slots
        p = int(np.clip(np.rint(self.mech.predict(np.array([key]))[0]), 0, m - 1))
        return self._insert_at(key, payload, p)

    def _insert_at(self, key: float, payload: int, p: int) -> str:
        """insert() body with the predicted slot already computed.

        caller-invalidates: both call sites (``insert``,
        ``insert_batch``) bump the epoch via ``_invalidate()`` before
        dispatching here.

        Chain writes land in the CSRLinks pending overlay (O(chain)),
        merged into the flat tables lazily — scalar insert loops and
        insert_batch's contested replay never pay a per-insert O(m)
        offsets shift.
        """
        links = self.links
        m = self.n_slots
        if not self.occupied[p]:
            prev = self._prev_occupied(p)
            nxt = self._next_occupied(p)
            # order check must include the previous slot's chain maximum
            # (total-order invariant: max(A_{i-1}) < G(i), paper §5.3)
            prev_max = -np.inf
            if prev >= 0:
                prev_max = max(float(self.slot_key[prev]),
                               links.chain_max_key(prev))
            prev_ok = prev < 0 or prev_max < key
            next_ok = nxt >= m or self.slot_key[nxt] > key
            if prev_ok and next_ok:
                self.occupied[p] = True
                self.payload[p] = payload
                # carried keys: slots (prev, p] now see `key` as next occupied
                self.slot_key[prev + 1 : p + 1] = key
                self.n_keys += 1
                return "slot"
        # chain onto the upper-bound slot (or become the new global min)
        ub = self._upper_bound_slot(key)
        if ub < 0:
            nxt = self._next_occupied(0)
            if nxt >= m:  # empty structure: take slot p
                self.occupied[p] = True
                self.payload[p] = payload
                self.slot_key[: p + 1] = key
                self.n_keys += 1
                return "slot"
            # new global minimum: displace the current min into the chain
            old_key = float(self.slot_key[nxt])
            old_payload = int(self.payload[nxt])
            links.insert_one(nxt, old_key, old_payload)
            self.payload[nxt] = payload
            self.slot_key[: nxt + 1] = key
            self.n_keys += 1
            return "chain"
        if self.slot_key[ub] == key:
            raise KeyError(f"duplicate key {key!r}")
        links.insert_one(ub, key, payload)  # raises on duplicates
        self.n_keys += 1
        return "chain"

    def delete(self, key: float) -> bool:
        """Delete a key (paper §5.3).  Returns True if present."""
        self._invalidate()
        ub = self._upper_bound_slot(key)
        if ub < 0:
            return False
        if self.slot_key[ub] == key:
            if self.links.chain_len(ub):  # promote chain min into the slot
                k2, p2 = self.links.pop_front(ub)
                prev = self._prev_occupied(ub - 1)
                self.slot_key[prev + 1 : ub + 1] = k2
                self.payload[ub] = p2
            else:  # unoccupy; carried keys point at next occupied
                self.occupied[ub] = False
                self.payload[ub] = _EMPTY
                nxt = self._next_occupied(ub)
                nk = self.slot_key[nxt] if nxt < self.n_slots else np.inf
                prev = self._prev_occupied(ub)
                self.slot_key[prev + 1 : nxt] = nk
            self.n_keys -= 1
            return True
        if self.links.remove(ub, key):
            self.n_keys -= 1
            return True
        return False

    def update(self, key: float, payload: int) -> bool:
        """Reset the payload of an existing key (paper §5.3)."""
        self._invalidate()
        ub = self._upper_bound_slot(key)
        if ub < 0:
            return False
        if self.slot_key[ub] == key:
            self.payload[ub] = payload
            return True
        return self.links.set_payload(ub, key, payload)

    def update_batch(self, keys: np.ndarray, payloads: np.ndarray) -> int:
        """Batched payload update: slot hits land in ONE vectorized
        scatter (duplicate keys: last write wins, as sequentially);
        chain hits fall back to per-key ``set_payload``.  One epoch
        bump for the whole batch.  Returns the number of keys updated.
        """
        keys = np.asarray(keys, np.float64)
        payloads = np.asarray(payloads, np.int64)
        if keys.shape[0] == 0:
            return 0
        self._invalidate()
        ub = np.searchsorted(self.slot_key, keys,
                             side="right").astype(np.int64) - 1
        ok = ub >= 0
        hit = ok & (self.slot_key[np.maximum(ub, 0)] == keys)
        self.payload[ub[hit]] = payloads[hit]
        n = int(np.count_nonzero(hit))
        for i in np.flatnonzero(ok & ~hit):
            n += bool(self.links.set_payload(int(ub[i]), float(keys[i]),
                                             int(payloads[i])))
        return n

    # ------------------------------------------------------------------
    # batched dynamic path — state-identical to sequential insert()
    # ------------------------------------------------------------------
    def _repair_carried(self):
        """One-shot carried-key repair: every unoccupied slot gets the key
        of the first occupied slot to its right (+inf past the last).
        Occupied keys are ascending, so the suffix minimum IS the nearest
        occupied key to the right — one O(m) reverse cummin.

        caller-invalidates: only reached from ``insert_batch``, after
        its leading ``_invalidate()``."""
        x = np.where(self.occupied, self.slot_key, np.inf)
        self.slot_key = np.minimum.accumulate(x[::-1])[::-1]

    def batch_chunk(self) -> int:
        """``insert_batch``'s chunking threshold at the current
        occupancy.  Precomputed placements only serve batches up to ONE
        chunk (later chunks repartition against mutated state), so the
        device ingest-place path gates on this too."""
        return max(4096, min(16384,
                             int(np.count_nonzero(self.occupied)) // 8))

    def placement_primitives(self, keys: np.ndarray,
                             p: Optional[np.ndarray] = None) -> dict:
        """Per-key placement primitives against the CURRENT state — the
        inputs of ``insert_batch``'s order-equivalence partition:

        * ``p``       — predicted slot, ``clip(rint(M(x)), 0, m-1)``;
        * ``free``    — predicted slot unoccupied;
        * ``ub``      — rightmost occupied slot whose key is <= the
          batch key (-1 below all occupied keys).  Runs are named by
          their left-boundary slot index, so this is the key-run id AND
          the §5.3 chain target in one;
        * ``pv``      — the predicted slot's run id: the previous
          occupied slot (-1 for the leading run), recovered from the
          carried-key construction with one searchsorted (a free slot's
          carried key marks exactly where its run starts);
        * ``bracket`` — free AND strictly inside the run's key interval
          (left-boundary key incl. its chain max < key < carried next
          key): the key could take its predicted slot.

        The device ingest-placement backend (``repro.kernels.ops_gap``)
        computes the same dict against the frozen device arrays; this
        host path is the oracle the device variants must match
        bit-for-bit (asserted in tests/test_ingest_place.py).
        """
        keys = np.asarray(keys, np.float64)
        m = self.n_slots
        if p is None:
            p = np.clip(np.rint(self.mech.predict(keys)), 0, m - 1).astype(
                np.int64)
        free = ~self.occupied[p]
        ub = np.searchsorted(self.slot_key, keys,
                             side="right").astype(np.int64) - 1
        # carried key of a free slot == its run's next occupied key; the
        # run's slots (pv, next_occ] all carry it, so 'left' lands at
        # pv + 1 (for occupied p this degenerates to its own prev slot,
        # harmless: pv is only consumed for free keys)
        nx_key = self.slot_key[p]
        pv = np.searchsorted(self.slot_key, nx_key,
                             side="left").astype(np.int64) - 1
        prev_max = np.where(pv >= 0, self.slot_key[np.maximum(pv, 0)],
                            -np.inf)
        if self.links:
            # CSR chains: the per-slot max is chain_keys[offsets[i+1]-1]
            # — one vectorized gather instead of a per-key python scan
            sel = np.flatnonzero(free & (pv >= 0))
            if sel.size:
                cm = self.links.chain_max_keys(pv[sel])
                np.maximum.at(prev_max, sel, cm)
        bracket = free & (prev_max < keys) & (keys < nx_key)
        return {"p": p, "free": free, "pv": pv, "ub": ub,
                "bracket": bracket}

    def verify_placements(self, keys: np.ndarray, prims: dict) -> np.ndarray:
        """Host-side f64 certification of device-computed placement
        primitives, for wide key sets the per-key pair-exactness gate
        refuses but whose pair mapping is ALIAS-FREE over the stored
        set: returns the mask of rows whose ``p``/``ub``/``pv`` could
        not be certified (the caller recomputes those per-key), and
        overwrites ``free``/``bracket`` in place with exact host
        recomputations (cheap gathers once ``p`` is certified — cheaper
        than certifying the device's pair-rounded interval tests).

        The checks are sound, not heuristic: ``p`` is compared against
        the exact host prediction, and ``ub``/``pv`` are accepted only
        when the f64 slot keys bracket them exactly the way their
        defining ``searchsorted`` would — a bracketing check uniquely
        identifies the searchsorted answer, duplicate (carried) slot
        key values included.
        """
        keys = np.asarray(keys, np.float64)
        m = self.n_slots
        sk = self.slot_key
        p = np.asarray(prims["p"], np.int64)
        ub = np.asarray(prims["ub"], np.int64)
        pv = np.asarray(prims["pv"], np.int64)
        p_true = np.clip(np.rint(self.mech.predict(keys)), 0,
                         m - 1).astype(np.int64)
        bad = p != p_true
        # ub: rightmost slot with key <= k  <=>  sk[ub] <= k < sk[ub+1]
        # (sentinels: ub == -1 iff k < sk[0]; +inf above the top slot)
        lo_ok = np.where(ub >= 0, sk[np.clip(ub, 0, m - 1)] <= keys,
                         keys < sk[0])
        hi = np.where(ub + 1 < m, sk[np.clip(ub + 1, 0, m - 1)], np.inf)
        bad |= ~((ub >= -1) & (ub < m) & lo_ok & (keys < hi))
        # pv: searchsorted(sk, nx, 'left') - 1  <=>  sk[pv] < nx <= sk[pv+1]
        nx = sk[p_true]
        pl_ok = np.where(pv >= 0, sk[np.clip(pv, 0, m - 1)] < nx, True)
        ph = np.where(pv + 1 < m, sk[np.clip(pv + 1, 0, m - 1)], np.inf)
        bad |= ~((pv >= -1) & (pv < m) & pl_ok & (nx <= ph))
        # free/bracket: exact recomputation (same as placement_primitives)
        free = ~self.occupied[p_true]
        prev_max = np.where(pv >= 0, sk[np.clip(pv, 0, m - 1)], -np.inf)
        if self.links:
            sel = np.flatnonzero(free & (pv >= 0) & ~bad)
            if sel.size:
                cm = self.links.chain_max_keys(pv[sel])
                np.maximum.at(prev_max, sel, cm)
        prims["free"] = free
        prims["bracket"] = free & (prev_max < keys) & (keys < nx)
        return bad

    def insert_batch(self, keys: np.ndarray, payloads: np.ndarray,
                     placements: Optional[dict] = None) -> dict:
        """Batched §5.3 inserts; final state is bit-identical to calling
        ``insert()`` per key in order (slot_key/occupied/payload/links).

        Three classes, partitioned by an order-equivalence argument on
        pre-batch *gap runs* (the free-slot run between two occupied
        slots — every check and write of ``insert()`` touches only the
        runs of a key's predicted slot and of its key value):

        A. **slot-easy** — predicted slot free and unique, key bracketed
           by the run's pre-batch boundary keys, and no hard key can
           flap its order checks (see the per-key demotion rules below):
           every arrival order occupies the same slots, so they are
           applied vectorized, with ONE carried-key repair at the end
           (replacing the per-insert slice writes and ``while`` scans).
           A *collision group* (several keys predicting the same free
           slot) joins this class through its first arrival — the
           winner, which takes the slot under every interleaving; the
           later arrivals always find the slot occupied and become
           order-commuting chain appends (onto the winner's slot above
           the winner's key, onto the run's left boundary below it),
           provided the group has the run to itself and every member is
           bracketed by the run's boundary keys.
        B. **chain-certain** — predicted slot occupied pre-batch (it can
           only stay occupied), so the chain target is the key-run's
           left boundary, and chains are sorted sets, so appends
           commute; applied as ONE vectorized CSR merge.
        C. **contested** — everything else: re-run through the same
           partition against the updated state (the argument applies
           recursively), with a scalar arrival-order replay for small
           or non-shrinking remainders.

        Per-key demotion (closure to a fixed point): a class-A candidate
        ``a`` (run R, slot p_a, key k_a) is demoted exactly when a hard
        key can observe or perturb its checks under SOME interleaving —

        * **D1 chain capture**: a hard key h chaining into R by key
          order (class B, or any contested key with key-run R) with
          k_h > k_a would chain onto a's slot once a occupies, but onto
          the run boundary before — demote a when k_a < max hard key of
          R.  (Candidates above every hard key are safe: a chain append
          below k_a can never break a's order checks.)
        * **D2 occupier shadow**: a hard FREE key h that could occupy in
          R (bracketed) at a slot p_h >= p_a with k_h < k_a makes a's
          slot checks order-dependent — demote a when the slot-suffix
          min of such keys undercuts k_a.  (The mirrored corner,
          p_h <= p_a with k_h > k_a, is already D1.)
        * **D3 leading-run displacement**: any hard key that can reach
          the global-min displacement path (key below all occupied
          keys) rewrites the leading run's boundary slot in BOTH key
          directions — demote every candidate of run -1.
        * **D4 candidate co-monotonicity**: two candidates sharing a run
          whose slot order disagrees with their key order flap each
          other — demote both (recomputed over the LIVE candidate set
          each round, so pairs separated by demoted keys still meet).

        Class-B keys are refined per-key too: a predicted-occupied key
        k_b stays class B unless a hard free occupier with key < k_b
        shares its run (only an occupation below k_b can move its chain
        target; chain-only contested keys and appends commute).  The
        demotion closure iterates until no rule fires, so classes A/B
        and the alive collision groups provably cannot observe the
        contested replay's intermediate states.  Duplicate keys raise
        ``KeyError`` just like ``insert()`` (state of the current batch
        is unspecified on raise, as with a partial sequential loop).

        ``placements`` optionally injects precomputed
        ``placement_primitives`` (the device ingest-placement path);
        they must describe the CURRENT pre-batch state, so they are
        consumed by the first chunk only and never by recursive rounds.

        Returns ``{"slot": n, "chain": n, "contested": n}`` with the
        invariant ``slot + chain == len(keys)`` (every key lands on
        exactly one §5.3 path) and ``contested`` counting the keys that
        visited the scalar arrival-order replay, across ALL recursive
        rounds (the epoch-versioned ``Index`` handle uses its fraction
        as a refreeze signal).
        """
        keys = np.asarray(keys, np.float64)
        payloads = np.asarray(payloads, np.int64)
        n_b = keys.shape[0]
        if n_b == 0:
            return {"slot": 0, "chain": 0, "contested": 0}
        if n_b == 1:
            path = self.insert(float(keys[0]), int(payloads[0]))
            return {"slot": int(path == "slot"),
                    "chain": int(path == "chain"), "contested": 0}
        # chunk large batches: cross-key run contention grows
        # ~quadratically with batch size while the per-chunk vectorized
        # cost is only ~O(m); sequential equality composes over chunks
        chunk = self.batch_chunk()
        if n_b > chunk:
            counts = {"slot": 0, "chain": 0, "contested": 0}
            for s in range(0, n_b, chunk):
                sub_pl = None
                if placements is not None and s == 0:
                    sub_pl = {k: v[:chunk] for k, v in placements.items()}
                c = self.insert_batch(keys[s:s + chunk],
                                      payloads[s:s + chunk],
                                      placements=sub_pl)
                counts["slot"] += c["slot"]
                counts["chain"] += c["chain"]
                counts["contested"] += c["contested"]
            return counts
        self._invalidate()
        if not np.any(self.occupied):  # degenerate: empty structure
            m = self.n_slots
            p0 = np.clip(np.rint(self.mech.predict(keys)), 0,
                         m - 1).astype(np.int64)
            counts = {"slot": 0, "chain": 0, "contested": 0}
            for i in range(n_b):
                counts[self._insert_at(float(keys[i]), int(payloads[i]),
                                       int(p0[i]))] += 1
            return counts
        pr = (placements if placements is not None
              else self.placement_primitives(keys))
        p = np.asarray(pr["p"], np.int64)
        free = np.asarray(pr["free"], bool)
        pv = np.asarray(pr["pv"], np.int64)
        ub = np.asarray(pr["ub"], np.int64)
        bracket = np.asarray(pr["bracket"], bool)

        # compressed run ids over the (<= 2B) runs the batch touches;
        # rid_p is only meaningful for free keys (clip keeps the masked
        # gathers in range for occupied ones)
        uniq_runs = np.unique(np.concatenate([pv[free], ub]))
        n_runs = int(uniq_runs.size)
        rid_p = np.minimum(np.searchsorted(uniq_runs, pv), n_runs - 1)
        rid_k = np.searchsorted(uniq_runs, ub)

        # --- collision groups ------------------------------------------
        order = np.argsort(p, kind="stable")  # stable: arrival order
        po = p[order]
        dup_adj = np.r_[False, po[1:] == po[:-1]]
        is_dup = np.zeros(n_b, bool)
        is_dup[order] = dup_adj | np.r_[dup_adj[1:], False]
        # collision groups: free keys sharing a predicted slot; the first
        # arrival (stable sort order) is the slot winner
        is_winner = np.zeros(n_b, bool)
        is_loser = np.zeros(n_b, bool)
        w_of = np.arange(n_b)
        gsel_o = is_dup[order] & free[order]
        if np.any(gsel_o):
            gpos = np.flatnonzero(gsel_o)
            gstart = np.r_[True, po[gpos][1:] != po[gpos][:-1]]
            winners = order[gpos[gstart]]
            is_winner[winners] = True
            w_of[order[gpos]] = np.repeat(winners,
                                          np.diff(np.r_[
                                              np.flatnonzero(gstart),
                                              gpos.size]))
            is_loser[order[gpos]] = ~is_winner[order[gpos]]
        cand = free & (~is_dup | is_winner) & bracket

        # group validity: every member bracketed in the winner's run,
        # no duplicate keys inside the group, no members below the
        # winner in the leftmost run (that is the global-min path), and
        # the run exclusively theirs (no singleton candidates, no other
        # groups) — under those conditions the winner takes the slot and
        # every loser's chain target is fixed under all interleavings
        group_ok = np.ones(n_b, bool)  # indexed by winner
        if np.any(is_winner):
            member = is_winner | is_loser
            bad_w = np.unique(w_of[member & (
                ~bracket | (pv != pv[w_of])
                | ((pv == -1) & (keys < keys[w_of]))
            )])
            group_ok[bad_w] = False
            mo = np.lexsort((keys, p))
            msel = member[mo]
            mp, mk = p[mo][msel], keys[mo][msel]
            kdup = np.r_[False, (mp[1:] == mp[:-1]) & (mk[1:] == mk[:-1])]
            group_ok[w_of[mo[msel][kdup]]] = False
            groups_per_run = np.bincount(rid_p[is_winner],
                                         minlength=n_runs)
            singles_per_run = np.bincount(
                rid_p[cand & ~is_winner], minlength=n_runs)
            crowded = (groups_per_run[rid_p] > 1) | \
                (singles_per_run[rid_p] > 0)
            group_ok &= ~(is_winner & crowded)
            cand &= ~(is_winner & ~group_ok)

        # duplicate of an occupied slot's own key -> KeyError, as
        # insert() (sequentially EVERY such key raises at its arrival:
        # occupied-slot keys only leave by deletion; state of the
        # partial batch is unspecified on raise).  Checked for all keys
        # because the vectorized chain merge only dedups against CHAIN
        # keys, not the first-level array.
        b_dup = (ub >= 0) & (self.slot_key[np.maximum(ub, 0)] == keys)
        if np.any(b_dup):
            raise KeyError(f"duplicate key {keys[np.flatnonzero(b_dup)[0]]!r}")

        # --- per-key demotion closure (rules D1-D4, see docstring) -----
        while True:
            loser_alive = is_loser & group_ok[w_of] & cand[w_of]
            hard = ~cand & ~loser_alive  # class B/C-bound keys
            # D1: max hard key chaining into each run (by key-run)
            max_h = _group_extreme(rid_k[hard], keys[hard], n_runs,
                                   -np.inf, np.maximum)
            demote = cand & (keys < max_h[rid_p])
            # D3: a hard key below all occupied keys can displace the
            # leading run's boundary slot
            if np.any(hard & (ub == -1)):
                demote |= cand & (pv == -1)
            # D2: hard occupier at a slot >= the candidate's with a
            # smaller key (slot-suffix min per run, slot-sorted)
            occh = hard & free & bracket
            if np.any(occh):
                usel = cand | occh
                ui = order[usel[order]]
                hk = np.where(occh[ui], keys[ui], np.inf)
                sm = _seg_suffix_min(hk, rid_p[ui])
                d2u = cand[ui] & (sm < keys[ui])
                demote[ui[d2u]] = True
            # D4: candidate pairs in one run whose slot order disagrees
            # with their key order (recomputed on the live set — pairs
            # separated by demoted keys become adjacent)
            ai = order[cand[order]]
            if ai.size > 1:
                same = rid_p[ai][1:] == rid_p[ai][:-1]
                badp = same & (keys[ai][1:] <= keys[ai][:-1])
                demote[ai[1:][badp]] = True
                demote[ai[:-1][badp]] = True
            if not np.any(demote):
                break
            cand &= ~demote

        # --- class B / C partition (per-key, see docstring) ------------
        # Chain-certain covers BOTH hard shapes that provably always
        # chain at their pre-batch upper bound: predicted-slot-occupied
        # keys (classic class B) AND free-but-bracket-failing keys —
        # their order checks can only tighten as inserts land (new
        # occupants carry keys above the failing boundary, displacement
        # keeps the boundary max), so they can never occupy.  The only
        # hazard left for either shape is a hard occupier BELOW them in
        # their key-run (an occupation that could capture the chain
        # target mid-replay) — the min_o guard.
        loser_alive = is_loser & group_ok[w_of] & cand[w_of]
        hard = ~cand & ~loser_alive
        occh = hard & free & bracket
        min_o = _group_extreme(rid_p[occh], keys[occh], n_runs, np.inf,
                               np.minimum)
        b_mask = hard & ~(free & bracket) & (ub >= 0) & \
            ~(min_o[rid_k] < keys)
        c_mask = hard & ~b_mask

        # --- apply A: vectorized occupation + one carried repair -------
        ai = np.flatnonzero(cand)
        n_slot = int(ai.size)
        if n_slot:
            pe = p[ai]
            self.occupied[pe] = True
            self.payload[pe] = payloads[ai]
            self.slot_key[pe] = keys[ai]
            self._repair_carried()

        # --- apply B (+ alive-group losers): grouped chain appends -----
        n_chain = 0
        bi = np.flatnonzero(b_mask)
        li = np.flatnonzero(loser_alive)
        targets = ub[bi]
        if li.size:  # losers chain on the winner's slot or the boundary
            l_t = np.where(keys[li] > keys[w_of[li]], p[li], pv[li])
            bi = np.concatenate([bi, li])
            targets = np.concatenate([targets, l_t])
        if bi.size:
            # ONE vectorized CSR merge for every chain append in the
            # batch (raises KeyError on duplicates, like insert())
            self.links.append_batch(targets, keys[bi], payloads[bi])
            n_chain += int(bi.size)
        self.n_keys += n_slot + n_chain

        # --- apply C -----------------------------------------------------
        # Re-partition the contested keys against the updated state: the
        # equivalence argument applies recursively, and contention shrinks
        # geometrically per round.  Sequential replay only when a round
        # makes no progress (pathological all-contested batches).
        # Count invariant: slot + chain == n_b over all rounds;
        # "contested" counts exactly the replay-visited keys.
        ci = np.flatnonzero(c_mask)
        counts = {"slot": n_slot, "chain": n_chain, "contested": 0}
        if ci.size == n_b or ci.size <= 1024:
            # no progress (pathological all-contested batch) or a small
            # tail: scalar replay in arrival order beats another O(m)
            # round; chain appends buffer in the CSRLinks pending
            # overlay and merge as one flush
            counts["contested"] = int(ci.size)
            ins_at = self._insert_at
            for k, pl, pp in zip(keys[ci].tolist(), payloads[ci].tolist(),
                                 p[ci].tolist()):
                counts[ins_at(k, pl, pp)] += 1
        elif ci.size:
            sub = self.insert_batch(keys[ci], payloads[ci])
            counts["slot"] += sub["slot"]
            counts["chain"] += sub["chain"]
            counts["contested"] += sub["contested"]
        # merge the replay tail's buffered chain appends now: the flush
        # belongs to this batch, not to the next reader (e.g. the epoch
        # handle's timed device sync)
        self.links.flush()
        return counts

    def delete_batch(self, keys: np.ndarray) -> int:
        """Batched §5.3 deletes — a host-side sweep over ``delete()``
        (deletes are the rare arm of dynamic workloads; each chain
        removal is one CSR memmove).  Returns the number of keys
        actually removed.

        Like ``insert_batch``, the CSRLinks pending overlay is flushed
        before returning: deletes of unoccupied-path keys never touch
        the flush-first link mutators, so without this a batch running
        after buffered scalar inserts would leave the merge bill to the
        next reader (e.g. the epoch handle's timed device sync)."""
        removed = 0
        for k in np.asarray(keys, np.float64):
            removed += bool(self.delete(float(k)))
        self.links.flush()
        return removed

    # ------------------------------------------------------------------
    def live_items(self) -> Tuple[np.ndarray, np.ndarray]:
        """The LIVE (key, payload) set, key-sorted: occupied slot keys
        merged with every CSR chain key.  This is the authoritative
        key set after any sequence of dynamic ops — retrain, shard
        splits, and the live ``Index.mdl`` report all rebuild from it
        (total-order invariant: keys are unique across slots+chains)."""
        occ = np.asarray(self.occupied, bool)
        k = np.asarray(self.slot_key, np.float64)[occ]
        p = np.asarray(self.payload, np.int64)[occ]
        _off, lk, lp = self.links.csr()
        if lk.size:
            k = np.concatenate([k, np.asarray(lk, np.float64)])
            p = np.concatenate([p, np.asarray(lp, np.int64)])
            order = np.argsort(k, kind="stable")
            k, p = k[order], p[order]
        return k, p

    # ------------------------------------------------------------------
    # frozen export for the jnp/Pallas query path
    # ------------------------------------------------------------------
    def export_csr_links(self, max_chain: Optional[int] = None):
        """CSR link tables: (offsets (m+1,), keys (L,), payloads (L,)).

        Free — the chains are stored natively as CSR arrays; the return
        values are views of the canonical storage (copy before mutating
        this structure).  ``max_chain`` bounds per-slot chains for the
        fixed-trip-count kernel; overflow raises (asserted rare — paper
        §5.2 observes chains are short).
        """
        if max_chain is not None and self.links.max_chain > max_chain:
            lens = np.diff(self.links.offsets)
            i = int(np.argmax(lens))
            raise ValueError(
                f"chain at slot {i} has {int(lens[i])} > max_chain={max_chain}"
            )
        return self.links.csr()


class GapSnapshot:
    """Immutable pinned view of a ``GappedArray`` at one version.

    Created by ``GappedArray.pin_snapshot()``; holds the slot/payload/CSR
    arrays by identity (zero-copy) and relies on the live side's
    copy-on-write to never see a post-pin mutation.  Serves lookups
    through the proven ``GappedArray.lookup_batch`` host path over a
    read-only view, so results are bit-identical to a quiesced lookup at
    ``epoch`` by construction.  ``release()`` drops the pin (refcounted
    — releasing twice is a no-op)."""

    __slots__ = ("epoch", "n_keys", "_view", "_cell")

    def __init__(self, live: "GappedArray", offsets, lkeys, lpays, cell):
        self.epoch = int(live.version)
        self.n_keys = int(live.n_keys)
        links = CSRLinks(live.n_slots, offsets, lkeys, lpays)
        self._view = GappedArray(
            slot_key=live.slot_key, occupied=live.occupied,
            payload=live.payload, links=links, mech=live.mech,
            n_keys=live.n_keys, rho=live.rho, version=live.version)
        self._cell = cell

    @property
    def pinned(self) -> bool:
        return self._cell is not None

    @property
    def n_slots(self) -> int:
        return self._view.n_slots

    def lookup_batch(self, qs: np.ndarray, full: bool = False):
        return self._view.lookup_batch(qs, full=full)

    def release(self) -> None:
        cell, self._cell = self._cell, None
        if cell is not None:
            cell.count -= 1


def _place_keys(
    x: np.ndarray,
    payloads: np.ndarray,
    pred_slot: np.ndarray,
    m: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, CSRLinks]:
    """Linking-array placement (§5.2): slot = prediction; conflicts chain.

    Keys arrive sorted; the cursor (last occupied slot) is the running
    max of predicted slots, so the whole placement vectorizes: a key
    occupies iff its prediction strictly exceeds every earlier
    prediction; otherwise it chains onto the cursor.  Chain targets are
    non-decreasing and keys arrive key-sorted, so the chained triples
    are already in CSR order — built with one bincount + cumsum.
    """
    slot_key = np.full(m, np.inf, np.float64)
    occupied = np.zeros(m, bool)
    payload = np.full(m, _EMPTY, np.int64)
    pred_slot = np.asarray(pred_slot, np.int64)
    n = x.shape[0]
    links = CSRLinks(m)
    if n:
        cm = np.maximum.accumulate(pred_slot)
        occ = np.r_[True, pred_slot[1:] > cm[:-1]]
        po = pred_slot[occ]
        slot_key[po] = x[occ]
        occupied[po] = True
        payload[po] = payloads[occ]
        chained = ~occ
        if np.any(chained):
            targets = cm[chained]  # cursor at each chained arrival
            counts = np.bincount(targets, minlength=m)
            links = CSRLinks(m, np.concatenate([[0], np.cumsum(counts)]),
                             np.asarray(x[chained], np.float64),
                             np.asarray(payloads[chained], np.int64))
    # carried keys for unoccupied slots: next occupied key to the right
    # (occupied keys ascend, so one reverse cummin repairs everything)
    carried = np.minimum.accumulate(
        np.where(occupied, slot_key, np.inf)[::-1])[::-1]
    return carried, occupied, payload, links


def build_gapped(
    mechanism_factory,
    x: np.ndarray,
    payloads: Optional[np.ndarray] = None,
    rho: float = 0.1,
    sample_rate: float = 1.0,
    rng: Optional[np.random.Generator] = None,
    refinalize: bool = True,
    refit_factory=None,
) -> GappedArray:
    """Full §5 pipeline: base fit (+sampling §5.4) -> Eq.3 -> re-learn -> place.

    ``refit_factory`` builds the step-3 mechanism re-learned on the
    gap-inserted data; default is the base factory.  Because D_g is
    near-linear per segment, a *tighter* eps here costs few segments but
    sharply reduces placement collisions (shorter linking arrays) — see
    LearnedIndex.build's adaptive default.

    With ``sample_rate < 1.0`` the ENTIRE learning pipeline runs on the
    sampled (key, full-data position) pairs — base fit, Eq.3 targets,
    and the step-3 refit are all O(n_s); only physical placement and the
    refinalize backstop stay O(n).  Exactness is preserved anyway: the
    step-3 mechanism gets ``connect_segments`` (unsampled keys
    interpolate, never extrapolate) and the final ``_finalize_errors``
    recomputes exact per-segment bounds against the PHYSICAL slots of
    the full key set, so the bounded-window kernel contract is identical
    to a full-data build.  ``build_timings`` on the returned array
    records the learn/place split.
    """
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    y = np.arange(n, dtype=np.float64)
    if payloads is None:
        payloads = np.arange(n, dtype=np.int64)

    t0 = time.perf_counter()
    if sample_rate < 1.0:
        # ONE sample drives the whole learning pipeline (base fit, Eq.3
        # targets, step-3 refit): ys are FULL-data positions, endpoints
        # forced, so the gapped domain [0, yg_s[-1]] covers every key
        xs, ys = _sampling.sample_pairs(x, y, rate=sample_rate, rng=rng)
    else:
        xs, ys = x, y

    # 1) base mechanism on the (possibly sampled) pairs
    base = mechanism_factory()
    base.fit(xs, ys)
    base_plm = getattr(base, "plm", None)
    if base_plm is None:
        raise ValueError("gap insertion needs a PLM-exporting mechanism")
    if sample_rate < 1.0 and base.name in ("pgm", "fiting"):
        _sampling.connect_segments(base_plm)

    # 2) result-driven target positions (Eq. 3) — O(n_s) under sampling
    yg = gap_positions(xs, ys, base_plm, rho)

    # 3) re-learn on the gap-inserted data — O(n_s) under sampling
    mech = (refit_factory or mechanism_factory)()
    mech.fit(xs, yg)
    if sample_rate < 1.0 and mech.name in ("pgm", "fiting") \
            and getattr(mech, "plm", None) is not None:
        _sampling.connect_segments(mech.plm)
    learn_seconds = time.perf_counter() - t0

    # 4) physical placement at re-learned predictions — O(n) always
    t1 = time.perf_counter()
    m = int(np.ceil(yg[-1])) + 2
    pred = np.clip(np.rint(mech.predict(x)), 0, m - 1).astype(np.int64)
    slot_key, occupied, payload, links = _place_keys(x, payloads, pred, m)

    ga = GappedArray(
        slot_key=slot_key,
        occupied=occupied,
        payload=payload,
        links=links,
        mech=mech,
        n_keys=n,
        rho=rho,
    )
    # error bounds against *physical* slots so bounded search is exact
    if refinalize and getattr(mech, "plm", None) is not None:
        slot_of_key = np.searchsorted(ga.slot_key, x, side="right") - 1
        _finalize_errors(mech.plm, x, slot_of_key.astype(np.float64))
    ga.build_timings = {
        "learn_seconds": learn_seconds,
        "place_seconds": time.perf_counter() - t1,
        "n_fit": int(xs.shape[0]),
    }
    return ga
