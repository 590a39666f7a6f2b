"""Exact 64-bit integer keys: the key domain, its ordered int64 form and
the host side of the 64-bit image.

The reference holds keys as float64, and its device images hold them as
f32 or as an f32 (hi, lo) pair, exact below 2^48.  The port adds a third
image, exact for every integer key in [0, 2^64 - 1) (``2^64 - 1`` is
reserved as the "no key" sentinel that trailing gap slots and padding
carry, as +inf does for float keys).  Which image an index takes follows
from its keys (``build_keys``): keys given as integers at or above 2^53,
which float64 cannot hold, take the 64-bit image; every other key set is
float64 exactly and keeps the reference's images and its write path.
Float keys at or above 2^53 are refused: they are already inexact.

Inside the port a 64-bit key is held in its *ordered* form, an int64
whose signed order is the unsigned order of the key (the top bit
flipped: ``to_ordered``), so numpy and torch compare, sort and search it
with their int64 ops.  ``Index.keys`` stays uint64.

Learning is the reference's and sees ``float64(key)``: the model's input
is rounded, its answers are not.  Everything that decides an answer is
exact: the build places keys in their exact order
(``kernels.place.build_gapped_device``), the slot and chain keys are
exact, and a segment's prediction is taken from the exact difference
``q - seg_first_key`` rounded once to float64 (``exact_dx``), the same
arithmetic on the host (``predict_ordered``, the window bounds) and in
the kernel (``csrc/fused_lookup.cu``'s 64-bit instantiation).

``GappedArray64`` is the gapped layout over ordered keys.  It serves
reads (its host lookup, snapshots pinned for ``serving.EpochPipeline``,
``live_items``) and refuses every write: the write path, the WAL,
sharding and the paged KV cache hold float64 keys, and each of them
raises ``ValueError`` (``write_keys``) on keys that need this image.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .gaps import GappedArray, GapSnapshot, _PinCell
from .links import CSRLinks

__all__ = ["FLOAT_LIMIT", "NO_KEY", "build_keys", "is_u64",
           "to_ordered", "from_ordered", "ordered_f64", "query_ordered",
           "exact_dx", "seg_first_ordered", "predict_ordered",
           "write_keys", "lookup_keys", "GappedArray64", "GapSnapshot64"]

# float64 holds every integer below 2^53: integer keys from here take the
# 64-bit image, float keys from here are inexact and refused
FLOAT_LIMIT = 1 << 53
NO_KEY = np.int64(np.iinfo(np.int64).max)   # ordered 2^64 - 1: no key
_BIAS = np.uint64(1 << 63)
_TWO32 = 4294967296.0
_LIMIT_MSG = ("integer keys at or above 2^53 take the exact 64-bit image, "
              "which serves lookups only")


def is_u64(keys) -> bool:
    """Whether ``keys`` are a 64-bit key set (uint64, see module doc)."""
    return getattr(keys, "dtype", None) == np.uint64


def to_ordered(keys) -> np.ndarray:
    """uint64 keys -> their ordered int64 form (top bit flipped)."""
    return (np.asarray(keys, np.uint64) ^ _BIAS).view(np.int64)


def from_ordered(okeys) -> np.ndarray:
    """Ordered int64 keys -> uint64 keys."""
    return np.asarray(okeys, np.int64).view(np.uint64) ^ _BIAS


def ordered_f64(okeys) -> np.ndarray:
    """``float64(key)`` of ordered keys: the model's input."""
    return from_ordered(okeys).astype(np.float64)


def _refuse_float(f: np.ndarray, where: str) -> None:
    fin = f[np.isfinite(f)]
    if fin.size and float(np.max(np.abs(fin))) >= FLOAT_LIMIT:
        raise ValueError(
            f"{where}: float keys at or above 2^53 are inexact; pass "
            "integer keys as int64 or uint64")


def _as_uint64(a: np.ndarray, where: str) -> np.ndarray:
    if a.dtype.kind == "i" and a.size and int(a.min()) < 0:
        raise ValueError(f"{where}: integer keys lie in [0, 2^64 - 1); "
                         "got a negative key")
    return a.astype(np.uint64)


def build_keys(keys) -> np.ndarray:
    """The key set an index is built over: float64 (the reference's
    images), or uint64 when the keys are integers and some key is 2^53
    or more (the 64-bit image).  Refuses floats at or above 2^53,
    negative integers and the reserved key 2^64 - 1."""
    a = np.asarray(keys)
    if a.dtype.kind in "iu":
        u = _as_uint64(a, "Index.build")
        if u.size and int(u.max()) >= FLOAT_LIMIT:
            if int(u.max()) == (1 << 64) - 1:
                raise ValueError("Index.build: the key 2^64 - 1 is reserved "
                                 "(the 64-bit image's no-key sentinel)")
            return u
        return u.astype(np.float64)
    f = np.asarray(a, np.float64)
    _refuse_float(f, "Index.build")
    return f


def write_keys(keys, where: str, u64_index: bool = False) -> np.ndarray:
    """Float64 keys for a write or sharding entry point (``where``), which
    holds keys as float64: refuses keys that need the 64-bit image
    (integers at or above 2^53, any key for an index that has the
    image) and floats at or above 2^53, never rounds."""
    a = np.asarray(keys)
    if u64_index:
        raise ValueError(f"{where}: this index holds 64-bit keys; "
                         f"{_LIMIT_MSG}")
    if a.dtype.kind in "iu":
        u = _as_uint64(a, where)
        if u.size and int(u.max()) >= FLOAT_LIMIT:
            raise ValueError(f"{where}: {_LIMIT_MSG}")
        return u.astype(np.float64)
    f = np.asarray(a, np.float64)
    _refuse_float(f, where)
    return f


def lookup_keys(keys, dtype) -> np.ndarray:
    """Lookup keys in an index's key dtype (float64 or uint64), exactly:
    for uint64, integers in range and integral floats below 2^53;
    anything else raises (a queue stages one dtype for all callers)."""
    a = np.asarray(keys)
    if np.dtype(dtype) != np.uint64:
        return np.asarray(a, np.float64)
    if a.dtype.kind in "iu":
        return _as_uint64(a, "lookup")
    f = np.asarray(a, np.float64)
    _refuse_float(f, "lookup")
    if f.size and not bool(np.all((f >= 0) & (f == np.floor(f)))):
        raise ValueError("lookup: keys of a 64-bit index are integers "
                         "in [0, 2^64 - 1)")
    return f.astype(np.uint64)


def query_ordered(queries) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Queries of a 64-bit index in ordered form, and the mask of those
    that cannot be keys (negative, fractional, non-finite, 2^64 - 1;
    None when all can).  Those answer not found.  Floats at or above 2^53 raise."""
    a = np.asarray(queries)
    if a.dtype == np.uint64:
        bad = a == np.uint64((1 << 64) - 1)   # the no-key sentinel
        return to_ordered(a), (bad if bad.any() else None)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
        bad = a < 0
        return to_ordered(np.where(bad, 0, a).astype(np.uint64)), (
            bad if bad.any() else None)
    f = np.asarray(a, np.float64)
    _refuse_float(f, "lookup")
    with np.errstate(invalid="ignore"):
        bad = ~(np.isfinite(f) & (f >= 0) & (f == np.floor(f)))
    u = np.where(bad, 0.0, f).astype(np.uint64)
    return to_ordered(u), (bad if bad.any() else None)


def exact_dx(a, b) -> np.ndarray:
    """``float64(a - b)`` of ordered keys, rounded once: the exact
    difference as ``(a_hi - b_hi) * 2^32 + (a_lo - b_lo)``, two exact
    doubles summed (the kernel's arithmetic, step for step)."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    hi = ((a >> 32) - (b >> 32)).astype(np.float64) * _TWO32
    lo = ((a & 0xFFFFFFFF) - (b & 0xFFFFFFFF)).astype(np.float64)
    return hi + lo


def seg_first_ordered(seg_first_key) -> np.ndarray:
    """A PLM's segment first keys (float64) as ordered keys: the least
    integer at or above each (clipped to the key domain)."""
    f = np.ceil(np.asarray(seg_first_key, np.float64))
    f = np.clip(f, 0.0, float(1 << 64))
    u = np.where(f >= float(1 << 64), np.uint64((1 << 64) - 1),
                 f.astype(np.uint64))
    return to_ordered(u)


def predict_ordered(plm, okeys, first: Optional[np.ndarray] = None):
    """``(y_hat, seg)`` of ordered keys: exact segment routing over
    ``seg_first_ordered``, then ``slope * exact_dx + icept`` in float64,
    one rounding a step (no FMA)."""
    if first is None:
        first = seg_first_ordered(plm.seg_first_key)
    x = np.asarray(okeys, np.int64)
    seg = np.clip(np.searchsorted(first, x, side="right") - 1,
                  0, first.shape[0] - 1)
    slope = np.asarray(plm.slope, np.float64)[seg]
    icept = np.asarray(plm.icept, np.float64)[seg]
    return slope * exact_dx(x, first[seg]) + icept, seg


def _links(n_slots: int, offsets, okeys, payloads) -> CSRLinks:
    """``CSRLinks`` holding ordered int64 chain keys (its constructor
    casts keys to float64, so they are set after it)."""
    links = CSRLinks(n_slots, offsets, None, payloads)
    links._keys = np.asarray(okeys, np.int64)
    return links


class GappedArray64(GappedArray):
    """The gapped layout over ordered int64 keys: ``slot_key`` and the
    chain keys are ordered, trailing gap slots carry ``NO_KEY``.  Reads
    take raw keys (uint64, int64 or integral floats below 2^53);
    writes raise ``ValueError``."""

    @classmethod
    def from_arrays(cls, slot_key, occupied, payload, offsets, chain_keys,
                    chain_payloads, *, mech, n_keys: int, rho: float,
                    version: int = 0) -> "GappedArray64":
        m = int(np.asarray(slot_key).shape[0])
        return cls(slot_key=np.asarray(slot_key, np.int64),
                   occupied=np.asarray(occupied, bool),
                   payload=np.asarray(payload, np.int64),
                   links=_links(m, offsets, chain_keys, chain_payloads),
                   mech=mech, n_keys=int(n_keys), rho=float(rho),
                   version=int(version))

    def lookup_batch(self, qs, bounded: bool = True, full: bool = False):
        """Exact batch lookup of raw keys: ``searchsorted`` over the
        ordered slot keys, then each miss's chain (``bounded`` is
        accepted for the base class's signature)."""
        del bounded
        q, bad = query_ordered(np.atleast_1d(qs))
        sk = self.slot_key
        j = np.searchsorted(sk, q, side="right").astype(np.int64) - 1
        ok = j >= 0
        safe = np.maximum(j, 0)
        hit = ok & (sk[safe] == q)
        out = np.where(hit, self.payload[safe], np.int64(-1))
        resolved = hit.copy()
        miss = np.flatnonzero(ok & ~hit)
        if miss.size:   # each miss's chain, scanned in step (chains
            offsets, lkeys, lpays = self.links.csr()   # are short)
            start, end = offsets[j[miss]], offsets[j[miss] + 1]
            live = end > start
            start, end, midx = start[live], end[live], miss[live]
            t = 0
            max_t = int(np.max(end - start)) if midx.size else 0
            while t < max_t and midx.size:
                idx = start + t
                in_chain = idx < end
                eq = in_chain & (lkeys[np.minimum(idx, lkeys.size - 1)]
                                 == q[midx])
                out[midx[eq]] = lpays[idx[eq]]
                resolved[midx[eq]] = True
                keep = in_chain & ~eq
                start, end, midx = start[keep], end[keep], midx[keep]
                t += 1
        if bad is not None:
            out[bad] = -1
            resolved[bad] = False
        if full:
            return out, j, resolved
        return out

    def contains_batch(self, qs) -> np.ndarray:
        return self.lookup_batch(qs, full=True)[2]

    def live_items(self) -> Tuple[np.ndarray, np.ndarray]:
        """The live (key, payload) set, key-sorted, keys as uint64."""
        occ = np.asarray(self.occupied, bool)
        k = self.slot_key[occ]
        p = self.payload[occ]
        _off, lk, lp = self.links.csr()
        if lk.size:
            k = np.concatenate([k, lk])
            p = np.concatenate([p, lp])
            order = np.argsort(k, kind="stable")
            k, p = k[order], p[order]
        return from_ordered(k), p

    def pin_snapshot(self) -> "GapSnapshot64":
        """The base class's zero-copy pin, read through a
        ``GappedArray64`` view."""
        self.links.flush()
        if self._pins is None:
            self._pins = _PinCell()
        self._pins.count += 1
        self.links.mark_shared()
        return GapSnapshot64(self, self._pins)

    def _refuse(self, *args, **kwargs):
        raise ValueError(f"GappedArray64: {_LIMIT_MSG}")

    insert = delete = update = update_batch = _refuse
    insert_batch = delete_batch = placement_primitives = _refuse
    verify_placements = _refuse


class GapSnapshot64(GapSnapshot):
    """A ``GapSnapshot`` of a ``GappedArray64`` (its ``release`` and
    ``lookup_batch`` are the base class's, over a ``GappedArray64``
    view of the pinned arrays)."""

    __slots__ = ()

    def __init__(self, live: GappedArray64, cell):
        self.epoch = int(live.version)
        self.n_keys = int(live.n_keys)
        offsets, lkeys, lpays = live.links.csr()
        self._view = GappedArray64(
            slot_key=live.slot_key, occupied=live.occupied,
            payload=live.payload,
            links=_links(live.n_slots, offsets, lkeys, lpays),
            mech=live.mech, n_keys=live.n_keys, rho=live.rho,
            version=live.version)
        self._cell = cell
