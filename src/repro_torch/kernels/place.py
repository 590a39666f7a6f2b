"""The build's placement on the index's device: step 4 of
``core.gaps.build_gapped`` and its refinalize backstop in torch ops.

The reference builds on the host, so this module has no Pallas
counterpart.  ``build_gapped_device`` runs steps 1-3 (sample, fit,
Eq. 3, refit) exactly as ``build_gapped`` does: the same helpers, in
the same order, on the same ``rng``.  It then predicts every key's
slot, places and links the keys and recomputes the exact per-segment
error bounds on ``device``, and returns a ``GappedArray`` equal to
``build_gapped``'s array for array (tests/test_torch_place.py).  It
serves a refit mechanism that predicts through its PLM
(``PLM_METHODS``).

Bytes bound it: each key and payload is read once (16 B), each slot's
key, occupied flag, payload and CSR offset written once (25 B), each
chained key and payload once more (16 B); the per-segment tables are
a few KB.  Keys stream in chunks of ``CHUNK_KEYS``, so the device
holds a chunk's working set (about 120 B a key) and a window of at
most ``SLOT_WINDOW`` slots (about 50 B a slot), whatever the number of
keys.  Each window is copied into host arrays allocated once.

Exact in f64.  The prediction ``slope[seg] * (x - first[seg]) +
icept[seg]`` is one torch op per NumPy op, each rounded once as
NumPy's is (no two fuse into an FMA).  ``torch.round`` rounds half to
even, as ``np.rint`` does, and the float is clamped to [0, m - 1]
before its cast to int64, as ``np.clip`` runs before ``astype``.  The
rest is integer work and min / max, exact in any order.

Chunks give what one pass gives:

* the running max (the cursor: the last occupied slot) carries from
  one chunk to the next, and a key occupies its predicted slot iff
  the slot lies past the cursor before it;
* a chained key's target is the cursor, which may be the previous
  chunk's last occupied slot, so CSR offsets are written per slot as
  its start (the chained keys of smaller target), which no later
  chunk changes;
* a key's slot (the host's ``searchsorted(slot_key, x, "right") -
  1``) is the cursor after its arrival: its own slot if it occupies
  one, else the slot it chains onto, since every slot past the cursor
  holds or carries a later, larger key;
* a chunk's slots run from past the previous cursor to its own last
  occupied slot, so an unoccupied slot finds its carried key (the
  first occupied key to its right) inside the chunk; slots past the
  last occupied slot carry ``inf``.

64-bit keys (uint64, ``core.keys64``): steps 1-3 learn on
``float64(key)``, as the reference does, each float64 value once (keys
past 2^53 that round together keep the last one's position); step 4
places the ordered
int64 keys in their exact order.  A key's segment is routed over the
exact segment first keys and its prediction is ``slope *
keys64.exact_dx(x, first) + icept``, which the window bounds and the
kernel compute the same way; slots past the last occupied one carry
``keys64.NO_KEY``.  The result is a ``keys64.GappedArray64``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import keys64 as _k64
from ..core import sampling as _sampling
from ..core.gaps import _EMPTY, GappedArray, gap_positions
from ..core.links import CSRLinks
from .lookup import exact_dx

__all__ = ["build_gapped_device", "plm_tables", "route_predict",
           "PLM_METHODS", "CHUNK_KEYS", "SLOT_WINDOW"]

PLM_METHODS = ("pgm", "fiting")   # mechanisms whose predict is plm.predict
CHUNK_KEYS = 1 << 21              # keys a chunk streams to the device
SLOT_WINDOW = 1 << 22             # slots a window writes back at once;
                                  # also stages a chunk's chained keys
_SCAN_ROW = 1024                  # the running max's row

device_builds = 0                 # placements run by build_gapped_device


def _to_host(dst: np.ndarray, start: int, t: torch.Tensor,
             stage: torch.Tensor) -> None:
    """Copy ``t`` into ``dst[start:start + len(t)]`` through ``stage``:
    a DMA into pinned memory, then a host copy on torch's threads, which
    also share the page faults of ``dst``'s fresh pages (twice the rate
    of one pageable copy on the card's host)."""
    s = stage[:t.shape[0] * t.element_size()].view(t.dtype)
    s.copy_(t)
    torch.from_numpy(dst[start:start + t.shape[0]]).copy_(s)


def _running_max(v: torch.Tensor, floor: int) -> torch.Tensor:
    """``max(floor, cummax(v))``, scanned in rows of ``_SCAN_ROW`` and
    then across rows: one scan of the whole chunk takes torch's
    single-row kernel, some 40 times slower on the card."""
    n = v.shape[0]
    rows = -(-n // _SCAN_ROW)
    w = v.new_full((rows * _SCAN_ROW,), floor)
    w[:n] = v
    w = torch.cummax(w.view(rows, _SCAN_ROW), 1).values
    before = torch.cummax(w[:-1, -1], 0).values   # max of the rows above
    w[1:] = torch.maximum(w[1:], before[:, None])
    return w.view(-1)[:n].clamp_(min=floor)


def plm_tables(plm, dev, exact: bool):
    """``(first, slope, icept)`` of ``plm`` on ``dev``: the segment first
    keys as float64, or for 64-bit keys (``exact``) as ordered int64
    (``keys64.seg_first_ordered``); slopes and intercepts as float64."""
    first = (torch.from_numpy(_k64.seg_first_ordered(plm.seg_first_key))
             .to(dev) if exact else
             torch.as_tensor(plm.seg_first_key, dtype=torch.float64,
                             device=dev))
    slope, icept = (torch.as_tensor(a, dtype=torch.float64, device=dev)
                    for a in (plm.slope, plm.icept))
    return first, slope, icept


def route_predict(xd, first, slope, icept):
    """``(y_hat, seg)`` of a chunk: the reference's float line, or over
    ordered keys ``keys64.predict_ordered``'s.  The build's placement and
    the freeze's window bounds (``bounds.query_window_bounds_device``)
    share it."""
    k = first.shape[0]
    seg = torch.searchsorted(first, xd, right=True).sub_(1)
    seg.clamp_(0, k - 1)
    if xd.dtype == torch.int64:
        dx = exact_dx(xd, first[seg])
    else:
        dx = xd - first[seg]
    return dx.mul_(slope[seg]).add_(icept[seg]), seg


def _place(x, payloads, plm, m, dev, refinalize):
    """Step 4 and the refinalize on ``dev``: ``(slot_key, occupied,
    payload, links, err_lo, err_hi)`` as host arrays (the bounds None
    without ``refinalize``); see the module doc.  ``x`` is float64, or
    ordered int64 for 64-bit keys."""
    n = x.shape[0]
    k = plm.n_segments
    exact = x.dtype == np.int64
    kdt = np.int64 if exact else np.float64
    first, slope, icept = plm_tables(plm, dev, exact)
    err_lo = torch.zeros(k, dtype=torch.float64, device=dev)
    err_hi = torch.zeros(k, dtype=torch.float64, device=dev)
    slot_key = np.empty(m, kdt)
    occupied = np.empty(m, bool)
    payload = np.empty(m, np.int64)
    offsets = np.empty(m + 1, np.int64)
    chain_keys = np.empty(n, kdt)          # the first n_chained hold
    chain_pays = np.empty(n, np.int64)     # (untouched pages stay unmapped)
    stage = torch.empty(SLOT_WINDOW * 8, dtype=torch.uint8,
                        pin_memory=dev.type == "cuda")
    cursor = -1          # the last occupied slot so far
    n_chained = 0        # chained keys so far
    for a in range(0, n, CHUNK_KEYS):
        xd = torch.from_numpy(x[a:a + CHUNK_KEYS]).to(dev)
        pd = torch.from_numpy(payloads[a:a + CHUNK_KEYS]).to(dev)
        yhat, seg = route_predict(xd, first, slope, icept)
        pred = torch.round(yhat).clamp_(0, m - 1).long()
        cm = _running_max(pred, cursor)
        if refinalize:
            err = cm.double().sub_(yhat)   # a key's slot is cm
            err_lo.scatter_reduce_(0, seg, err, "amin")
            err_hi.scatter_reduce_(0, seg, err, "amax")
            del err
        del seg, yhat
        occ = pred > torch.cat([cm.new_full((1,), cursor), cm[:-1]])
        po, ko, vo = pred[occ], xd[occ], pd[occ]
        chained = ~occ
        targets = cm[chained]
        _to_host(chain_keys, n_chained, xd[chained], stage)
        _to_host(chain_pays, n_chained, pd[chained], stage)
        last = int(cm[-1])
        del xd, pd, pred, cm, occ, chained   # before the window's tensors
        for s0 in range(cursor + 1, last + 1, SLOT_WINDOW):
            slots = torch.arange(s0, min(s0 + SLOT_WINDOW, last + 1),
                                 device=dev)
            j = torch.searchsorted(po, slots)   # first occupied slot >= s
            _to_host(slot_key, s0, ko[j], stage)
            hit = po[j] == slots
            _to_host(occupied, s0, hit, stage)
            _to_host(payload, s0, vo[j].masked_fill_(~hit, _EMPTY), stage)
            _to_host(offsets, s0,
                     torch.searchsorted(targets, slots).add_(n_chained),
                     stage)
            del slots, j, hit
        n_chained += targets.shape[0]
        cursor = last
    slot_key[cursor + 1:] = _k64.NO_KEY if exact else np.inf
    occupied[cursor + 1:] = False
    payload[cursor + 1:] = _EMPTY
    offsets[cursor + 1:] = n_chained
    links = (_k64._links if exact else CSRLinks)(
        m, offsets, chain_keys[:n_chained], chain_pays[:n_chained])
    if not refinalize:
        return slot_key, occupied, payload, links, None, None
    return (slot_key, occupied, payload, links,
            err_lo.cpu().numpy(), err_hi.cpu().numpy())


def build_gapped_device(
    mechanism_factory,
    x: np.ndarray,
    payloads=None,
    rho: float = 0.1,
    sample_rate: float = 1.0,
    rng=None,
    refinalize: bool = True,
    refit_factory=None,
    device="cuda",
) -> GappedArray:
    """``core.gaps.build_gapped`` with its placement on ``device`` (see
    the module doc): the same arguments and the same ``GappedArray``,
    whose ``build_timings`` adds ``"place_device"``, the device type.
    The refit mechanism must be one of ``PLM_METHODS``.  On a CUDA
    device the allocator's cache is emptied afterwards, so what follows
    allocates as it would after a host build.  uint64 keys give a
    ``keys64.GappedArray64`` (see the module doc)."""
    global device_builds
    u64 = _k64.is_u64(x)
    xo = _k64.to_ordered(x) if u64 else None
    x = x.astype(np.float64) if u64 else np.asarray(x, np.float64)
    n = x.shape[0]
    y = np.arange(n, dtype=np.float64)
    if payloads is None:
        payloads = np.arange(n, dtype=np.int64)

    # steps 1-3: build_gapped's, call for call
    t0 = time.perf_counter()
    if sample_rate < 1.0:
        xs, ys = _sampling.sample_pairs(x, y, rate=sample_rate, rng=rng)
    else:
        xs, ys = x, y
    if u64:   # keys that round to one float64 are learned once (the last)
        keep = np.r_[xs[1:] > xs[:-1], True]
        xs, ys = xs[keep], ys[keep]
    base = mechanism_factory()
    base.fit(xs, ys)
    base_plm = getattr(base, "plm", None)
    if base_plm is None:
        raise ValueError("gap insertion needs a PLM-exporting mechanism")
    if sample_rate < 1.0 and base.name in ("pgm", "fiting"):
        _sampling.connect_segments(base_plm)
    yg = gap_positions(xs, ys, base_plm, rho)
    mech = (refit_factory or mechanism_factory)()
    mech.fit(xs, yg)
    if sample_rate < 1.0 and mech.name in ("pgm", "fiting") \
            and getattr(mech, "plm", None) is not None:
        _sampling.connect_segments(mech.plm)
    learn_seconds = time.perf_counter() - t0
    if mech.name not in PLM_METHODS:
        raise ValueError(f"device placement predicts through a PLM; the "
                         f"refit mechanism is {mech.name!r}")

    # step 4 and the refinalize on the device
    t1 = time.perf_counter()
    dev = torch.device(device)
    m = int(np.ceil(yg[-1])) + 2
    slot_key, occupied, payload, links, lo, hi = _place(
        x if xo is None else xo, np.asarray(payloads, np.int64), mech.plm,
        m, dev, refinalize)
    if refinalize:
        mech.plm.err_lo, mech.plm.err_hi = lo, hi
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    device_builds += 1
    ga = (_k64.GappedArray64 if u64 else GappedArray)(
        slot_key=slot_key, occupied=occupied, payload=payload, links=links,
        mech=mech, n_keys=n, rho=rho)
    ga.build_timings = {
        "learn_seconds": learn_seconds,
        "place_seconds": time.perf_counter() - t1,
        "n_fit": int(xs.shape[0]),
        "place_device": dev.type,
    }
    return ga
