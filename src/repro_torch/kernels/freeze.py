"""Freeze: host index state -> padded f32/i32 device images.

Counterpart of the freeze half of ``repro.kernels.ops``.  The numpy
helpers (``_pad_pow`` .. ``_freeze_numpy``) are copies of the
reference's and must stay array-for-array equal to it
(tests/test_torch_freeze.py holds them so).  ``IndexArrays`` holds the
images as torch tensors on one device.

Keys that exceed f32 exactness (> 2^24) ride an (hi, lo) f32 pair with
``lo = key - f64(hi)``: lexicographic pair order is numeric order, and
the pair is exact for integer keys below 2^48.  Payloads wider than
int32 ride an i32 (lo, hi) pair.

64-bit keys (``core.keys64``) take a third image, ``key_u64``: the slot,
chain and segment first keys as ordered int64 (``NO_KEY`` padded), the
segment slopes and intercepts as float64, no ``*_lo`` halves
(``_freeze_numpy_u64``).  It is 8 B a key, as the pair is.  The numpy
helpers above it stay the reference's.

``freeze_headroom_device`` writes the images of
``freeze_numpy_headroom`` straight into the ``IndexArrays`` tensors on
the index's device: the host arrays go up in chunks of ``IMAGE_CHUNK``
and are split and padded there, and ``wide`` and ``key_wide``
(``key_wide_device``) are device reductions.  The images are allocated
one by one, the last filled in small chunks, so the device never holds
more than the images and a small chunk.  The segment tables, a few KB,
are the host's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import keys64 as _k64
from ..spans import span

__all__ = ["IndexArrays", "freeze_numpy_headroom", "freeze_headroom_device",
           "key_wide_device", "keys_need_pair",
           "keys_pair_exact", "pair_alias_free", "split_key_pair",
           "split_key_pair_t", "IMAGE_CHUNK", "TAIL_CHUNK"]

IMAGE_CHUNK = 1 << 21   # elements a device freeze streams at once
                        # (16 MB of float64 or int64 source)
TAIL_CHUNK = 1 << 15    # ... into its last image (384 KB of transient)

_I32_MIN = np.iinfo(np.int32).min
_I32_MAX = np.iinfo(np.int32).max


def _pad_pow(a: np.ndarray, multiple: int, fill) -> np.ndarray:
    n = a.shape[0]
    m = ((n + multiple - 1) // multiple) * multiple
    if m == n:
        return a
    return np.concatenate([a, np.full(m - n, fill, a.dtype)])


def keys_need_pair(keys) -> bool:
    """True when the keys exceed f32 exactness (need the hi/lo pair)."""
    k = np.asarray(keys, np.float64)
    f = k[np.isfinite(k)]
    if f.size == 0:
        return False
    return not bool(np.all(f.astype(np.float32).astype(np.float64) == f))


def keys_pair_exact(keys) -> bool:
    """True when every key is represented EXACTLY by its f32 hi/lo pair
    (hi + lo == key in f64 — holds e.g. for all integer keys < 2^48)."""
    k = np.asarray(keys, np.float64)
    f = k[np.isfinite(k)]
    if f.size == 0:
        return True
    hi, lo = split_key_pair(f)
    return bool(np.all(hi.astype(np.float64) + lo.astype(np.float64) == f))


def pair_alias_free(sorted_keys) -> bool:
    """True when no two DISTINCT keys of this sorted array share an f32
    hi/lo pair (the device search then never conflates stored keys)."""
    k = np.asarray(sorted_keys, np.float64)
    f = k[np.isfinite(k)]
    if f.size < 2:
        return True
    hi, lo = split_key_pair(f)
    same_pair = (hi[1:] == hi[:-1]) & (lo[1:] == lo[:-1])
    distinct = f[1:] != f[:-1]
    return not bool(np.any(same_pair & distinct))


def split_key_pair(keys):
    """(hi, lo) f32 pair with ``lo = key - f64(hi)``; non-finite keys
    get lo = 0."""
    k = np.asarray(keys, np.float64)
    hi = k.astype(np.float32)
    with np.errstate(invalid="ignore"):
        lo = k - hi.astype(np.float64)
    lo = np.where(np.isfinite(k), lo, 0.0)
    return hi, lo.astype(np.float32)


def _split_i64(a: np.ndarray):
    """(lo32, hi32) two's-complement split of an int64 array."""
    a = np.asarray(a, np.int64)
    return a.astype(np.int32), (a >> 32).astype(np.int32)


class _CapacityError(Exception):
    """A forced static (chain bound, link capacity, width) cannot hold
    the current state."""


_NP_FIELDS = ("seg_first_key", "seg_first_key_lo", "seg_slope",
              "seg_icept", "seg_slope_lo", "seg_icept_lo",
              "slot_key", "slot_key_lo", "payload", "payload_hi",
              "link_offsets", "link_keys", "link_keys_lo", "link_payloads",
              "link_payload_hi")


def _freeze_numpy(index, *, w_tile: int = 2048, seg_chunk: int = 512,
                  max_chain: Optional[int] = None,
                  link_cap: Optional[int] = None,
                  force_wide: Optional[bool] = None,
                  force_key_wide: Optional[bool] = None):
    """Derive the padded numpy device images from host state.

    Returns ``(arrays: dict[str, np.ndarray], statics: dict)``.
    """
    plm = getattr(index.mech, "plm", None)
    if plm is None:
        raise ValueError("mechanism does not export a piecewise linear model")
    if isinstance(index.gapped, _k64.GappedArray64):
        return _freeze_numpy_u64(index, w_tile=w_tile, seg_chunk=seg_chunk,
                                 max_chain=max_chain, link_cap=link_cap,
                                 force_wide=force_wide)
    if index.gapped is not None:
        ga = index.gapped
        slot_key = np.asarray(ga.slot_key, np.float64)
        payload = np.asarray(ga.payload, np.int64)
        offsets, lkeys, lpay = ga.export_csr_links()
        chain = ga.links.max_chain
        live = payload[np.asarray(ga.occupied, bool)]
    else:
        slot_key = np.asarray(index.keys, np.float64)
        payload = np.arange(slot_key.shape[0], dtype=np.int64)
        offsets = np.zeros(slot_key.shape[0] + 1, np.int64)
        lkeys = np.zeros(0, np.float64)
        lpay = np.zeros(0, np.int64)
        chain = 0
        live = payload
    if max_chain is None:
        max_chain = int(chain)
    elif chain > max_chain:
        raise _CapacityError(f"max_chain {chain} > frozen {max_chain}")

    wide = bool(
        (live.size and (live.min() < _I32_MIN or live.max() > _I32_MAX))
        or (lpay.size and (lpay.min() < _I32_MIN or lpay.max() > _I32_MAX))
    )
    if force_wide is not None:
        if wide and not force_wide:
            raise _CapacityError("payloads outgrew the narrow i32 freeze")
        wide = force_wide
    key_wide = keys_need_pair(slot_key) or keys_need_pair(lkeys)
    if force_key_wide is not None:
        if key_wide and not force_key_wide:
            raise _CapacityError("keys outgrew the narrow f32 freeze")
        key_wide = force_key_wide

    n_slots = slot_key.shape[0]
    sk_hi, sk_lo = split_key_pair(slot_key)
    skp = _pad_pow(sk_hi, w_tile, np.float32(np.inf))
    # one extra +inf block so the (b, b+1) window pair is always valid
    skp = np.concatenate([skp, np.full(w_tile, np.inf, np.float32)])
    sklp = np.concatenate(
        [_pad_pow(sk_lo, w_tile, np.float32(0)),
         np.zeros(w_tile, np.float32)])
    pay_lo, pay_hi = _split_i64(payload)
    m_extra = skp.shape[0] - pay_lo.shape[0]
    pay_lo = np.concatenate([pay_lo, np.full(m_extra, -1, np.int32)])
    pay_hi = np.concatenate([pay_hi, np.full(m_extra, -1, np.int32)])

    if link_cap is None:
        link_cap = int(lkeys.shape[0])
    elif lkeys.shape[0] > link_cap:
        raise _CapacityError(
            f"links {lkeys.shape[0]} > frozen capacity {link_cap}")
    lk_hi, lk_lo = split_key_pair(lkeys)
    l_extra = link_cap - lkeys.shape[0]
    lk_hi = np.concatenate([lk_hi, np.full(l_extra, np.inf, np.float32)])
    lk_lo = np.concatenate([lk_lo, np.zeros(l_extra, np.float32)])
    lpay_lo, lpay_hi = _split_i64(lpay)
    lpay_lo = np.concatenate([lpay_lo, np.full(l_extra, -1, np.int32)])
    lpay_hi = np.concatenate([lpay_hi, np.full(l_extra, -1, np.int32)])
    # offsets padded past the slot blocks so the three offset blocks a
    # tile reads (b, b+1, b+2 — slot+1 can land one element past the
    # 2*w_tile window) are always in range
    offp = np.concatenate(
        [offsets, np.full(skp.shape[0] + w_tile - offsets.shape[0],
                          offsets[-1])]
    ).astype(np.int32)
    none32f = np.zeros(0, np.float32)
    none32i = np.zeros(0, np.int32)

    arrays = {
        **_seg_images(plm, n_slots, seg_chunk, key_wide),
        "slot_key": skp,
        "slot_key_lo": sklp if key_wide else none32f,
        "payload": pay_lo,
        "payload_hi": pay_hi if wide else none32i,
        "link_offsets": offp,
        "link_keys": lk_hi,
        "link_keys_lo": lk_lo if key_wide else none32f,
        "link_payloads": lpay_lo,
        "link_payload_hi": lpay_hi if wide else none32i,
    }
    statics = {"n_slots": n_slots, "max_chain": int(max_chain),
               "wide": wide, "key_wide": key_wide, "w_tile": w_tile,
               "seg_chunk": seg_chunk, "link_cap": int(link_cap)}
    return arrays, statics


def _seg_images(plm, n_slots: int, seg_chunk: int, key_wide: bool,
                u64: bool = False) -> dict:
    """The padded segment tables of ``_freeze_numpy`` (``u64``: of
    ``_freeze_numpy_u64``)."""
    none32f = np.zeros(0, np.float32)
    if u64:
        return {
            "seg_first_key": _pad_pow(
                _k64.seg_first_ordered(plm.seg_first_key), seg_chunk,
                _k64.NO_KEY),
            "seg_first_key_lo": none32f,
            "seg_slope": _pad_pow(np.asarray(plm.slope, np.float64),
                                  seg_chunk, 0.0),
            "seg_icept": _pad_pow(np.asarray(plm.icept, np.float64),
                                  seg_chunk, float(n_slots - 1)),
            "seg_slope_lo": none32f,
            "seg_icept_lo": none32f,
        }
    sfk = np.asarray(plm.seg_first_key, np.float64)
    sfk_hi, sfk_lo = split_key_pair(sfk)
    return {
        "seg_first_key": _pad_pow(sfk_hi, seg_chunk, np.float32(np.inf)),
        "seg_first_key_lo": (
            np.concatenate([sfk_lo,
                            np.zeros(_pad_pow(sfk_hi, seg_chunk,
                                              np.float32(np.inf)).shape[0]
                                     - sfk_lo.shape[0], np.float32)])
            if key_wide else none32f),
        "seg_slope": _pad_pow(np.asarray(plm.slope, np.float32), seg_chunk,
                              np.float32(0)),
        "seg_icept": _pad_pow(np.asarray(plm.icept, np.float32), seg_chunk,
                              np.float32(n_slots - 1)),
        # double-f32 residuals (slope - f32(slope), icept - f32(icept))
        # for the ingest-place path's on-device slot prediction
        "seg_slope_lo": _pad_pow(
            (np.asarray(plm.slope, np.float64)
             - np.asarray(plm.slope, np.float32).astype(np.float64)
             ).astype(np.float32), seg_chunk, np.float32(0)),
        "seg_icept_lo": _pad_pow(
            (np.asarray(plm.icept, np.float64)
             - np.asarray(plm.icept, np.float32).astype(np.float64)
             ).astype(np.float32), seg_chunk, np.float32(0)),
    }


def _freeze_numpy_u64(index, *, w_tile, seg_chunk, max_chain, link_cap,
                      force_wide):
    """``_freeze_numpy`` of a ``keys64.GappedArray64``: the 64-bit image
    (see the module doc), the same shapes, capacities and payload
    halves as the float images."""
    plm = index.mech.plm
    ga = index.gapped
    payload = np.asarray(ga.payload, np.int64)
    offsets, lkeys, lpay = ga.export_csr_links()
    chain = ga.links.max_chain
    live = payload[np.asarray(ga.occupied, bool)]
    if max_chain is None:
        max_chain = int(chain)
    elif chain > max_chain:
        raise _CapacityError(f"max_chain {chain} > frozen {max_chain}")
    wide = bool(
        (live.size and (live.min() < _I32_MIN or live.max() > _I32_MAX))
        or (lpay.size and (lpay.min() < _I32_MIN or lpay.max() > _I32_MAX))
    )
    if force_wide is not None:
        if wide and not force_wide:
            raise _CapacityError("payloads outgrew the narrow i32 freeze")
        wide = force_wide
    if link_cap is None:
        link_cap = int(lkeys.shape[0])
    elif lkeys.shape[0] > link_cap:
        raise _CapacityError(
            f"links {lkeys.shape[0]} > frozen capacity {link_cap}")
    no_key = _k64.NO_KEY
    n_slots = ga.n_slots
    skp = _pad_pow(np.asarray(ga.slot_key, np.int64), w_tile, no_key)
    skp = np.concatenate([skp, np.full(w_tile, no_key, np.int64)])
    pay_lo, pay_hi = _split_i64(payload)
    m_extra = skp.shape[0] - pay_lo.shape[0]
    pay_lo = np.concatenate([pay_lo, np.full(m_extra, -1, np.int32)])
    pay_hi = np.concatenate([pay_hi, np.full(m_extra, -1, np.int32)])
    l_extra = link_cap - lkeys.shape[0]
    lk = np.concatenate([np.asarray(lkeys, np.int64),
                         np.full(l_extra, no_key, np.int64)])
    lpay_lo, lpay_hi = _split_i64(lpay)
    lpay_lo = np.concatenate([lpay_lo, np.full(l_extra, -1, np.int32)])
    lpay_hi = np.concatenate([lpay_hi, np.full(l_extra, -1, np.int32)])
    offp = np.concatenate(
        [offsets, np.full(skp.shape[0] + w_tile - offsets.shape[0],
                          offsets[-1])]).astype(np.int32)
    none32f = np.zeros(0, np.float32)
    none32i = np.zeros(0, np.int32)
    arrays = {
        **_seg_images(plm, n_slots, seg_chunk, False, u64=True),
        "slot_key": skp,
        "slot_key_lo": none32f,
        "payload": pay_lo,
        "payload_hi": pay_hi if wide else none32i,
        "link_offsets": offp,
        "link_keys": lk,
        "link_keys_lo": none32f,
        "link_payloads": lpay_lo,
        "link_payload_hi": lpay_hi if wide else none32i,
    }
    statics = {"n_slots": n_slots, "max_chain": int(max_chain),
               "wide": wide, "key_wide": False, "key_u64": True,
               "w_tile": w_tile, "seg_chunk": seg_chunk,
               "link_cap": int(link_cap)}
    return arrays, statics


@dataclasses.dataclass(frozen=True)
class IndexArrays:
    """Frozen device-side index state: f32/i32 tensors on one device.

    Narrow builds keep the ``*_lo`` / ``*_hi`` tensors zero-length.
    The 64-bit image (``key_u64``) holds the key tensors as ordered
    int64 and the segment lines as float64 (see the module doc).
    """

    seg_first_key: torch.Tensor     # (Kpad,) f32, +inf padded
    seg_first_key_lo: torch.Tensor  # (Kpad,) f32 when key_wide else (0,)
    seg_slope: torch.Tensor         # (Kpad,) f32
    seg_icept: torch.Tensor         # (Kpad,) f32
    seg_slope_lo: torch.Tensor      # (Kpad,) f32
    seg_icept_lo: torch.Tensor      # (Kpad,) f32
    slot_key: torch.Tensor          # (Mpad,) f32, +inf padded
    slot_key_lo: torch.Tensor       # (Mpad,) f32 when key_wide else (0,)
    payload: torch.Tensor           # (Mpad,) i32 — low 32 payload bits
    payload_hi: torch.Tensor        # (Mpad,) i32 when wide else (0,)
    link_offsets: torch.Tensor      # (Mpad + w_tile,) i32
    link_keys: torch.Tensor         # (Lpad,) f32
    link_keys_lo: torch.Tensor      # (Lpad,) f32 when key_wide else (0,)
    link_payloads: torch.Tensor     # (Lpad,) i32
    link_payload_hi: torch.Tensor   # (Lpad,) i32 when wide else (0,)
    n_slots: int
    max_chain: int
    wide: bool
    key_wide: bool
    key_u64: bool = False

    @property
    def device(self) -> torch.device:
        return self.slot_key.device

    def nbytes(self) -> int:
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in _NP_FIELDS)


def to_device(arrays: dict, statics: dict, device) -> IndexArrays:
    """Upload the numpy images (the ``_to_device`` counterpart)."""
    return IndexArrays(
        **{f: torch.from_numpy(np.ascontiguousarray(arrays[f])).to(device)
           for f in _NP_FIELDS},
        n_slots=statics["n_slots"], max_chain=statics["max_chain"],
        wide=statics["wide"], key_wide=statics["key_wide"],
        key_u64=statics.get("key_u64", False),
    )


def from_learned_index(index, device, *, w_tile: int = 2048,
                       seg_chunk: int = 512,
                       max_chain: Optional[int] = None) -> IndexArrays:
    """Freeze an index at its current capacities (no headroom)."""
    arrays, statics = _freeze_numpy(index, w_tile=w_tile,
                                    seg_chunk=seg_chunk, max_chain=max_chain)
    return to_device(arrays, statics, device)


def _round_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def freeze_numpy_headroom(index, *, w_tile: int = 2048, seg_chunk: int = 512,
                          chain_headroom: int = 2,
                          link_headroom: float = 2.0):
    """The freeze half of the reference's ``freeze_state``:
    ``_freeze_numpy`` with capacities frozen WITH headroom (max chain
    x``chain_headroom``, link storage x``link_headroom``, power of two)
    so later delta updates keep the shapes.  Returns ``(numpy arrays,
    statics)``; ``delta.freeze_state`` uploads them."""
    max_chain, link_cap = _headroom(index, chain_headroom, link_headroom)
    return _freeze_numpy(index, w_tile=w_tile, seg_chunk=seg_chunk,
                         max_chain=max_chain, link_cap=link_cap)


def _headroom(index, chain_headroom, link_headroom):
    """``(max_chain, link_cap)`` frozen with headroom."""
    ga = getattr(index, "gapped", None)
    chain = ga.links.max_chain if ga is not None else 0
    total = ga.links.total if ga is not None else 0
    max_chain = max(4, chain_headroom * max(chain, 1))
    link_cap = _round_pow2(max(64, int(link_headroom * max(total, 1))))
    return max_chain, link_cap


def _stream(arrays, dev, stages, chunk=None):
    """``(start, chunks)`` over equal-length host ``arrays``: chunks of
    ``chunk`` (default ``IMAGE_CHUNK``) elements on ``dev``, each copy
    timed as the freeze's ``upload`` stage (on the host, a chunk is the
    array's memory)."""
    chunk = chunk or IMAGE_CHUNK
    for a in range(0, arrays[0].shape[0], chunk):
        with span("freeze.upload", stages):
            chunks = [torch.from_numpy(np.ascontiguousarray(
                x[a:a + chunk])).to(dev) for x in arrays]
        yield a, chunks


def split_key_pair_t(k: torch.Tensor):
    """``split_key_pair`` of a float64 tensor, on its device."""
    hi = k.to(torch.float32)
    lo = torch.where(torch.isfinite(k), k - hi.double(), 0.0)
    return hi, lo.to(torch.float32)


def _needs_pair_t(k: torch.Tensor) -> torch.Tensor:
    """``keys_need_pair`` of a float64 tensor, as a device bool."""
    return (torch.isfinite(k) & (k.to(torch.float32).double() != k)).any()


def _outside_i32_t(p: torch.Tensor) -> torch.Tensor:
    """Whether any of the int64 ``p`` leaves int32, as a device bool."""
    return ((p < _I32_MIN) | (p > _I32_MAX)).any()


def key_wide_device(index, slot_key: torch.Tensor, stages=None) -> bool:
    """``key_wide`` of a float index's images: whether its slot keys
    (``slot_key``, float64 on the device) or its chain keys need the f32
    pair (``keys_need_pair``), reduced on the device in chunks of
    ``IMAGE_CHUNK``.  ``stages`` gains the chain keys' copies as
    ``upload`` and the rest as ``images``."""
    with span("freeze.images", stages):
        need = torch.zeros((), dtype=torch.bool, device=slot_key.device)
        for a in range(0, slot_key.shape[0], IMAGE_CHUNK):
            need |= _needs_pair_t(slot_key[a:a + IMAGE_CHUNK])
        if bool(need):
            return True
        lkeys = np.asarray(index.gapped.export_csr_links()[1], np.float64)
    for _a, (k,) in _stream((lkeys,), slot_key.device, stages):
        with span("freeze.images", stages):
            need |= _needs_pair_t(k)
    with span("freeze.images", stages):
        return bool(need)


def freeze_headroom_device(index, device, *, key_wide: bool,
                           w_tile: int = 2048, seg_chunk: int = 512,
                           chain_headroom: int = 2,
                           link_headroom: float = 2.0, stages=None):
    """``to_device(*freeze_numpy_headroom(index, ...), device)`` of a
    gapped index, written on ``device``: ``(IndexArrays, statics)``, the
    same tensors element for element and the same statics.  ``key_wide``
    is the caller's (``key_wide_device``; False for 64-bit keys).

    Each image is allocated padded just before the host arrays stream
    into it, in chunks of ``IMAGE_CHUNK`` split there.  The link offsets
    come last, in chunks of ``TAIL_CHUNK``: until then the device holds
    less than the images, so the freeze's peak stays the images' bytes
    plus a ``TAIL_CHUNK`` chunk.  ``wide`` is reduced while the low
    payload halves stream; when set, the high halves take a second
    pass.  ``stages`` gains the copies as ``upload`` and the rest as
    ``images``."""
    ga = index.gapped
    plm = index.mech.plm
    dev = torch.device(device)
    u64 = isinstance(ga, _k64.GappedArray64)
    i32, f32 = torch.int32, torch.float32
    img = {}

    def alloc(name, n, value, dtype=i32):
        with span("freeze.images", stages):
            img[name] = torch.full((n,), value, dtype=dtype, device=dev)

    def fill(srcs, write, chunk=None):
        # the chunks are this call's locals: freed when it returns
        for a, chunks in _stream(srcs, dev, stages, chunk):
            with span("freeze.images", stages):
                write(a, *chunks)

    with span("freeze.images", stages):
        max_chain, link_cap = _headroom(index, chain_headroom,
                                        link_headroom)
        offsets, lkeys, lpay = ga.export_csr_links()
        kdt = np.int64 if u64 else np.float64
        payload = np.asarray(ga.payload, np.int64)
        lpay = np.asarray(lpay, np.int64)
        n_slots = int(ga.slot_key.shape[0])
        # whole w_tile blocks plus one +inf block, as ``_freeze_numpy``
        m_pad = -(-n_slots // w_tile) * w_tile + w_tile
        no_key, key_t = ((int(_k64.NO_KEY), torch.int64) if u64
                         else (np.inf, f32))
        wide = torch.zeros((), dtype=torch.bool, device=dev)

    def keys(name):
        def write(a, k):
            if u64:
                img[name][a:a + k.shape[0]] = k
                return
            hi, lo = split_key_pair_t(k)
            img[name][a:a + k.shape[0]] = hi
            if key_wide:
                img[name + "_lo"][a:a + k.shape[0]] = lo
        return write

    def low_halves(name):
        def write(a, p, *occ):
            img[name][a:a + p.shape[0]] = p.to(i32)
            wide.logical_or_(_outside_i32_t(p.where(occ[0], 0) if occ
                                            else p))
        return write

    def high_halves(name):
        def write(a, p):
            img[name][a:a + p.shape[0]] = (p >> 32).to(i32)
        return write

    for name, src, n in (("slot_key", ga.slot_key, m_pad),
                         ("link_keys", lkeys, link_cap)):
        alloc(name, n, no_key, key_t)
        alloc(name + "_lo", n if key_wide else 0, 0, f32)
        fill((np.asarray(src, kdt),), keys(name))
    alloc("payload", m_pad, -1)
    fill((payload, np.asarray(ga.occupied, bool)), low_halves("payload"))
    alloc("link_payloads", link_cap, -1)
    fill((lpay,), low_halves("link_payloads"))
    with span("freeze.images", stages):
        wide = bool(wide)
    for name, src, n in (("payload_hi", payload, m_pad),
                         ("link_payload_hi", lpay, link_cap)):
        alloc(name, n if wide else 0, -1)
        if wide:   # the high payload halves: a second pass
            fill((src,), high_halves(name))
    offsets = np.asarray(offsets, np.int64)
    alloc("link_offsets", m_pad + w_tile,
          int(offsets[-1].astype(np.int32)))

    def offsets_into(a, o):
        img["link_offsets"][a:a + o.shape[0]] = o.to(i32)

    fill((offsets,), offsets_into, TAIL_CHUNK)
    with span("freeze.images", stages):
        seg = _seg_images(plm, n_slots, seg_chunk, key_wide, u64=u64)
    with span("freeze.upload", stages):
        img.update({f: torch.from_numpy(a).to(dev) for f, a in seg.items()})
    statics = {"n_slots": n_slots, "max_chain": int(max_chain),
               "wide": wide, "key_wide": key_wide, "w_tile": w_tile,
               "seg_chunk": seg_chunk, "link_cap": int(link_cap)}
    if u64:
        statics["key_u64"] = True
    return IndexArrays(**img, n_slots=n_slots, max_chain=int(max_chain),
                       wide=wide, key_wide=key_wide, key_u64=u64), statics
