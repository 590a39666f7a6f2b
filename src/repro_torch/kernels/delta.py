"""Epoch-versioned device state: freeze with a host mirror, and delta
updates that move only the changed elements.

Counterpart of ``repro.kernels.ops``' ``HostMirror``, ``freeze_state``,
``_snapshot_sources``, ``_images_from_sources``, ``_diff_grown``,
``delta_update`` and ``_DELTA_FIELDS``.  The decline rules, the
dense-vs-sparse choice, ``n_changed`` and ``touched_keys`` are the
reference's, so the handle's labels and stats match it.  What differs:
the reference pads a sparse diff to a fixed capacity so XLA compiles
one scatter; here a sparse diff is one indexed assignment into the
device tensor, in place (nothing else holds the old images).

A CUDA index freezes on the card (``freezes_on_device``): the window
bounds (``bounds.query_window_bounds_device``) and the images
(``freeze.freeze_headroom_device``) are derived there from the index's
host arrays, uploaded in chunks, the engine's routers read the images
there, and the mirror's images are the card's, read back.
Every other device keeps the host path; both give the same engine and
mirror.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import keys64 as _k64
from ..spans import span
from .bounds import query_window_bounds, query_window_bounds_device
from .freeze import (_I32_MAX, _I32_MIN, IndexArrays, _pad_pow, _split_i64,
                     freeze_headroom_device, freeze_numpy_headroom,
                     key_wide_device, keys_need_pair,
                     split_key_pair, to_device)
from .place import PLM_METHODS

__all__ = ["HostMirror", "freeze_state", "freezes_on_device",
           "delta_update", "DELTA_FIELDS"]

# fields a host mutation can change (mech/seg tables never move)
DELTA_FIELDS = ("slot_key", "slot_key_lo", "payload", "payload_hi",
                "link_offsets", "link_keys", "link_keys_lo",
                "link_payloads", "link_payload_hi")

# a diff up to this many elements is scattered; a larger one uploads
# the patched image (the reference's fixed scatter capacity)
_SCATTER_CAP = 8192

device_freezes = 0   # freezes run on the device (``freezes_on_device``)


@dataclasses.dataclass
class HostMirror:
    """Host-side state at the device's epoch — what ``delta_update``
    diffs against and patches forward.

    ``sources``: f64/i64 copies of the unpadded index arrays.
    ``images``: the padded device-dtype buffers, patched in place so a
    dense diff uploads an already-built image (None after a fused
    commit: rebuilt lazily by the next host delta).  ``statics``: the
    frozen capacities.  ``links_at_freeze``/``n_keys_at_freeze``: the
    refreeze policy's growth baseline.  ``freeze_device``: where the
    freeze ran, ``"host"`` or the device type (``freezes_on_device``).
    """

    sources: dict
    images: dict
    statics: dict
    links_at_freeze: int
    n_keys_at_freeze: int
    freeze_device: str = "host"


def _upload(img: np.ndarray, device) -> torch.Tensor:
    """A device copy that never shares memory with the host image."""
    return torch.from_numpy(img).to(device, copy=True)


def freezes_on_device(index, device) -> bool:
    """Whether ``freeze_state`` takes ``index`` to ``device``: a CUDA
    device and a gapped index whose mechanism predicts through its PLM
    (``place.PLM_METHODS``, as every 64-bit index does)."""
    return (torch.device(device).type == "cuda"
            and getattr(index, "gapped", None) is not None
            and getattr(index.mech, "name", None) in PLM_METHODS)


def freeze_state(index, device, *, w_tile: int = 2048,
                 seg_chunk: int = 512, stages: Optional[dict] = None,
                 **engine_kwargs):
    """Freeze an index into a ``QueryEngine`` + ``HostMirror`` pair,
    capacities frozen with headroom (``freeze.freeze_numpy_headroom``)
    so delta updates keep the shapes.  ``stages``, when given, gains
    the seconds of each stage: ``images`` (the padded images),
    ``upload`` (the copies to the device), ``bounds`` (the query-safe
    window bounds), ``routers`` (the engine: its bounds upload and its
    radix and rank routers) and ``mirror`` (the host mirror's copies).
    The 64-bit image serves no write, so its mirror holds no copies.
    Where ``freezes_on_device``, ``freeze_on_device`` derives them on
    the device."""
    from .ops import QueryEngine
    if freezes_on_device(index, device):
        return freeze_on_device(index, device, w_tile=w_tile,
                                seg_chunk=seg_chunk, stages=stages,
                                **engine_kwargs)
    with span("freeze.images", stages):
        np_arrays, statics = freeze_numpy_headroom(index, w_tile=w_tile,
                                                   seg_chunk=seg_chunk)
    with span("freeze.upload", stages):
        arrays = to_device(np_arrays, statics, device)
    with span("freeze.bounds", stages):
        err_lo, err_hi = query_window_bounds(index)
    with span("freeze.routers", stages):
        engine = QueryEngine(arrays, err_lo, err_hi, w_tile=w_tile,
                             **engine_kwargs)
    with span("freeze.mirror", stages):
        images = {} if arrays.key_u64 else {
            f: np_arrays[f].copy() for f in DELTA_FIELDS if np_arrays[f].size}
        mirror = _mirror(index, arrays, images, statics, "host")
    return engine, mirror


def freeze_on_device(index, device, *, w_tile: int = 2048,
                     seg_chunk: int = 512, stages: Optional[dict] = None,
                     **engine_kwargs):
    """``freeze_state``'s engine and mirror with the passes over every
    key and slot on ``device`` (see the module doc), for an index that
    ``freezes_on_device`` allows (tests run it on the CPU).  The slot
    keys go up whole for the window bounds and ``key_wide``, and are
    freed before the first image is allocated; from
    there the device holds no more than the images and a small chunk
    (``freeze.freeze_headroom_device``)."""
    global device_freezes
    from .ops import QueryEngine
    ga = index.gapped
    u64 = isinstance(ga, _k64.GappedArray64)
    dev = torch.device(device)
    with span("freeze.upload", stages):
        slot_key = torch.from_numpy(np.ascontiguousarray(
            ga.slot_key, np.int64 if u64 else np.float64)).to(dev)
    err_lo, err_hi = query_window_bounds_device(index, slot_key,
                                                stages=stages)
    key_wide = False if u64 else key_wide_device(index, slot_key, stages)
    del slot_key
    arrays, statics = freeze_headroom_device(
        index, dev, key_wide=key_wide, w_tile=w_tile, seg_chunk=seg_chunk,
        stages=stages)
    with span("freeze.routers", stages):
        engine = QueryEngine(arrays, err_lo, err_hi, w_tile=w_tile,
                             **engine_kwargs)
    with span("freeze.mirror", stages):
        # the write path's dense diffs patch the host images: one copy
        # of each device image
        images = {} if u64 else {
            f: getattr(arrays, f).to("cpu", copy=True).numpy()
            for f in DELTA_FIELDS if getattr(arrays, f).numel()}
        mirror = _mirror(index, arrays, images, statics, dev.type)
    device_freezes += 1
    return engine, mirror


def _mirror(index, arrays, images, statics, where) -> HostMirror:
    ga = getattr(index, "gapped", None)
    total = ga.links.total if ga is not None else 0
    n_keys = ga.n_keys if ga is not None else int(index.keys.shape[0])
    return HostMirror(
        sources={} if arrays.key_u64 else snapshot_sources(index),
        images=images, statics=statics, links_at_freeze=total,
        n_keys_at_freeze=n_keys, freeze_device=where)


def snapshot_sources(index) -> dict:
    ga = getattr(index, "gapped", None)
    if ga is None:
        return {}
    offsets, lkeys, lpay = ga.export_csr_links()
    return {"slot_key": np.array(ga.slot_key, np.float64),
            "payload": np.array(ga.payload, np.int64),
            "offsets": np.array(offsets, np.int64),
            "link_keys": np.array(lkeys, np.float64),
            "link_payloads": np.array(lpay, np.int64)}


def images_from_sources(sources: dict, statics: dict) -> dict:
    """Rebuild the padded device-dtype delta images from a host source
    snapshot (after a fused commit advanced the sources without them)."""
    w_tile = statics["w_tile"]
    sk_hi, sk_lo = split_key_pair(sources["slot_key"])
    skp = _pad_pow(sk_hi, w_tile, np.float32(np.inf))
    skp = np.concatenate([skp, np.full(w_tile, np.inf, np.float32)])
    sklp = np.concatenate([_pad_pow(sk_lo, w_tile, np.float32(0)),
                           np.zeros(w_tile, np.float32)])
    pay_lo, pay_hi = _split_i64(sources["payload"])
    m_extra = skp.shape[0] - pay_lo.shape[0]
    pay_lo = np.concatenate([pay_lo, np.full(m_extra, -1, np.int32)])
    pay_hi = np.concatenate([pay_hi, np.full(m_extra, -1, np.int32)])
    offsets = sources["offsets"]
    offp = np.concatenate(
        [offsets, np.full(skp.shape[0] + w_tile - offsets.shape[0],
                          offsets[-1])]).astype(np.int32)
    link_cap = statics["link_cap"]
    lk_hi, lk_lo = split_key_pair(sources["link_keys"])
    l_extra = link_cap - lk_hi.shape[0]
    lk_hi = np.concatenate([lk_hi, np.full(l_extra, np.inf, np.float32)])
    lk_lo = np.concatenate([lk_lo, np.zeros(l_extra, np.float32)])
    lpay_lo, lpay_hi = _split_i64(sources["link_payloads"])
    lpay_lo = np.concatenate([lpay_lo, np.full(l_extra, -1, np.int32)])
    lpay_hi = np.concatenate([lpay_hi, np.full(l_extra, -1, np.int32)])
    none32f = np.zeros(0, np.float32)
    none32i = np.zeros(0, np.int32)
    images = {
        "slot_key": skp,
        "slot_key_lo": sklp if statics["key_wide"] else none32f,
        "payload": pay_lo,
        "payload_hi": pay_hi if statics["wide"] else none32i,
        "link_offsets": offp,
        "link_keys": lk_hi,
        "link_keys_lo": lk_lo if statics["key_wide"] else none32f,
        "link_payloads": lpay_lo,
        "link_payload_hi": lpay_hi if statics["wide"] else none32i,
    }
    return {f: img for f, img in images.items() if img.size}


def _diff_grown(old: np.ndarray, new: np.ndarray) -> np.ndarray:
    """Changed indices between two source arrays that may differ in
    length; positions past the new length are unread on device (the
    offsets bound every chain scan), so only [0, len(new)) matters."""
    n0, n1 = old.shape[0], new.shape[0]
    lo = min(n0, n1)
    d = np.flatnonzero(old[:lo] != new[:lo])
    if n1 > lo:
        d = np.concatenate([d, np.arange(lo, n1)])
    return d


def delta_update(arrays: IndexArrays, mirror: HostMirror, index,
                 max_diff_frac: float = 0.5):
    """Bring the frozen device tensors to the index's current host
    state by writing ONLY changed elements (slot_key/payload entries
    for slot placements, CSR link-table tails + shifted offsets for
    chain appends; a dense diff uploads the patched image).

    Returns ``(new_arrays, n_changed, touched_keys)`` — ``touched_keys``
    holds the finite slot-key values whose placement changed (old and
    new), for the caller's incremental window-bound refresh.  Declines
    with ``(None, 0, None)`` when a frozen capacity no longer holds or
    the diff would touch more than ``max_diff_frac`` of the slots (a
    refreeze is then cheaper).  On success the mirror is advanced; a
    sparse diff is written into ``arrays``' tensors in place.
    """
    ga = getattr(index, "gapped", None)
    if ga is None or not mirror.sources:
        return None, 0, None
    st = mirror.statics
    if ga.n_slots != st["n_slots"]:
        return None, 0, None
    offsets, lkeys, lpay = ga.export_csr_links()
    if ga.links.max_chain > st["max_chain"]:
        return None, 0, None
    if lkeys.shape[0] > st["link_cap"]:
        return None, 0, None
    src = mirror.sources
    d_slot = np.flatnonzero(src["slot_key"] != np.asarray(ga.slot_key))
    d_pay = np.flatnonzero(src["payload"] != np.asarray(ga.payload))
    d_off = np.flatnonzero(src["offsets"] != offsets)
    d_lk = _diff_grown(src["link_keys"], lkeys)
    d_lp = _diff_grown(src["link_payloads"], lpay)
    changed = int(d_slot.size + d_pay.size + d_off.size + d_lk.size
                  + d_lp.size)
    if changed == 0:  # epoch moved without visible writes
        return arrays, 0, np.zeros(0, np.float64)
    if (d_slot.size + d_pay.size) > max_diff_frac * ga.n_slots:
        return None, 0, None
    # slot keys whose VALUE moved (old values too — a delete shifts its
    # old neighborhood); chain-inserted keys come from the handle's own
    # mutation log, since a CSR mid-insert shifts the whole tail
    touched_keys = np.concatenate([
        np.asarray(ga.slot_key)[d_slot], src["slot_key"][d_slot]])
    touched_keys = touched_keys[np.isfinite(touched_keys)]
    # width statics: only the CHANGED values can violate them
    new_pay = np.asarray(ga.payload)[d_pay]
    new_lpay = lpay[d_lp]
    if not st["wide"] and (
            (new_pay.size and (new_pay.min() < _I32_MIN
                               or new_pay.max() > _I32_MAX))
            or (new_lpay.size and (new_lpay.min() < _I32_MIN
                                   or new_lpay.max() > _I32_MAX))):
        return None, 0, None
    new_sk = np.asarray(ga.slot_key)[d_slot]
    if not st["key_wide"] and (keys_need_pair(new_sk)
                               or keys_need_pair(lkeys[d_lk])):
        return None, 0, None
    # pair-ALIASING of distinct keys (beyond ~2^48) is the caller's
    # gate (Index._key_caps), as in the reference

    if mirror.images is None:
        mirror.images = images_from_sources(src, st)

    dev = arrays.device
    updates = {}

    def upd(field, d, vals):
        """Sparse patch: fix the padded host image, then write the
        changed elements into the device tensor (a large diff uploads
        the patched image instead)."""
        img = mirror.images[field]
        img[d] = vals
        if d.size <= _SCATTER_CAP:
            getattr(arrays, field)[torch.from_numpy(d).to(dev)] = \
                _upload(np.ascontiguousarray(vals), dev)
        else:
            updates[field] = _upload(img, dev)

    def upd_dense(field, prefix):
        """Dense patch (e.g. a chain append mid-array shifts every
        downstream CSR offset): one contiguous prefix write, one
        upload."""
        img = mirror.images[field]
        img[: prefix.shape[0]] = prefix
        updates[field] = _upload(img, dev)

    def pair_group(fields, d, full64, split):
        dense = d.size > max(full64.shape[0] // 2, _SCATTER_CAP)
        parts = split(full64 if dense else full64[d])
        for f, part in zip(fields, parts):
            if f is None:
                continue
            (upd_dense(f, part) if dense else upd(f, d, part))

    if d_slot.size:
        pair_group(("slot_key", "slot_key_lo" if st["key_wide"] else None),
                   d_slot, np.asarray(ga.slot_key), split_key_pair)
        src["slot_key"][d_slot] = new_sk
    if d_pay.size:
        pair_group(("payload", "payload_hi" if st["wide"] else None),
                   d_pay, np.asarray(ga.payload), _split_i64)
        src["payload"][d_pay] = new_pay
    if d_off.size:
        pair_group(("link_offsets", None), d_off, offsets,
                   lambda a: (a.astype(np.int32),))
        src["offsets"] = np.array(offsets, np.int64)
    if d_lk.size:
        pair_group(("link_keys", "link_keys_lo" if st["key_wide"] else None),
                   d_lk, lkeys, split_key_pair)
        src["link_keys"] = np.array(lkeys, np.float64)
    if d_lp.size:
        pair_group(("link_payloads",
                    "link_payload_hi" if st["wide"] else None),
                   d_lp, lpay, _split_i64)
        src["link_payloads"] = np.array(lpay, np.int64)
    return dataclasses.replace(arrays, **updates), changed, touched_keys
