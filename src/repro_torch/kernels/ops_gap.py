"""The device entry points of gap insertion: Eq. 3 target positions
for all keys, and the §5.3 write path's per-key placement primitives
and single-dispatch fused ingest.

Counterpart of ``repro.kernels.ops_gap`` (``prepare_gap_tables``,
``gap_positions_device``, ``gap_positions_oracle``, ``ingest_place``,
``FUSED_ABORT_BITS``, ``fused_ingest``).  Each runs on its device
through the kernels of ``gap_place`` (the CUDA kernel on the card, its
plain version on the CPU; the placement graph for ``impl="xla"``) and
hands host numpy results back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .freeze import _pad_pow, _split_i64, split_key_pair
from .gap_place import (fused_ingest_body, gap_place,
                        ingest_place as _place, ingest_place_graph,
                        split_flags)

__all__ = ["prepare_gap_tables", "gap_positions_device",
           "gap_positions_oracle", "ingest_place", "fused_ingest",
           "FUSED_ABORT_BITS"]

def prepare_gap_tables(x: np.ndarray, y: np.ndarray, plm, rho: float,
                       seg_chunk: int = 512):
    """Fold Eq. 3 into per-segment (first_key, base, x0, scale) tables.

    Mirrors core.gaps.gap_positions' segment anchoring (first/last present
    key per segment), done once host-side in O(n).
    """
    seg = plm.segment_of(x)
    K = plm.n_segments
    n = x.shape[0]
    idx = np.arange(n, dtype=np.int64)
    first = np.full(K, n, np.int64)
    last = np.full(K, -1, np.int64)
    np.minimum.at(first, seg, idx)
    np.maximum.at(last, seg, idx)
    present = first < n
    f = np.minimum(first, n - 1)
    l = np.clip(last, 0, n - 1)
    y_first = np.where(present, y[f], 0.0)
    y_last = np.where(present, y[l], 0.0)
    x_first = np.where(present, x[f], 0.0)
    x_last = np.where(present, x[l], 1.0)
    U = np.where(present, rho * (y_last - y_first), 0.0)
    S = np.concatenate([[0.0], np.cumsum(U)[:-1]])
    dx = np.where(x_last > x_first, x_last - x_first, 1.0)
    scale = (y_last - y_first) * (1.0 + rho) / dx
    base = y_first + S

    pad = lambda a, fill: _pad_pow(np.asarray(a, np.float32), seg_chunk,
                                   np.float32(fill))
    return (pad(plm.seg_first_key, np.inf), pad(base, 0.0),
            pad(x_first, 0.0), pad(scale, 0.0))


def gap_positions_device(x: np.ndarray, plm, rho: float, *, device=None,
                         key_tile: int = 1024,
                         seg_chunk: int = 512) -> np.ndarray:
    """Device Eq. 3: monotone target positions (host f64) for all keys.

    Builds the tables with ``prepare_gap_tables``, pads the f32 keys
    with +inf to a multiple of ``key_tile``, launches ``gap_place`` on
    ``device`` (cuda by default) and takes the running max there, whose
    f32 values are those of ``np.maximum.accumulate`` on the same
    values (the boundary-tie guard of core.gaps.gap_positions).
    """
    dev = resolve_device(device)
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    y = np.arange(n, dtype=np.float64)
    tables = prepare_gap_tables(x, y, plm, rho, seg_chunk)
    xp = _pad_pow(x.astype(np.float32), key_tile, np.float32(np.inf))
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    out = gap_place(up(xp), *map(up, tables), key_tile=key_tile,
                    seg_chunk=seg_chunk)
    yg = torch.cummax(out[:n], dim=0).values
    return yg.cpu().numpy().astype(np.float64)


def gap_positions_oracle(x: np.ndarray, plm, rho: float) -> np.ndarray:
    """The host f64 oracle — delegates to the core implementation."""
    from ..core.gaps import gap_positions

    x = np.asarray(x, np.float64)
    return gap_positions(x, np.arange(x.shape[0], dtype=np.float64), plm,
                         rho)


# abort-reason bit names (the graph's ``reasons`` bitmask), for stats
FUSED_ABORT_BITS = (
    "escape", "dup_batch", "collision_group", "slot_dup", "contested",
    "d1_demote", "d4_demote", "chain_overflow", "link_overflow",
    "chain_dup",
)


def _prims(p, pv, ub, free, bracket, n_b: int) -> dict:
    """Writable host copies (the caller patches escape rows in place)."""
    host = lambda t: t[:n_b].cpu().numpy()  # noqa: E731
    return {"p": host(p).astype(np.int64),
            "free": np.array(host(free), dtype=bool),
            "pv": host(pv).astype(np.int64),
            "ub": host(ub).astype(np.int64),
            "bracket": np.array(host(bracket), dtype=bool)}


def _check_impl(impl: str) -> None:
    if impl not in ("kernel", "xla"):
        raise ValueError(f"unknown impl {impl!r}; expected 'kernel' or "
                         "'xla'")


def ingest_place(arrays, keys, *, impl: str = "kernel"):
    """Per-key placement primitives of an insert batch against the
    frozen arrays: ``(primitives, escape)``, where ``primitives`` is the
    numpy dict ``GappedArray.insert_batch`` consumes (``p`` / ``free`` /
    ``pv`` / ``ub`` / ``bracket``, the contract of the host oracle
    ``GappedArray.placement_primitives``) and ``escape`` flags the keys
    whose double-f32 prediction landed in the rounding-band guard (the
    caller re-derives those rows on the host).

    ``impl="kernel"`` launches the ingest-place kernel (its plain
    version for CPU tensors); ``"xla"`` runs ``ingest_place_graph`` over
    the unpadded batch on the arrays' device, as the reference's
    ``_ingest_place_xla`` does.

    Exactness needs every stored and batch key pair-exact (the ``Index``
    handle gates on it); narrow indexes pass zero-length lo tables.
    """
    _check_impl(impl)
    keys = np.asarray(keys, np.float64)
    x_hi, x_lo = split_key_pair(keys)
    a = arrays
    dev = a.device
    link_hi, link_lo = a.link_keys, a.link_keys_lo
    if int(link_hi.shape[0]) == 0:  # a non-empty chain table to read
        link_hi = torch.full((1,), float("inf"), device=dev)
        link_lo = torch.zeros(1 if a.key_wide else 0, device=dev)
    args = (torch.from_numpy(x_hi).to(dev), torch.from_numpy(x_lo).to(dev),
            a.seg_first_key, a.seg_first_key_lo, a.seg_slope,
            a.seg_slope_lo, a.seg_icept, a.seg_icept_lo, a.slot_key,
            a.slot_key_lo, a.link_offsets, link_hi, link_lo)
    if impl == "kernel":
        p, pv, ub, flags = _place(*args, n_slots=a.n_slots)
        free, bracket, escape = split_flags(flags)
    else:
        p, pv, ub, free, bracket, escape = ingest_place_graph(
            *args, n_slots=a.n_slots)
    n_b = keys.shape[0]
    return (_prims(p, pv, ub, free, bracket, n_b),
            np.array(escape.cpu().numpy(), dtype=bool))


def fused_ingest(arrays, keys, payloads, *, rank_table, rank_bounds_hi,
                 rank_bounds_lo, rank_scale, elo, ehi, max_chain,
                 impl: str = "kernel", min_bucket: int = 256):
    """Single-dispatch ingest: pads the batch to a power-of-two bucket
    (+inf keys, -1 payloads), runs ``fused_ingest_body`` (stage 1 on the
    ingest-place kernel for ``impl="kernel"``, on
    ``ingest_place_graph`` for ``"xla"``) and returns ``(prims, escape,
    ok, reasons, state)``:

    * ``prims`` / ``escape`` — the ``ingest_place`` contract, valid
      whether or not the graph committed;
    * ``ok`` — the graph produced the post-batch images; ``reasons`` is
      the abort bitmask (``FUSED_ABORT_BITS``);
    * ``state`` — the new device tensors (slot / payload / link images,
      rank table, window bounds), the slot and chain counts, and the
      host ``seg`` / ``dlt`` residuals for the caller's bound mirrors.
    """
    _check_impl(impl)
    keys = np.asarray(keys, np.float64)
    payloads = np.asarray(payloads, np.int64)
    n_b = keys.shape[0]
    bucket = max(min_bucket, 1 << max(n_b - 1, 1).bit_length())
    pad = bucket - n_b
    x_hi, x_lo = split_key_pair(keys)
    x_hi = np.concatenate([x_hi, np.full(pad, np.inf, np.float32)])
    x_lo = np.concatenate([x_lo, np.zeros(pad, np.float32)])
    p_lo, p_hi = _split_i64(payloads)
    p_lo = np.concatenate([p_lo, np.full(pad, -1, np.int32)])
    p_hi = np.concatenate([p_hi, np.full(pad, -1, np.int32)])

    a = arrays
    dev = a.device
    zeros = torch.zeros_like
    segk_lo = a.seg_first_key_lo if a.key_wide else zeros(a.seg_first_key)
    slot_lo = a.slot_key_lo if a.key_wide else zeros(a.slot_key)
    link_lo = a.link_keys_lo if a.key_wide else zeros(a.link_keys)
    spay_hi = a.payload_hi if a.wide else zeros(a.payload)
    lpay_hi = a.link_payload_hi if a.wide else zeros(a.link_payloads)
    up = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731

    outs = fused_ingest_body(
        up(x_hi), up(x_lo), up(p_lo), up(p_hi), a.seg_first_key, segk_lo,
        a.seg_slope, a.seg_slope_lo, a.seg_icept, a.seg_icept_lo,
        a.slot_key, slot_lo, a.payload, spay_hi, a.link_offsets,
        a.link_keys, link_lo, a.link_payloads, lpay_hi, rank_table,
        rank_bounds_hi, rank_bounds_lo, rank_scale, elo, ehi,
        n_slots=a.n_slots, max_chain=int(max_chain), key_wide=a.key_wide,
        use_kernel=impl == "kernel")
    (p, pv, ub, free, bracket, escape, ok, reasons, n_slot, n_chain,
     seg, dlt) = outs[:12]
    (slot_key, slot_key_lo, payload, payload_hi, link_offsets, link_keys,
     link_keys_lo, link_payloads, link_payload_hi, new_rank, new_elo,
     new_ehi) = outs[12:]
    state = {
        "slot_key": slot_key, "slot_key_lo": slot_key_lo,
        "payload": payload, "payload_hi": payload_hi,
        "link_offsets": link_offsets, "link_keys": link_keys,
        "link_keys_lo": link_keys_lo, "link_payloads": link_payloads,
        "link_payload_hi": link_payload_hi, "rank_table": new_rank,
        "elo": new_elo, "ehi": new_ehi,
        "n_slot": n_slot, "n_chain": n_chain,
        "seg": seg[:n_b].cpu().numpy(), "dlt": dlt[:n_b].cpu().numpy(),
    }
    return (_prims(p, pv, ub, free, bracket, n_b),
            np.array(escape[:n_b].cpu().numpy(), dtype=bool),
            bool(ok), int(reasons), state)
