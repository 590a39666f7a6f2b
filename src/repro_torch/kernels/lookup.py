"""Fused learned-index lookup: the CUDA kernel's wrapper and its plain
torch version.

Counterpart of ``repro.kernels.lookup.fused_lookup_call`` (the TPU
kernel ``_fused_kernel``).  One launch per batch takes ``q_tile`` sorted
queries per tile against the two adjacent ``w_tile`` slot-key blocks
that ``tile_block[i]`` names, and returns ``(slot, resolved_i32,
out_lo, out_hi, fb_bool, fb_loc, fb_cnt)`` — ``out_hi`` zero-length
unless ``wide``; ``fb_loc`` / ``fb_cnt`` are the per-tile compacted
escape lists (local indices in ascending order, padded with
``q_tile``).

``fused_lookup`` launches ``csrc/fused_lookup.cu`` for CUDA tensors and
raises on anything the kernel does not take; for CPU tensors it runs
``fused_lookup_plain``, which computes the same function with torch
ops.  ``fused_lookup.launches`` counts kernel launches.

``fused_lookup_u64`` / ``fused_lookup_u64_plain`` are the same pair for
the 64-bit image (``freeze.IndexArrays.key_u64``): the same function
over ordered int64 keys (``core.keys64``), compared exactly, with the
window base taken from ``keys64.exact_dx`` and float64 segment lines
(``window_base_u64``); ``keys64.NO_KEY`` pads the queries.  Its kernel,
``fused_lookup64_kernel`` in the same source, has a name of its own in
a trace.

``lookup_kernel`` / ``lookup_kernel_plain`` are the same pair for the
legacy narrow-key kernel ``csrc/lookup_kernel.cu``, the counterpart of
``repro.kernels.lookup.lookup_kernel_call`` (the TPU kernel
``_lookup_kernel``) that the explicitly requested ``"pallas"`` backend
searches with: slot, found, escape flag and prediction per query of
each tile, in the tile's two ``w_tile`` slot-key blocks.
``lookup_kernel_brackets`` computes, from the same inputs, the rank and
segment brackets the kernel searches each tile in and the slice of the
window it stages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.keys64 import NO_KEY
from . import _build
from .ref import _bisect, _ple

__all__ = ["fused_launch_shape", "fused_lookup", "fused_lookup_plain",
           "fused_lookup_u64", "fused_lookup_u64_plain", "lookup_kernel",
           "lookup_kernel_brackets", "lookup_kernel_plain", "window_base",
           "window_base_u64"]

_ARG_NAMES = ("queries_sorted", "queries_lo", "tile_block", "radix_table",
              "radix_scale", "seg_first_key", "seg_first_key_lo",
              "seg_slope", "icept_lo_fold", "slot_key_padded",
              "slot_key_lo", "payload", "payload_hi", "link_offsets",
              "link_keys", "link_keys_lo", "link_payloads",
              "link_payload_hi")
_ARG_DTYPES = (torch.float32, torch.float32, torch.int32, torch.int32,
               torch.float32, torch.float32, torch.float32, torch.float32,
               torch.float32, torch.float32, torch.float32, torch.int32,
               torch.int32, torch.int32, torch.float32, torch.float32,
               torch.int32, torch.int32)
_WHOLE_WINDOW_ELEMS = 1 << 24  # (rows x 2*w_tile) compare chunk, plain
_SMEM_MAX = 232_448   # dynamic shared memory a block can opt into (H100)
_FUSED_STATIC_SMEM = 128      # fused_lookup_kernel's warp counts
_WIN_BUDGET = 64 * 1024       # whole-window staging per fused CTA
_SM_COUNTS: dict = {}
LEGACY_SLICE_CAP = 2048  # window keys csrc/lookup_kernel.cu stages
LEGACY_RANK_SLACK = 128  # the width its window brackets stop at


def _slot_clip_hi(n_slots: int) -> float:
    """The window-base clip bound as the f32 value the reference uses
    (``float(n_slots - 1)`` meets an f32 operand and rounds to f32)."""
    return float(np.float32(n_slots - 1))


def _clip(v: torch.Tensor, hi: float) -> torch.Tensor:
    """clip to [0, hi] with NaN -> 0 (fminf(fmaxf(v, 0), hi) in CUDA)."""
    return torch.nan_to_num(torch.clamp(v, 0.0, hi), nan=0.0)


def route_segment(q, ql, radix_table, radix_scale, key_wide: bool):
    """Approximate radix segment routing: one multiply + one gather.
    Mis-routes near bucket boundaries only shift the window; the
    kernel's escape flags catch them."""
    x = q - radix_scale[0]
    if key_wide:
        x = x + (ql - radix_scale[1])
    bkt = _clip(x * radix_scale[2], float(radix_table.shape[0] - 1)).long()
    return radix_table[bkt].long()


def window_base(q, ql, radix_table, radix_scale, seg_first_key,
                seg_first_key_lo, seg_slope, icept_lo_fold, *, n_slots: int,
                key_wide: bool) -> torch.Tensor:
    """Flat-mode window base per query (int64): radix route, then
    ``lo0 = clip(floor(slope * dx + icept_fold))`` — the kernel's
    arithmetic, one separate torch op per step (no FMA)."""
    seg = route_segment(q, ql, radix_table, radix_scale, key_wide)
    dx = q - seg_first_key[seg]
    if key_wide:
        dx = dx + (ql - seg_first_key_lo[seg])
    return _clip(torch.floor(seg_slope[seg] * dx + icept_lo_fold[seg]),
                 _slot_clip_hi(n_slots)).long()


def _check(args, *, q_tile, w_tile, flat_w, key_wide, wide):
    dev = _build.check_1d(args, _ARG_NAMES, _ARG_DTYPES, "queries")
    (q, ql, tile_block, radix_table, radix_scale, segk, segkl, slope, iclo,
     sk, skl, pay, payhi, off, lk, lkl, lp, lph) = args
    n_q, m_pad = q.shape[0], sk.shape[0]
    if q_tile < 32 or q_tile > 1024 or q_tile % 32:
        raise ValueError(f"q_tile {q_tile} must be a multiple of 32 in "
                         "[32, 1024]")
    if n_q % q_tile:
        raise ValueError("pad queries to a multiple of q_tile")
    if m_pad % w_tile or m_pad < 2 * w_tile:
        raise ValueError("slot keys must be padded to >= 2 w_tile blocks")
    if tile_block.shape[0] != n_q // q_tile:
        raise ValueError("tile_block needs one entry per tile")
    if pay.shape[0] != m_pad or off.shape[0] < m_pad + w_tile:
        raise ValueError("payload / link_offsets do not match slot_key")
    if key_wide and (ql.shape[0] != n_q or skl.shape[0] != m_pad
                     or lkl.shape[0] != lk.shape[0]):
        raise ValueError("key_wide needs the lo half of every key array")
    if wide and (payhi.shape[0] != m_pad or lph.shape[0] != lp.shape[0]):
        raise ValueError("wide needs the hi half of every payload array")
    if lp.shape[0] != lk.shape[0]:
        raise ValueError("link_payloads must match link_keys")
    if flat_w:
        if radix_scale.shape[0] != 3 or radix_table.shape[0] < 1:
            raise ValueError("flat mode needs the radix table and scale")
        if slope.shape[0] != segk.shape[0] or iclo.shape[0] != segk.shape[0]:
            raise ValueError("segment tables differ in length")
        if key_wide and segkl.shape[0] != segk.shape[0]:
            raise ValueError("key_wide needs seg_first_key_lo")
    return dev


def fused_lookup(
    queries_sorted,    # (Qpad,) f32 hi, sorted ascending, +inf padded
    queries_lo,        # (Qpad,) f32 lo when key_wide else (0,)
    tile_block,        # (Qpad // q_tile,) i32 window block per tile
    radix_table,       # (R,) i32 bucket -> segment (flat mode)
    radix_scale,       # (3,) f32 [kmin_hi, kmin_lo, scale]
    seg_first_key,     # (Kpad,) f32, +inf padded
    seg_first_key_lo,  # (Kpad,) f32 when key_wide else (0,)
    seg_slope,         # (Kpad,) f32
    icept_lo_fold,     # (Kpad,) f32 — icept + err_lo - 1 pre-folded
    slot_key_padded,   # (Mpad,) f32, Mpad % w_tile == 0
    slot_key_lo,       # (Mpad,) f32 when key_wide else (0,)
    payload,           # (Mpad,) i32
    payload_hi,        # (Mpad,) i32 when wide else (0,)
    link_offsets,      # (Mpad + w_tile,) i32
    link_keys,         # (Lpad,) f32
    link_keys_lo,      # (Lpad,) f32 when key_wide else (0,)
    link_payloads,     # (Lpad,) i32
    link_payload_hi,   # (Lpad,) i32 when wide else (0,)
    *,
    q_tile: int,
    w_tile: int,
    win_chunk: int = 512,
    flat_w: int,
    max_chain: int,
    n_slots: int,
    key_wide: bool,
    wide: bool,
):
    """One launch of the fused lookup kernel (``win_chunk`` is accepted
    for the reference's signature and ignored).  CPU tensors run
    ``fused_lookup_plain``; CUDA tensors launch the kernel or raise."""
    del win_chunk
    args = (queries_sorted, queries_lo, tile_block, radix_table,
            radix_scale, seg_first_key, seg_first_key_lo, seg_slope,
            icept_lo_fold, slot_key_padded, slot_key_lo, payload,
            payload_hi, link_offsets, link_keys, link_keys_lo,
            link_payloads, link_payload_hi)
    statics = dict(q_tile=q_tile, w_tile=w_tile, flat_w=flat_w,
                   max_chain=max_chain, n_slots=n_slots,
                   key_wide=key_wide, wide=wide)
    dev = _check(args, q_tile=q_tile, w_tile=w_tile, flat_w=flat_w,
                 key_wide=key_wide, wide=wide)
    if dev.type == "cpu":
        return fused_lookup_plain(*args, **statics)
    if dev.type != "cuda":
        raise ValueError(f"fused_lookup runs on cuda or cpu, not {dev}")
    return _launch(args, dev, **statics)


fused_lookup.launches = 0


def fused_launch_shape(num_tiles: int, q_tile: int, w_tile: int,
                       flat_w: int, key_wide: bool,
                       n_sm: int = 132) -> tuple:
    """``(tiles_per_cta, smem_bytes)`` of one ``fused_lookup`` launch.

    A CTA runs up to ``256 // q_tile`` tiles (one warp each at q_tile
    32), but no more than spreads the batch's tiles four CTAs deep over
    the card's ``n_sm`` SMs, so a small batch keeps one tile per CTA.
    Whole-window mode (``flat_w == 0``) stages each tile's 2·w_tile
    window keys in dynamic shared memory: at most ``_WIN_BUDGET`` bytes
    of windows per CTA (one window whatever its size), none when one
    window does not fit beside the kernel's static shared memory (the
    kernel then bisects the window in place).  Flat mode stages
    nothing."""
    tiles = max(1, min(256 // q_tile, num_tiles // (4 * n_sm)))
    if flat_w:
        return tiles, 0
    win = 2 * w_tile * (8 if key_wide else 4)
    if win > _SMEM_MAX - _FUSED_STATIC_SMEM:
        return tiles, 0
    tiles = max(1, min(tiles, _WIN_BUDGET // win))
    return tiles, tiles * win


def _sm_count(dev) -> int:
    n = _SM_COUNTS.get(dev.index)
    if n is None:
        n = torch.cuda.get_device_properties(dev).multi_processor_count
        _SM_COUNTS[dev.index] = n
    return n


def _launch(args, dev, *, q_tile, w_tile, flat_w, max_chain, n_slots,
            key_wide, wide):
    """One launch: the outputs are views of one int32 buffer (``fb``
    its tail's bytes; ``n_q`` is a multiple of 32)."""
    fn = _build.entry("fused_lookup", "p" * 20 + "i" * 9 + "f" + "ii")
    n_q = args[0].shape[0]
    num_tiles = n_q // q_tile
    link_keys = args[14]
    has_links = link_keys.shape[0] > 0 and max_chain > 0
    n_hi = n_q if wide else 0
    buf = torch.empty(4 * n_q + num_tiles + n_hi + n_q // 4,
                      dtype=torch.int32, device=dev)
    slot, res, out, fb_loc, fb_cnt, out_hi, fb_words = buf.split(
        [n_q, n_q, n_q, n_q, num_tiles, n_hi, n_q // 4])
    fb = fb_words.view(torch.bool)
    tiles, smem = fused_launch_shape(num_tiles, q_tile, w_tile, flat_w,
                                     key_wide, _sm_count(dev))
    err = _build.launch(
        fn, dev, *[t.data_ptr() for t in args], buf.data_ptr(),
        fb.data_ptr(), num_tiles, q_tile, tiles, smem, args[3].shape[0],
        link_keys.shape[0], w_tile, flat_w,
        int(max_chain).bit_length() if has_links else 0,
        _slot_clip_hi(n_slots), int(key_wide), int(wide))
    if err != 0:
        raise RuntimeError(f"fused_lookup kernel launch failed: CUDA error "
                           f"{err}")
    fused_lookup.launches += 1
    return slot, res, out, out_hi, fb, fb_loc, fb_cnt


def fused_lookup_plain(
    queries_sorted, queries_lo, tile_block, radix_table, radix_scale,
    seg_first_key, seg_first_key_lo, seg_slope, icept_lo_fold,
    slot_key_padded, slot_key_lo, payload, payload_hi, link_offsets,
    link_keys, link_keys_lo, link_payloads, link_payload_hi,
    *, q_tile: int, w_tile: int, win_chunk: int = 512, flat_w: int,
    max_chain: int, n_slots: int, key_wide: bool, wide: bool,
):
    """The kernel's function in plain torch ops on any device: the
    same arithmetic in the same order, one query per row."""
    del win_chunk
    lo0 = (window_base(queries_sorted, queries_lo, radix_table, radix_scale,
                       seg_first_key, seg_first_key_lo, seg_slope,
                       icept_lo_fold, n_slots=n_slots, key_wide=key_wide)
           if flat_w else None)
    return _search_plain(
        queries_sorted, queries_lo, lo0, torch.isfinite(queries_sorted),
        tile_block, slot_key_padded, slot_key_lo, payload, payload_hi,
        link_offsets, link_keys, link_keys_lo, link_payloads,
        link_payload_hi, q_tile=q_tile, w_tile=w_tile, flat_w=flat_w,
        max_chain=max_chain, key_wide=key_wide, wide=wide)


def _search_plain(q, ql, lo0, finite, tile_block, sk, skl, payload,
                  payload_hi, link_offsets, link_keys, link_keys_lo,
                  link_payloads, link_payload_hi, *, q_tile, w_tile, flat_w,
                  max_chain, key_wide, wide):
    """Both kernels' search, epilogue and compaction from the window
    base ``lo0`` (flat mode) and the mask of real queries ``finite``:
    compares are the keys' own (f32, an f32 pair, or ordered int64)."""
    dev = q.device
    n_q = q.shape[0]
    num_tiles = n_q // q_tile
    two_w = 2 * w_tile
    base = (tile_block.long() * w_tile).repeat_interleave(q_tile)

    def wgather(arr, loc):
        """Gather at window-local ``loc`` (pre-clipped to [0, 2w))."""
        return arr[base.view(-1, *([1] * (loc.dim() - 1))) + loc]

    if flat_w:
        loc0 = lo0 - base
        idxl = loc0[:, None] + torch.arange(flat_w + 1, device=dev)
        inb = (idxl >= 0) & (idxl < two_w)
        idxc = idxl.clamp(0, two_w - 1)
        ks = wgather(sk, idxc)
        if key_wide:
            le = _ple(ks, wgather(skl, idxc), q[:, None], ql[:, None]) & inb
        else:
            le = (ks <= q[:, None]) & inb
        rank = le.sum(dim=1)
        slot = lo0 - 1 + torch.clamp(rank, max=flat_w)
        window_ok = (loc0 >= 0) & (loc0 + flat_w + 1 <= two_w)
        fb = ((rank == 0) & (lo0 > 0)) | (rank == flat_w + 1) | ~window_ok
    else:
        rank = torch.empty(n_q, dtype=torch.long, device=dev)
        rows = max(1, _WHOLE_WINDOW_ELEMS // two_w)
        offs = torch.arange(two_w, device=dev)
        for r0 in range(0, n_q, rows):
            b = base[r0:r0 + rows, None] + offs
            qc = q[r0:r0 + rows, None]
            if key_wide:
                le = _ple(sk[b], skl[b], qc, ql[r0:r0 + rows, None])
            else:
                le = sk[b] <= qc
            rank[r0:r0 + rows] = le.sum(dim=1)
        slot = base + rank - 1
        fb = ((rank == 0) & (base > 0)) | (rank == two_w)
    fb = fb & finite

    # ---- epilogue: found + payload + CSR chain bisect -----------------
    sloc = slot - base
    okx = (slot >= 0) & (sloc >= 0) & (sloc < two_w)
    slc = sloc.clamp(0, two_w - 1)
    found = okx & (wgather(sk, slc) == q)
    if key_wide:
        found = found & (wgather(skl, slc) == ql)
    neg = torch.full((n_q,), -1, dtype=torch.int32, device=dev)
    out = torch.where(found, wgather(payload, slc), neg)
    out_hi = (torch.where(found, wgather(payload_hi, slc), neg) if wide
              else torch.zeros(0, dtype=torch.int32, device=dev))
    resolved = found
    if link_keys.shape[0] > 0 and max_chain > 0:
        start = wgather(link_offsets, slc).long()
        end = wgather(link_offsets, slc + 1).long()
        scan = okx & ~found & (end > start)
        l_max = link_keys.shape[0] - 1

        def go_at(mid):
            midc = mid.clamp(0, l_max)
            if key_wide:
                return _ple(link_keys[midc], link_keys_lo[midc], q, ql)
            return link_keys[midc] <= q

        lo_c = _bisect(start - 1, end - 1, int(max_chain).bit_length(),
                       go_at)
        locc = lo_c.clamp(0, l_max)
        eq = link_keys[locc] == q
        if key_wide:
            eq = eq & (link_keys_lo[locc] == ql)
        hit = scan & (lo_c >= start) & eq
        out = torch.where(hit, link_payloads[locc], out)
        if wide:
            out_hi = torch.where(hit, link_payload_hi[locc], out_hi)
        resolved = resolved | hit

    # ---- per-tile compaction: fb_loc[d] = local index of the d-th
    # flagged query of the tile, q_tile past the tile's count ----------
    fbm = fb.view(num_tiles, q_tile)
    pos = torch.cumsum(fbm.int(), dim=1) - 1
    fb_cnt = fbm.sum(dim=1).int()
    fb_loc = torch.full((num_tiles, q_tile), q_tile, dtype=torch.int32,
                        device=dev)
    t_idx, j_idx = torch.nonzero(fbm, as_tuple=True)
    fb_loc[t_idx, pos[t_idx, j_idx]] = j_idx.int()
    return (slot.int(), resolved.int(), out, out_hi, fb, fb_loc.view(-1),
            fb_cnt)


# ---------------------------------------------------------------------------
# the 64-bit image (ordered int64 keys)
# ---------------------------------------------------------------------------

_U64_ARG_NAMES = ("queries_sorted", "tile_block", "radix_table",
                  "radix_key", "radix_scale", "seg_first_key", "seg_slope",
                  "icept_lo_fold", "slot_key_padded", "payload",
                  "payload_hi", "link_offsets", "link_keys",
                  "link_payloads", "link_payload_hi")
_U64_ARG_DTYPES = (torch.int64, torch.int32, torch.int32, torch.int64,
                   torch.float64, torch.int64, torch.float64, torch.float64,
                   torch.int64, torch.int32, torch.int32, torch.int32,
                   torch.int64, torch.int32, torch.int32)


def exact_dx(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``core.keys64.exact_dx`` in torch ops: ``float64(a - b)`` of
    ordered int64 keys, rounded once."""
    hi = ((a >> 32) - (b >> 32)).double() * 4294967296.0
    return hi + ((a & 0xFFFFFFFF) - (b & 0xFFFFFFFF)).double()


def window_line_u64(q, radix_table, radix_key, radix_scale, seg_first_key,
                    seg_slope, icept_lo_fold):
    """The 64-bit image's window line per query (float64): the radix
    bucket ``clip(exact_dx(q, kmin) * scale)``, truncated, then ``slope
    * exact_dx(q, seg_first_key) + icept_fold`` of its segment, one
    separate op a step (the kernel's arithmetic)."""
    bkt = _clip(exact_dx(q, radix_key[0]) * radix_scale[0],
                float(radix_table.shape[0] - 1)).long()
    seg = radix_table[bkt].long()
    return (seg_slope[seg] * exact_dx(q, seg_first_key[seg])
            + icept_lo_fold[seg])


def window_base_u64(q, radix_table, radix_key, radix_scale, seg_first_key,
                    seg_slope, icept_lo_fold, *, n_slots: int):
    """``window_base`` of the 64-bit image (int64): ``lo0 =
    clip(floor(window_line_u64(...)))``."""
    v = window_line_u64(q, radix_table, radix_key, radix_scale,
                        seg_first_key, seg_slope, icept_lo_fold)
    return _clip(torch.floor(v), float(n_slots - 1)).long()


def _check_u64(args, *, q_tile, w_tile, flat_w, wide):
    dev = _build.check_1d(args, _U64_ARG_NAMES, _U64_ARG_DTYPES, "queries")
    (q, tile_block, radix_table, radix_key, radix_scale, segk, slope, iclo,
     sk, pay, payhi, off, lk, lp, lph) = args
    n_q, m_pad = q.shape[0], sk.shape[0]
    if q_tile < 32 or q_tile > 1024 or q_tile % 32:
        raise ValueError(f"q_tile {q_tile} must be a multiple of 32 in "
                         "[32, 1024]")
    if n_q % q_tile:
        raise ValueError("pad queries to a multiple of q_tile")
    if m_pad % w_tile or m_pad < 2 * w_tile:
        raise ValueError("slot keys must be padded to >= 2 w_tile blocks")
    if tile_block.shape[0] != n_q // q_tile:
        raise ValueError("tile_block needs one entry per tile")
    if pay.shape[0] != m_pad or off.shape[0] < m_pad + w_tile:
        raise ValueError("payload / link_offsets do not match slot_key")
    if wide and (payhi.shape[0] != m_pad or lph.shape[0] != lp.shape[0]):
        raise ValueError("wide needs the hi half of every payload array")
    if lp.shape[0] != lk.shape[0]:
        raise ValueError("link_payloads must match link_keys")
    if flat_w:
        if (radix_key.shape[0] != 1 or radix_scale.shape[0] != 1
                or radix_table.shape[0] < 1):
            raise ValueError("flat mode needs the radix table, key and "
                             "scale")
        if slope.shape[0] != segk.shape[0] or iclo.shape[0] != segk.shape[0]:
            raise ValueError("segment tables differ in length")
    return dev


def fused_lookup_u64(
    queries_sorted,    # (Qpad,) ordered int64, sorted, NO_KEY padded
    tile_block,        # (Qpad // q_tile,) i32 window block per tile
    radix_table,       # (R,) i32 bucket -> segment (flat mode)
    radix_key,         # (1,) int64 kmin, the radix origin
    radix_scale,       # (1,) f64 buckets per key unit
    seg_first_key,     # (Kpad,) ordered int64, NO_KEY padded
    seg_slope,         # (Kpad,) f64
    icept_lo_fold,     # (Kpad,) f64 — icept + err_lo - 1 pre-folded
    slot_key_padded,   # (Mpad,) ordered int64, Mpad % w_tile == 0
    payload,           # (Mpad,) i32
    payload_hi,        # (Mpad,) i32 when wide else (0,)
    link_offsets,      # (Mpad + w_tile,) i32
    link_keys,         # (Lpad,) ordered int64
    link_payloads,     # (Lpad,) i32
    link_payload_hi,   # (Lpad,) i32 when wide else (0,)
    *,
    q_tile: int,
    w_tile: int,
    flat_w: int,
    max_chain: int,
    n_slots: int,
    wide: bool,
):
    """One launch of the fused lookup kernel over the 64-bit image:
    ``fused_lookup``'s outputs.  CPU tensors run
    ``fused_lookup_u64_plain``; CUDA tensors launch the kernel or
    raise."""
    args = (queries_sorted, tile_block, radix_table, radix_key,
            radix_scale, seg_first_key, seg_slope, icept_lo_fold,
            slot_key_padded, payload, payload_hi, link_offsets, link_keys,
            link_payloads, link_payload_hi)
    statics = dict(q_tile=q_tile, w_tile=w_tile, flat_w=flat_w,
                   max_chain=max_chain, n_slots=n_slots, wide=wide)
    dev = _check_u64(args, q_tile=q_tile, w_tile=w_tile, flat_w=flat_w,
                     wide=wide)
    if dev.type == "cpu":
        return fused_lookup_u64_plain(*args, **statics)
    if dev.type != "cuda":
        raise ValueError(f"fused_lookup_u64 runs on cuda or cpu, not {dev}")
    return _launch_u64(args, dev, **statics)


fused_lookup_u64.launches = 0


def _launch_u64(args, dev, *, q_tile, w_tile, flat_w, max_chain, n_slots,
                wide):
    """One launch of ``fused_lookup64_kernel`` (outputs as in
    ``_launch``).  The window is read in place: no shared memory."""
    fn = _build.entry("fused_lookup", "p" * 17 + "i" * 8 + "ii",
                      symbol="fused_lookup64_launch")
    n_q = args[0].shape[0]
    num_tiles = n_q // q_tile
    link_keys = args[12]
    has_links = link_keys.shape[0] > 0 and max_chain > 0
    n_hi = n_q if wide else 0
    buf = torch.empty(4 * n_q + num_tiles + n_hi + n_q // 4,
                      dtype=torch.int32, device=dev)
    slot, res, out, fb_loc, fb_cnt, out_hi, fb_words = buf.split(
        [n_q, n_q, n_q, n_q, num_tiles, n_hi, n_q // 4])
    fb = fb_words.view(torch.bool)
    tiles, _ = fused_launch_shape(num_tiles, q_tile, w_tile, flat_w, True,
                                  _sm_count(dev))
    err = _build.launch(
        fn, dev, *[t.data_ptr() for t in args], buf.data_ptr(),
        fb.data_ptr(), num_tiles, q_tile, tiles, args[2].shape[0],
        link_keys.shape[0], w_tile, flat_w,
        int(max_chain).bit_length() if has_links else 0, n_slots - 1,
        int(wide))
    if err != 0:
        raise RuntimeError(f"fused_lookup_u64 kernel launch failed: CUDA "
                           f"error {err}")
    fused_lookup_u64.launches += 1
    return slot, res, out, out_hi, fb, fb_loc, fb_cnt


def fused_lookup_u64_plain(
    queries_sorted, tile_block, radix_table, radix_key, radix_scale,
    seg_first_key, seg_slope, icept_lo_fold, slot_key_padded, payload,
    payload_hi, link_offsets, link_keys, link_payloads, link_payload_hi,
    *, q_tile: int, w_tile: int, flat_w: int, max_chain: int,
    n_slots: int, wide: bool,
):
    """The 64-bit kernel's function in plain torch ops on any device."""
    q = queries_sorted
    lo0 = (window_base_u64(q, radix_table, radix_key, radix_scale,
                           seg_first_key, seg_slope, icept_lo_fold,
                           n_slots=n_slots) if flat_w else None)
    empty = q.new_zeros(0)
    return _search_plain(
        q, empty, lo0, q != NO_KEY, tile_block, slot_key_padded, empty,
        payload, payload_hi, link_offsets, link_keys, empty, link_payloads,
        link_payload_hi, q_tile=q_tile, w_tile=w_tile, flat_w=flat_w,
        max_chain=max_chain, key_wide=False, wide=wide)


# ---------------------------------------------------------------------------
# the legacy narrow-key lookup kernel (the "pallas" backend's search)
# ---------------------------------------------------------------------------

_LEGACY_ARG_NAMES = ("queries_sorted", "tile_block", "seg_first_key",
                     "seg_slope", "seg_icept", "slot_key_padded")
_LEGACY_DTYPES = tuple(torch.int32 if n == "tile_block" else torch.float32
                       for n in _LEGACY_ARG_NAMES)


def _check_legacy(args, *, q_tile, w_tile):
    dev = _build.check_1d(args, _LEGACY_ARG_NAMES, _LEGACY_DTYPES,
                          "queries")
    q, tile_block, segk, slope, icept, sk = args
    n_q, k_pad, m_pad = q.shape[0], segk.shape[0], sk.shape[0]
    if q_tile <= 0 or n_q % q_tile:
        raise ValueError("pad queries to a multiple of q_tile")
    if tile_block.shape[0] != n_q // q_tile:
        raise ValueError("tile_block needs one entry per tile")
    if w_tile <= 0 or m_pad % w_tile or m_pad < 2 * w_tile:
        raise ValueError("slot keys must be padded to >= 2 w_tile blocks")
    if k_pad == 0:
        raise ValueError("the segment tables must be non-empty")
    if slope.shape[0] != k_pad or icept.shape[0] != k_pad:
        raise ValueError("segment tables differ in length")
    return dev


def lookup_kernel(queries_sorted, tile_block, seg_first_key, seg_slope,
                  seg_icept, slot_key_padded, *, q_tile: int = 256,
                  w_tile: int = 2048, seg_chunk: int = 512,
                  win_chunk: int = 512):
    """One launch of the legacy narrow-key lookup kernel: ``(slot i32,
    found bool, fb bool, pred f32)`` per sorted, +inf padded query,
    each tile searched in the two ``w_tile`` slot-key blocks from
    ``tile_block[i]`` (clamped to ``[0, Mpad / w_tile - 2]``).
    ``seg_chunk`` / ``win_chunk`` are the reference's VMEM chunking,
    accepted for its signature.  CPU tensors run
    ``lookup_kernel_plain``; CUDA tensors launch the kernel or raise.
    ``lookup_kernel.launches`` counts kernel launches."""
    del seg_chunk, win_chunk
    args = (queries_sorted, tile_block, seg_first_key, seg_slope,
            seg_icept, slot_key_padded)
    dev = _check_legacy(args, q_tile=q_tile, w_tile=w_tile)
    if dev.type == "cpu":
        return lookup_kernel_plain(*args, q_tile=q_tile, w_tile=w_tile)
    if dev.type != "cuda":
        raise ValueError(f"lookup_kernel runs on cuda or cpu, not {dev}")
    fn = _build.entry("lookup_kernel", "p" * 10 + "i" * 5)
    n_q = queries_sorted.shape[0]
    # four allocations: on the card's stack one buffer split into typed
    # views costs more host time than four torch.empty calls
    outs = (torch.empty(n_q, dtype=torch.int32, device=dev),
            torch.empty(n_q, dtype=torch.bool, device=dev),
            torch.empty(n_q, dtype=torch.bool, device=dev),
            torch.empty(n_q, dtype=torch.float32, device=dev))
    err = _build.launch(fn, dev, *[t.data_ptr() for t in args + outs],
                        n_q // q_tile, q_tile, w_tile,
                        seg_first_key.shape[0], slot_key_padded.shape[0])
    if err != 0:
        raise RuntimeError(f"lookup_kernel launch failed: CUDA error {err}")
    lookup_kernel.launches += 1
    return outs


lookup_kernel.launches = 0


def _narrow(count, n: int, slack: int):
    """The range ``csrc/lookup_kernel.cu``'s ``warp_bracket`` returns for
    ``count`` (the number of keys <= v among ``n`` non-decreasing keys):
    32-ary rounds from ``[0, n]`` until the range is at most ``slack``
    wide.  A round's ballot counts the strides that end at or below the
    count, ``(count - lo) // stride``."""
    lo = torch.zeros_like(count)
    hi = torch.full_like(count, n)
    while True:
        wide = hi - lo > slack
        if not bool(wide.any()):
            return lo, hi
        s = (hi - lo + 31) >> 5
        c = (count - lo) // s.clamp(min=1)
        lo, hi = (torch.where(wide, lo + c * s, lo),
                  torch.where(wide, torch.minimum(hi, lo + (c + 1) * s - 1),
                              hi))


def lookup_kernel_brackets(queries_sorted, tile_block, seg_first_key,
                           slot_key_padded, *, q_tile: int, w_tile: int,
                           slack: int = LEGACY_RANK_SLACK):
    """The brackets ``csrc/lookup_kernel.cu`` searches in, per tile,
    computed from its inputs with torch ops on any device: ``(start,
    rank_lo, rank_hi, seg_lo, seg_hi)``.  Every query's window rank
    lies in ``[rank_lo, rank_hi]``: the low end of the range the
    kernel's search narrows for the tile's least query (NaN skipped) and
    the high end of the one for its greatest, each at most ``slack``
    wide (0: the exact ranks).  ``start = max(rank_lo - 1, 0)``;
    ``seg_lo`` / ``seg_hi`` are the counts of segment first keys <=
    those two queries.  The kernel stages the slice ``[start,
    rank_hi)`` (rounded out to 16-byte bounds when aligned) if it holds
    at most ``LEGACY_SLICE_CAP`` keys, and routes a query's segment only
    between the two counts.  Valid for non-decreasing slot keys."""
    m_pad = slot_key_padded.shape[0]
    q = queries_sorted.view(-1, q_tile)
    inf = float("inf")
    q_min = torch.where(q.isnan(), inf, q).amin(dim=1)
    q_max = torch.where(q.isnan(), -inf, q).amax(dim=1)
    base = tile_block.long().clamp(0, m_pad // w_tile - 2) * w_tile

    def rank(v):
        c = torch.searchsorted(slot_key_padded, v, right=True)
        return _narrow((c - base).clamp(0, 2 * w_tile), 2 * w_tile, slack)

    r_lo, r_hi = rank(q_min)[0], rank(q_max)[1]
    return ((r_lo - 1).clamp(min=0), r_lo, r_hi,
            torch.searchsorted(seg_first_key, q_min, right=True),
            torch.searchsorted(seg_first_key, q_max, right=True))


def lookup_kernel_plain(queries_sorted, tile_block, seg_first_key,
                        seg_slope, seg_icept, slot_key_padded, *,
                        q_tile: int = 256, w_tile: int = 2048,
                        seg_chunk: int = 512, win_chunk: int = 512):
    """The kernel's function in plain torch ops on any device, with the
    reference kernel's counts taken literally (masked sums of
    ``key <= q`` and ``key == q``, in chunks of rows), where the kernel
    bisects.  ``seg_chunk`` / ``win_chunk`` are the reference's
    tiling, accepted for its signature."""
    del seg_chunk, win_chunk
    q, segk, sk = queries_sorted, seg_first_key, slot_key_padded
    dev = q.device
    n_q, k_pad, m_pad = q.shape[0], segk.shape[0], sk.shape[0]
    num_tiles = n_q // q_tile
    two_w = 2 * w_tile

    seg_cnt = torch.empty(n_q, dtype=torch.long, device=dev)
    rows = max(1, _WHOLE_WINDOW_ELEMS // k_pad)
    for r0 in range(0, n_q, rows):
        seg_cnt[r0:r0 + rows] = (segk[None, :]
                                 <= q[r0:r0 + rows, None]).sum(dim=1)
    seg = (seg_cnt - 1).clamp(0, k_pad - 1)
    pred = seg_slope[seg] * (q - segk[seg]) + seg_icept[seg]

    base_t = tile_block.long().clamp(0, m_pad // w_tile - 2) * w_tile
    rank = torch.empty((num_tiles, q_tile), dtype=torch.long, device=dev)
    eq = torch.empty((num_tiles, q_tile), dtype=torch.long, device=dev)
    qt = q.view(num_tiles, q_tile, 1)
    offs = torch.arange(two_w, device=dev)
    tiles = max(1, _WHOLE_WINDOW_ELEMS // (q_tile * two_w))
    for t0 in range(0, num_tiles, tiles):
        ks = sk[base_t[t0:t0 + tiles, None] + offs][:, None, :]
        qc = qt[t0:t0 + tiles]
        rank[t0:t0 + tiles] = (ks <= qc).sum(dim=2)
        eq[t0:t0 + tiles] = (ks == qc).sum(dim=2)
    rank, eq = rank.view(-1), eq.view(-1)
    base = base_t.repeat_interleave(q_tile)
    slot = (base + rank - 1).int()
    fb = ((rank == 0) & (base > 0)) | (rank == two_w)
    return slot, eq > 0, fb, pred
