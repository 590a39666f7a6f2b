"""The hand-written CUDA kernels against their plain torch versions on
the card: the fused lookup (all seven outputs), the ingest placement
(``p``, ``pv``, ``ub``, ``flags``), Eq. 3 gap placement (positions;
NaN equals NaN in the +inf padding rows) and the legacy lookup kernel
(slot, found, fb, pred), identical CUDA inputs, bit for bit.  The
sweep and search cases hold the kernels' searches (the coalesced flat
rank and the whole-window bisect of the fused lookup; the searches
from the predicted slot of the ingest placement) against the plain
versions' literal counts and whole-array bisects.  Marked
``gpu``: each test skips itself without a CUDA device.  This file
imports no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernel_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Index
from repro_torch.kernels import freeze, gap_place, lookup, ops, ops_gap
from repro_torch.kernels.lookup import (fused_lookup, fused_lookup_plain,
                                        lookup_kernel, lookup_kernel_plain)


def _index(seed, span, payloads=None):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.choice(span, 25_000, replace=False)
                     ).astype(np.float64)
    if payloads is not None:
        payloads = payloads + np.arange(keys.size, dtype=np.int64)
    idx = Index.build(keys, method="pgm", eps=64, gap_rho=0.15,
                      device="cuda", payloads=payloads)
    mids = np.setdiff1d(keys[:-1] + np.rint(np.diff(keys) * 0.5),
                        keys)[:3000]
    idx.gapped.insert_batch(mids, 7_000_000 + np.arange(mids.size))
    miss = np.setdiff1d(np.round(rng.uniform(keys[0], keys[-1], 2000)),
                        keys)[:800]
    q = np.concatenate([rng.choice(keys, 2400), mids[:700], miss,
                        [keys[0] - 10.0, keys[-1] + 10.0]])
    return idx, rng.permutation(q)


CASES = [("narrow_flat", 0, 2 ** 22, None), ("narrow_whole", 1, 2 ** 22, 0),
         ("wide_flat", 2, 2 ** 40, None), ("wide_whole", 3, 2 ** 40, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,seed,span,flat_w", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_matches_plain_on_the_card(name, seed, span, flat_w):
    """The CUDA kernel against its plain version on identical CUDA
    inputs: all seven outputs bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx, q = _index(seed, span)
    eng = idx.sync_device()
    a = eng.arrays
    qh, ql = ops.split_queries(np.sort(q), a.key_wide)
    n_pad = 4096
    qh = np.concatenate([qh, np.full(n_pad - q.size, np.inf, np.float32)])
    if a.key_wide:
        ql = np.concatenate([ql, np.zeros(n_pad - q.size, np.float32)])
    q_tile = ops.auto_q_tile(n_pad, a.n_slots, eng.w_tile)
    fw = eng._fused_width_for(n_pad) if flat_w is None else flat_w
    args = ops.fused_args(torch.from_numpy(qh).cuda(),
                          torch.from_numpy(ql).cuda(), a, eng._elo,
                          eng._radix_table, eng._radix_scale,
                          q_tile=q_tile, w_tile=eng.w_tile)
    statics = ops.fused_statics(a, q_tile=q_tile, w_tile=eng.w_tile,
                                flat_w=fw)
    launches = fused_lookup.launches
    got = fused_lookup(*args, **statics)
    want = fused_lookup_plain(*args, **statics)
    torch.cuda.synchronize()
    assert fused_lookup.launches == launches + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("name,seed,span", [("narrow", 4, 2 ** 22),
                                            ("wide", 5, 2 ** 40)],
                         ids=["narrow", "wide"])
def test_ingest_place_matches_plain_on_the_card(name, seed, span):
    """The CUDA ingest-place kernel against ``ingest_place_plain`` on
    identical CUDA inputs (+inf padding rows included): all four
    outputs bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx, q = _index(seed, span)
    a = idx.sync_device().arrays
    x_hi, x_lo = freeze.split_key_pair(np.unique(q + 1.0))
    n_pad = 8192
    x_hi = np.concatenate([x_hi, np.full(n_pad - x_hi.size, np.inf,
                                         np.float32)])
    x_lo = np.concatenate([x_lo, np.zeros(n_pad - x_lo.size, np.float32)])
    args = (torch.from_numpy(x_hi).cuda(), torch.from_numpy(x_lo).cuda(),
            a.seg_first_key, a.seg_first_key_lo, a.seg_slope,
            a.seg_slope_lo, a.seg_icept, a.seg_icept_lo, a.slot_key,
            a.slot_key_lo, a.link_offsets, a.link_keys, a.link_keys_lo)
    launches = gap_place.ingest_place.launches
    got = gap_place.ingest_place(*args, n_slots=a.n_slots)
    want = gap_place.ingest_place_plain(*args, n_slots=a.n_slots)
    torch.cuda.synchronize()
    assert gap_place.ingest_place.launches == launches + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w)


def _same(g, w):
    """Equal values, dtypes and shapes; NaN equals NaN."""
    if g.dtype != w.dtype or g.shape != w.shape:
        return False
    if g.is_floating_point():
        return bool(((g == w) | (g.isnan() & w.isnan())).all())
    return torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("span,key_tile,seg_chunk",
                         [(2 ** 22, 256, 128), (2 ** 40, 2048, 1024)],
                         ids=["narrow_256_128", "wide_2048_1024"])
def test_gap_place_matches_plain_on_the_card(span, key_tile, seg_chunk):
    """The Eq. 3 kernel against ``gap_place_plain`` on identical CUDA
    inputs, +inf padding rows and keys below the first segment
    included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx, _ = _index(6, span)
    x = idx.keys
    y = np.arange(x.size, dtype=np.float64)
    tables = ops_gap.prepare_gap_tables(x, y, idx.mech.plm, 0.15,
                                        seg_chunk)
    xs = np.concatenate([[x[0] - 1e3, x[0] - 1.0], x])
    xp = freeze._pad_pow(xs.astype(np.float32), key_tile,
                         np.float32(np.inf))
    args = [torch.from_numpy(a).cuda() for a in (xp, *tables)]
    launches = gap_place.gap_place.launches
    got = gap_place.gap_place(*args, key_tile=key_tile, seg_chunk=seg_chunk)
    want = gap_place.gap_place_plain(*args)
    torch.cuda.synchronize()
    assert gap_place.gap_place.launches == launches + 1
    assert _same(got, want)
    assert got[xs.size:].isnan().all() and got[:xs.size].isfinite().all()


@pytest.mark.gpu
@pytest.mark.parametrize("q_tile,w_tile,win_chunk",
                         [(128, 512, 128), (256, 2048, 512),
                          (512, 4096, 1024)])
def test_lookup_kernel_matches_plain_on_the_card(q_tile, w_tile, win_chunk):
    """The legacy lookup kernel against ``lookup_kernel_plain`` (which
    counts literally where the kernel bisects) on identical CUDA
    inputs, windows at the first and the last block pair included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx, q = _index(7, 2 ** 22)
    a = freeze.from_learned_index(idx, "cuda", w_tile=w_tile)
    qs = np.sort(np.concatenate([q, [idx.keys[0] - 5.0,
                                     idx.keys[-1] + 5.0]]))
    qp = np.concatenate([qs, np.full((-qs.size) % q_tile + q_tile, np.inf)])
    qt = torch.from_numpy(qp.astype(np.float32)).cuda()
    n_tiles = qp.size // q_tile
    max_block = a.slot_key.shape[0] // w_tile - 2
    tb = torch.from_numpy(np.linspace(0, max_block, n_tiles).astype(
        np.int32)).cuda()
    args = (qt, tb, a.seg_first_key, a.seg_slope, a.seg_icept, a.slot_key)
    tiling = dict(q_tile=q_tile, w_tile=w_tile, win_chunk=win_chunk)
    launches = lookup_kernel.launches
    got = lookup_kernel(*args, **tiling)
    want = lookup_kernel_plain(*args, **tiling)
    torch.cuda.synchronize()
    assert lookup_kernel.launches == launches + 1
    for g, w in zip(got, want):
        assert _same(g, w)
    assert got[1].any() and got[2].any()


SWEEP = [(label, fw, qt) for label in ("narrow", "wide", "wide_i64")
         for fw in (0, 1, 31, 32, 33, 256) for qt in (32, 256, 512)]
_SWEEP_INDEX = {"narrow": (8, 2 ** 22, None), "wide": (9, 2 ** 40, None),
                "wide_i64": (10, 2 ** 40, np.int64(3) << 40)}


@pytest.mark.gpu
@pytest.mark.parametrize("label,flat_w,q_tile", SWEEP,
                         ids=[f"{a}-fw{b}-qt{c}" for a, b, c in SWEEP])
def test_fused_lookup_sweep_on_the_card(label, flat_w, q_tile):
    """Every flat width the engine can produce (0: whole window, 1, 31,
    32, 33, 256), q_tile 32 (several tiles to a CTA), 256 and 512 (the
    kernel's two launch bounds), narrow and wide keys, int64 payloads,
    with the first tile's window at the last block pair and the last
    tile's at the first: all seven outputs bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed, span, pay = _SWEEP_INDEX[label]
    idx, q = _index(seed, span, pay)
    eng = idx.sync_device()
    a = eng.arrays
    assert a.wide == (pay is not None)
    # 2^16 queries (each drawn query ~11 times) with 256 padding rows:
    # at q_tile 32 that is 2,048 tiles, several to a CTA
    q = np.resize(q, (1 << 16) - 256)
    qh, ql = ops.split_queries(np.sort(q), a.key_wide)
    n_pad = 1 << 16
    qh = np.concatenate([qh, np.full(n_pad - q.size, np.inf, np.float32)])
    if a.key_wide:
        ql = np.concatenate([ql, np.zeros(n_pad - q.size, np.float32)])
    args = ops.fused_args(torch.from_numpy(qh).cuda(),
                          torch.from_numpy(ql).cuda(), a, eng._elo,
                          eng._radix_table, eng._radix_scale,
                          q_tile=q_tile, w_tile=eng.w_tile)
    tb = args[2].clone()
    tb[0], tb[-1] = a.slot_key.shape[0] // eng.w_tile - 2, 0
    args = args[:2] + (tb,) + args[3:]
    statics = ops.fused_statics(a, q_tile=q_tile, w_tile=eng.w_tile,
                                flat_w=flat_w)
    tiles, _ = lookup.fused_launch_shape(
        tb.shape[0], q_tile, eng.w_tile, flat_w, a.key_wide,
        torch.cuda.get_device_properties(0).multi_processor_count)
    assert tiles > 1 or q_tile > 32
    got = fused_lookup(*args, **statics)
    want = fused_lookup_plain(*args, **statics)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[4].any()             # the moved tiles escape
    if flat_w == 0 or flat_w >= 31:  # a 2-slot window may miss every key
        assert got[1].any()


def _offset(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary (the kernels' 16-byte staging loads must not be taken)."""
    return torch.cat([t.new_zeros(1), t])[1:] if t.numel() else t


@pytest.mark.gpu
@pytest.mark.parametrize("key_wide", [False, True], ids=["narrow", "wide"])
def test_fused_lookup_unaligned_window_on_the_card(key_wide):
    """Whole-window mode with slot keys that start off a 16-byte
    boundary: the window is staged with 4-byte loads; all seven outputs
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx, q = _index(14, 2 ** 40 if key_wide else 2 ** 22)
    eng = idx.sync_device()
    a = eng.arrays
    qh, ql = ops.split_queries(np.sort(q), a.key_wide)
    n_pad = 8192
    qh = np.concatenate([qh, np.full(n_pad - q.size, np.inf, np.float32)])
    if a.key_wide:
        ql = np.concatenate([ql, np.zeros(n_pad - q.size, np.float32)])
    args = list(ops.fused_args(torch.from_numpy(qh).cuda(),
                               torch.from_numpy(ql).cuda(), a, eng._elo,
                               eng._radix_table, eng._radix_scale,
                               q_tile=32, w_tile=eng.w_tile))
    args[9], args[10] = _offset(args[9]), _offset(args[10])
    assert args[9].data_ptr() % 16 == 4
    statics = ops.fused_statics(a, q_tile=32, w_tile=eng.w_tile, flat_w=0)
    got = fused_lookup(*args, **statics)
    want = fused_lookup_plain(*args, **statics)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["many_segments", "offset_tables"])
def test_ingest_place_segment_staging_on_the_card(case):
    """The segment routing's two staging paths: a table of more than
    2,048 first keys (every other key staged, the last level bisected
    in global memory; heavy-tailed key gaps and eps 1 make the
    segments) and tables that start off a 16-byte boundary (4-byte
    staging loads); all four outputs bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(15)
    if case == "many_segments":
        gaps = np.floor(np.exp(rng.normal(0.0, 4.0, 40_000))) + 1.0
        keys = np.cumsum(gaps)
        idx = Index.build(keys, method="pgm", eps=1, gap_rho=0.15,
                          device="cuda")
    else:
        idx, _ = _index(16, 2 ** 40)
        keys = idx.keys
    a = idx.sync_device().arrays
    if case == "many_segments":
        assert a.seg_first_key.shape[0] > 2048
    batch = np.concatenate([
        np.floor(rng.uniform(keys[0], keys[-1], 6000)),
        keys[::7] + 1.0, [keys[0] - 3.0, keys[-1] + 3.0]])
    n_pad = 1 << int(batch.size + 63).bit_length()
    args = list(_place_args(a, batch, n_pad))
    if case == "offset_tables":
        for k in (2, 3):                 # segment first keys, hi and lo
            args[k] = _offset(args[k])
        assert args[2].data_ptr() % 16 == 4
    got = gap_place.ingest_place(*args, n_slots=a.n_slots)
    want = gap_place.ingest_place_plain(*args, n_slots=a.n_slots)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w)


def _place_args(a, keys, n_pad):
    x_hi, x_lo = freeze.split_key_pair(keys)
    x_hi = np.concatenate([x_hi, np.full(n_pad - x_hi.size, np.inf,
                                         np.float32)])
    x_lo = np.concatenate([x_lo, np.zeros(n_pad - x_lo.size, np.float32)])
    return (torch.from_numpy(x_hi).cuda(), torch.from_numpy(x_lo).cuda(),
            a.seg_first_key, a.seg_first_key_lo, a.seg_slope,
            a.seg_slope_lo, a.seg_icept, a.seg_icept_lo, a.slot_key,
            a.slot_key_lo, a.link_offsets, a.link_keys, a.link_keys_lo)


@pytest.mark.gpu
@pytest.mark.parametrize("name,seed,span", [("narrow", 11, 2 ** 22),
                                            ("wide", 12, 2 ** 40),
                                            ("gap_run", 13, 2 ** 40)],
                         ids=["narrow", "wide", "gap_run"])
def test_ingest_place_searches_on_the_card(name, seed, span):
    """The searches from the predicted slot against the plain version's
    whole-array bisects: per segment the key whose ``p`` lies farthest
    from its ``ub``; ``p`` clipped to 0 and to ``n_slots - 1``; keys
    below the first slot and above the last; the longest chain and its
    neighbours; +inf padding; and (``gap_run``) the keys of a removed
    range of 3,000 neighbours, whose ``pv`` walks the whole gap run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(seed)
    idx, _ = _index(seed, span)
    keys = idx.keys
    inside = np.zeros(0)
    if name == "gap_run":
        inside = keys[10_000:13_000]
        idx.remove(inside)
    a = idx.sync_device().arrays
    cand = np.unique(np.floor(rng.uniform(keys[0], keys[-1], 1 << 16)))
    cand = np.setdiff1d(cand, keys)
    p, _, ub, _ = gap_place.ingest_place_plain(
        *_place_args(a, cand, cand.size), n_slots=a.n_slots)
    dist = (p.long() - ub.long()).abs().cpu().numpy()
    seg = np.searchsorted(a.seg_first_key.cpu().numpy(),
                          cand.astype(np.float32), side="right")
    order = np.lexsort((-dist, seg))
    far = cand[order[np.r_[True, seg[order][1:] != seg[order][:-1]]]]
    off, ck, _ = idx.gapped.links.csr()
    s = int(np.argmax(np.diff(off)))
    chain = ck[off[s]:off[s + 1]]
    steps = 2.0 ** np.arange(0, 40, 3)
    batch = np.concatenate([far, chain, chain - 1.0, chain + 1.0,
                            keys[0] - steps, keys[-1] + steps, inside])
    n_pad = 1 << int(batch.size + 63).bit_length()
    args = _place_args(a, batch, n_pad)
    got = gap_place.ingest_place(*args, n_slots=a.n_slots)
    want = gap_place.ingest_place_plain(*args, n_slots=a.n_slots)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w)
    p, pv, ub = (t.long().cpu().numpy() for t in got[:3])
    assert (p == 0).any() and (p == a.n_slots - 1).any()
    assert (ub == -1).any() and (ub == a.slot_key.shape[0] - 1).any()
    if name == "gap_run":
        assert (p - pv).max() > 2_000
