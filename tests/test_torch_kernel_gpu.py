"""The hand-written CUDA kernels against their plain torch versions on
the card: the fused lookup (all seven outputs), the ingest placement
(``p``, ``pv``, ``ub``, ``flags``), Eq. 3 gap placement (positions;
NaN equals NaN in the +inf padding rows) and the legacy lookup kernel
(slot, found, fb, pred), identical CUDA inputs, bit for bit.  The
sweep and search cases hold the kernels' searches (the coalesced flat
rank and the whole-window bisect of the fused lookup; the searches
from the predicted slot of the ingest placement) against the plain
versions' literal counts and whole-array bisects; the bracket cases
hold the chunk brackets of the Eq. 3 kernel and the tile brackets and
staged slices of the legacy kernel the same way.  Marked ``gpu``: each
test skips itself without a CUDA device.  The bracket cases' inputs
(``gap_case_args``, ``legacy_case_args``, ``legacy_tiling_args``) are
also what ``chip_smoke.py`` phase 7 runs and what
tests/test_torch_slot_order.py checks on the CPU.  This file imports
no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernel_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Index
from repro_torch.core.mechanisms import PGMMechanism
from repro_torch.kernels import freeze, gap_place, lookup, ops, ops_gap
from repro_torch.kernels.lookup import (fused_lookup, fused_lookup_plain,
                                        lookup_kernel, lookup_kernel_plain)


def _index(seed, span, payloads=None, device="cuda"):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.choice(span, 25_000, replace=False)
                     ).astype(np.float64)
    if payloads is not None:
        payloads = payloads + np.arange(keys.size, dtype=np.int64)
    idx = Index.build(keys, method="pgm", eps=64, gap_rho=0.15,
                      device=device, payloads=payloads)
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


# ---------------------------------------------------------------------------
# the bracket designs of csrc/gap_place.cu (4,096-key chunks, at most
# 256 staged table rows) and csrc/lookup_kernel.cu (a staged slice of at
# most 2,048 window keys): the cases each design introduces
# ---------------------------------------------------------------------------

_CHUNK = gap_place.GAP_CHUNK
GAP_CASES = ["shuffled", "shuffled_few", "one_segment", "below_first",
             "padding_mid_chunk", "ragged", "unaligned"]


def gap_case_args(case, device="cuda"):
    """``gap_place``'s tensor arguments for ``case`` on ``device``:
    ``[keys, segk, base, x0, scale]`` (f32), and the number of real
    (non-padding) keys.

    * ``shuffled``: keys in random order over 761 segments, so every
      chunk's bracket spans more rows than are staged;
    * ``shuffled_few``: the same over 17 segments, so every
      chunk's bracket is staged and each key bisects it;
    * ``one_segment``: a table of one real row (+inf padded);
    * ``below_first``: 5,000 keys below the first segment, then the
      keys (whole chunks routed below the table);
    * ``padding_mid_chunk``: +inf padding from the middle of a chunk,
      and a count that is no multiple of the chunk;
    * ``ragged``: a count that is a multiple of neither the chunk nor 4;
    * ``unaligned``: sorted keys that start 4 bytes past a 16-byte
      boundary (the kernel's 4-byte path).
    """
    rng = np.random.default_rng(20)
    x = np.unique(rng.choice(2 ** 40, 60_000, replace=False)
                  ).astype(np.float64)
    eps = {"shuffled": 4, "shuffled_few": 32, "one_segment": 1e12}.get(
        case, 64)
    mech = PGMMechanism(eps=eps, recursive=False).fit(
        x, np.arange(x.size, dtype=np.float64))
    if case == "one_segment":
        assert mech.plm.n_segments == 1
    tables = ops_gap.prepare_gap_tables(
        x, np.arange(x.size, dtype=np.float64), mech.plm, 0.15, 512)
    keys = x.astype(np.float32)
    n_real = keys.size
    if case.startswith("shuffled"):
        keys = rng.permutation(keys)
    elif case == "below_first":
        keys = np.concatenate([np.linspace(x[0] - 2.0 ** 30, x[0] - 1.0,
                                           5000).astype(np.float32), keys])
        n_real = keys.size
    elif case == "padding_mid_chunk":
        keys = keys[:3 * _CHUNK + 1500]
        n_real = keys.size
        keys = np.concatenate([keys, np.full(_CHUNK - 1000, np.inf,
                                             np.float32)])
    elif case == "ragged":
        keys = keys[:5 * _CHUNK + 1001]
        n_real = keys.size
    args = [torch.from_numpy(a).to(device) for a in (keys, *tables)]
    if case == "unaligned":
        args[0] = _offset(args[0])
    return args, n_real


@pytest.mark.gpu
@pytest.mark.parametrize("case", GAP_CASES)
def test_gap_place_bracket_cases_on_the_card(case):
    """The Eq. 3 kernel's chunk brackets against ``gap_place_plain`` on
    identical CUDA inputs, bit for bit (NaN equals NaN in the +inf
    padding rows): shuffled keys, a one-segment table, keys below the
    first segment, padding from mid-chunk, ragged and unaligned
    counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args, n_real = gap_case_args(case)
    if case == "unaligned":
        assert args[0].data_ptr() % 16 == 4
    launches = gap_place.gap_place.launches
    got = gap_place.gap_place(*args)
    want = gap_place.gap_place_plain(*args)
    torch.cuda.synchronize()
    assert gap_place.gap_place.launches == launches + 1
    assert _same(got, want)
    assert got[:n_real].isfinite().all() and got[n_real:].isnan().all()


LEGACY_CASES = ["below_above", "all_padding", "whole_window", "gap_edges",
                "unsorted"]


def legacy_case_args(case, device="cuda", q_tile=128, w_tile=2048,
                     seed=21):
    """Synthetic tensor arguments of ``lookup_kernel`` for ``case`` on
    ``device``: ``(queries, tile_block, segk, slope, icept,
    slot_keys)``, for ``q_tile`` / ``w_tile`` tiling.  The slot
    keys are non-decreasing with runs of equal keys (the gaps) and a
    +inf tail; the segment table is sorted and +inf padded.  Ordinary
    tiles (sorted queries, the block under their least query) surround
    the case's own tiles:

    * ``below_above``: tiles whose queries all lie below their window,
      and tiles whose queries all lie above it;
    * ``all_padding``: a tile of +inf only, at the last block pair and
      at the first;
    * ``whole_window``: tiles whose queries reach below and above the
      window, so the slice is the whole window (wider than the staged
      buffer at w_tile 2,048);
    * ``gap_edges``: tiles whose least query sits just below a run of
      equal keys and whose greatest equals the key of another run, so
      both slice edges fall in runs;
    * ``unsorted``: tiles of shuffled queries, one with a NaN.
    """
    rng = np.random.default_rng(seed)
    n_blocks = 24
    m_pad = n_blocks * w_tile
    n_real = m_pad - w_tile // 2 - 7
    steps = rng.choice([0.0, 1.0, 2.0, 5.0], n_real, p=[0.3, 0.4, 0.2, 0.1])
    steps[rng.choice(n_real, 40, replace=False)] = 0.0
    keys = 1000.0 + np.cumsum(steps)
    for r in rng.choice(n_real - 200, 12, replace=False):   # long runs
        keys[r:r + 150] = keys[r]
    keys = np.maximum.accumulate(keys)
    sk = np.concatenate([keys, np.full(m_pad - n_real, np.inf)]
                        ).astype(np.float32)
    first = keys[::3000]
    k_pad = 512
    segk = np.concatenate([first, np.full(k_pad - first.size, np.inf)]
                          ).astype(np.float32)
    slope = rng.uniform(0.3, 0.7, k_pad).astype(np.float32)
    icept = (np.arange(k_pad) * 3000.0).astype(np.float32)
    max_block = n_blocks - 2

    def tile_at(q):
        q = np.sort(np.asarray(q, np.float32))
        pos = np.searchsorted(sk, q[0], side="left")
        return q, min(max(int(pos) // w_tile, 0), max_block)

    tiles = []
    for _ in range(6):                                # ordinary tiles
        c = rng.integers(0, n_real - q_tile * 8)
        tiles.append(tile_at(keys[c + rng.integers(0, q_tile * 8, q_tile)]
                             + rng.choice([0.0, 0.5], q_tile)))
    lo_key, hi_key = keys[0], keys[-1]
    if case == "below_above":
        tiles.append((np.sort(rng.uniform(lo_key, keys[3 * w_tile],
                                          q_tile)).astype(np.float32),
                      max_block))
        tiles.append((np.sort(rng.uniform(keys[-3 * w_tile], hi_key + 50.0,
                                          q_tile)).astype(np.float32), 0))
        tiles.append((np.full(q_tile, lo_key - 10.0, np.float32), 5))
    elif case == "all_padding":
        tiles.append((np.full(q_tile, np.inf, np.float32), max_block))
        tiles.append((np.full(q_tile, np.inf, np.float32), 0))
    elif case == "whole_window":
        for blk in (0, 7, max_block):
            w0, w1 = sk[blk * w_tile], sk[blk * w_tile + 2 * w_tile - 1]
            w1 = w1 if np.isfinite(w1) else hi_key
            q = rng.uniform(w0 - 20.0, w1 + 20.0, q_tile)
            q[:2] = [w0 - 20.0, w1 + 20.0]
            tiles.append((np.sort(q).astype(np.float32), blk))
    elif case == "gap_edges":
        run_starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
        run_len = np.diff(np.r_[run_starts, keys.size])
        long_runs = run_starts[run_len >= 3]
        for t in range(4):
            a, b = np.sort(rng.choice(long_runs, 2, replace=False))
            if keys[b] - keys[a] > 1500:
                b = long_runs[np.searchsorted(long_runs, a) + 1]
            inner = keys[a + rng.integers(0, b - a + 1, q_tile - 2)]
            q = np.concatenate([[keys[a] - 0.5, keys[b]], inner])
            tiles.append(tile_at(q))
    elif case == "unsorted":
        for t in range(4):
            c = rng.integers(0, n_real - q_tile * 8)
            q, blk = tile_at(keys[c + rng.integers(0, q_tile * 8, q_tile)]
                             + 0.5 * rng.integers(0, 2, q_tile))
            q = rng.permutation(q)
            if t == 0:
                q[q_tile // 2] = np.nan
            tiles.append((q, blk))
    order = rng.permutation(len(tiles))
    q = np.concatenate([tiles[i][0] for i in order]).astype(np.float32)
    tb = np.array([tiles[i][1] for i in order], np.int32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (q, tb, segk, slope, icept, sk))


@pytest.mark.gpu
@pytest.mark.parametrize("case", LEGACY_CASES)
def test_lookup_kernel_bracket_cases_on_the_card(case):
    """The legacy kernel's tile brackets against ``lookup_kernel_plain``
    (literal counts) on identical CUDA inputs, all four outputs bit for
    bit: tiles below and above their window, all-padding tiles, a slice
    that is the whole window, runs of equal keys at both slice edges,
    unsorted tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = legacy_case_args(case)
    tiling = dict(q_tile=128, w_tile=2048)
    launches = lookup_kernel.launches
    got = lookup_kernel(*args, **tiling)
    want = lookup_kernel_plain(*args, **tiling)
    torch.cuda.synchronize()
    assert lookup_kernel.launches == launches + 1
    for g, w in zip(got, want):
        assert _same(g, w)
    if case in ("below_above", "all_padding", "whole_window"):
        assert got[2].any()


LEGACY_TILINGS = [(qt, wt) for qt in (32, 128, 256, 1024)
                  for wt in (512, 2048, 8192)]


def legacy_tiling_args(q_tile, w_tile, device="cuda"):
    """``lookup_kernel``'s arguments for sorted mixed queries (hits, gap
    keys, misses, both ends) over a narrow 25,000-key index frozen at
    ``w_tile``, with the ``pallas`` stage's own tile schedule."""
    idx, q = _index(22, 2 ** 22, device=device)
    a = freeze.from_learned_index(idx, device, w_tile=w_tile)
    qs = np.sort(np.concatenate([q, q + 0.5]))
    qp = np.concatenate([qs, np.full((-qs.size) % q_tile, np.inf)])
    qt = torch.from_numpy(qp.astype(np.float32)).to(device)
    elo = ops._pad_bounds(idx.mech.plm.err_lo, a.seg_first_key.shape[0],
                          device)
    y_hat, seg = ops.predict_ref(qt, a.seg_first_key, a.seg_slope,
                                 a.seg_icept)
    lo = lookup._clip(y_hat + elo[seg] - 1.0,
                      lookup._slot_clip_hi(a.n_slots))
    tb = ops.tile_blocks(lo, a, q_tile=q_tile, w_tile=w_tile)
    return (qt, tb, a.seg_first_key, a.seg_slope, a.seg_icept, a.slot_key)


@pytest.mark.gpu
@pytest.mark.parametrize("q_tile,w_tile", LEGACY_TILINGS,
                         ids=[f"qt{a}-wt{b}" for a, b in LEGACY_TILINGS])
def test_lookup_kernel_tilings_on_the_card(q_tile, w_tile):
    """q_tile 32-1024 by w_tile 512-8192 (a 64 KiB window at 8,192),
    sorted mixed queries over a real narrow index with the ``pallas``
    stage's own tile schedule, all four outputs bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = legacy_tiling_args(q_tile, w_tile)
    tiling = dict(q_tile=q_tile, w_tile=w_tile)
    got = lookup_kernel(*args, **tiling)
    want = lookup_kernel_plain(*args, **tiling)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _same(g, w)
    assert got[1].any()


@pytest.mark.gpu
def test_serving_stack_launches_from_the_timer_thread_on_the_card(tmp_path):
    """``MicroBatchQueue``'s deadline flush runs the fused lookup and
    the placement kernel from its timer thread: the answers equal the
    host oracle, the kernels' counts grow, and a checkpoint of the
    written index restores and recovers on the card to the same
    state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time

    from repro_torch.serving import (EpochPipeline, IngestWAL,
                                     MicroBatchQueue, recover_index)
    idx, q = _index(8, 2 ** 40)
    idx.sync_device()      # an ingest takes the device path when frozen
    keys = idx.keys
    fresh = np.setdiff1d(keys[:-1] + np.floor(np.diff(keys) * 0.25),
                         idx.gapped.live_items()[0])[:2_048]
    wal = IngestWAL(tmp_path / "w.wal")
    pipe = EpochPipeline(idx, wal=wal, publish_every=1)
    pipe.checkpoint(tmp_path / "ck", step=0)
    queue = MicroBatchQueue(pipe, max_wait_ms=5)
    n_lookup, n_place = fused_lookup.launches, gap_place.ingest_place.launches
    t_in = queue.submit_ingest(fresh, 9_000_000 + np.arange(fresh.size))
    t_q = queue.submit_lookup(q[:2_048])
    deadline = time.monotonic() + 30.0
    while queue.stats["deadline_flushes"] == 0:
        assert time.monotonic() < deadline, "deadline timer never fired"
        time.sleep(0.005)
    rep, res = queue.result(t_in), queue.result(t_q)
    # the flush ingests first; the publish after it serves the lookup
    # from the live index, on the card
    assert rep.placement.startswith("device") and res.epoch == idx.epoch
    assert res.backend in ("fused", "device-oracle")
    pay, _slot, found = idx.gapped.lookup_batch(q[:2_048], full=True)
    assert np.array_equal(res.payloads, pay)
    assert np.array_equal(res.found, found)
    assert fused_lookup.launches > n_lookup
    assert gap_place.ingest_place.launches > n_place
    queue.close()
    pipe.close()
    rec, info = recover_index(tmp_path / "ck", tmp_path / "w.wal",
                              device="cuda")
    assert info["replayed"] == 1 and rec.device.type == "cuda"
    ga, gb = rec.gapped, idx.gapped
    assert np.array_equal(ga.slot_key, gb.slot_key)
    assert np.array_equal(ga.payload, gb.payload)
    r = rec.lookup(fresh)
    assert r.found.all() and r.backend in ("fused", "device-oracle")


def _sharded_pair(seed=9, shards=4):
    """The same sharded build and writes on the card and on the CPU."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.choice(2 ** 40, 25_000, replace=False)
                     ).astype(np.float64)
    out = []
    for dev in ("cuda", "cpu"):
        idx = Index.build(keys, shards=shards, method="pgm", eps=64,
                          gap_rho=0.15, device=dev)
        mids = np.setdiff1d(keys[:-1] + np.rint(np.diff(keys) * 0.5),
                            keys)[::4]
        idx.ingest(mids, (5 << 40) + np.arange(mids.size))
        out.append(idx)
    q = np.concatenate([rng.choice(keys, 3_000), mids[:900],
                        rng.choice(keys, 600) + 1.0,
                        [keys[0] - 10.0, keys[-1] + 10.0]])
    return out[0], out[1], rng.permutation(q)


@pytest.mark.gpu
def test_shard_fanout_on_the_card_equals_the_cpu():
    """The fan-out's torch ops on the card give the CPU's outputs bit
    for bit at 25k keys over 4 shards: the raw per-row outputs of one
    padded bucket (escape flags and drops included), then the patched
    lookups, with a small exchange cap as well."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gpu, cpu, q = _sharded_pair()
    fg, fc = gpu._fanout(), cpu._fanout()
    assert fg.devices[0].type == "cuda" and fc.devices[0].type == "cpu"
    assert fg.S == fc.S == 4
    bucket = fc._bucket(q.size)
    qp = np.full(bucket, np.inf)
    qp[:q.size] = q
    qh, ql = ops.split_queries(qp, True)
    for cap in (fc._cap_for(bucket), 64):
        want = fc._run(qh, ql, cap)
        got = fg._run(qh, ql, cap)
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), np.asarray(g))
    a, b = gpu.lookup(q), cpu.lookup(q)
    assert a.backend == b.backend == "sharded-fanout"
    for f in ("payloads", "slots", "found"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.fallbacks == b.fallbacks
    fg._cap_for = fc._cap_for = lambda n: 16
    a, b = gpu.lookup(q), cpu.lookup(q)
    assert fg.stats["cap_overflows"] == fc.stats["cap_overflows"] == 1
    for f in ("payloads", "slots", "found"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.gpu
def test_grouped_fused_lookup_launches_once_per_touched_shard():
    """``backend="fused"`` on a sharded index groups the batch by the
    exact route and runs each touched shard's fused stage: one launch
    of the CUDA kernel per touched shard, answers equal the fan-out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gpu, _cpu, q = _sharded_pair(seed=10)
    bounds = gpu.router.bounds
    q3 = q[q < bounds[2]]                  # shards 0, 1 and 2 only
    touched = np.unique(gpu.router.route(q3)).size
    assert touched == 3
    want = gpu.lookup(q3, backend="fanout")
    n0 = fused_lookup.launches
    got = gpu.lookup(q3, backend="fused")
    assert got.backend == "sharded-host"
    assert fused_lookup.launches - n0 == touched
    for f in ("payloads", "slots", "found"):
        assert np.array_equal(getattr(want, f), getattr(got, f)), f


@pytest.mark.gpu
def test_reduced_decode_on_the_card_equals_the_cpu():
    """The decode path at a reduced depth in f32 (TF32 off, f32 caches):
    prefill and two decode steps of ``reduced(internlm2-1.8b)`` give the
    CPU's logits on the card within 1e-4 (sums in another order), with
    equal argmax; and a ``ServingEngine`` on the card (bf16 caches, as
    served) generates the CPU engine's tokens at temperature 0, its
    page lookups one ``fused_lookup`` launch a round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine
    cfg = reduced(ARCHS["internlm2-1.8b"])
    model = build_model(cfg)
    from repro_torch.models import lm

    def tree_to(t, **kw):
        if isinstance(t, dict):
            return {k: tree_to(v, **kw) for k, v in t.items()}
        return t.to(**kw)

    p_cpu = tree_to(model.init_params(torch.Generator().manual_seed(1),
                                      "cpu"), dtype=torch.float32)
    p_gpu = tree_to(p_cpu, device="cuda")
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (3, 9)))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for prm, dev in ((p_cpu, "cpu"), (p_gpu, "cuda")):
            cache = lm.init_kv_cache(cfg, 3, 32, dtype=torch.float32,
                                     device=dev)
            lg, cache = model.prefill_fn(prm, {"tokens": tok[:, :7].to(dev)},
                                         cache)
            seq = [lg.float().cpu()]
            for i in (7, 8):
                lg, cache = model.decode_fn(
                    prm, {"tokens": tok[:, i:i + 1].to(dev)}, cache, i)
                seq.append(lg.float().cpu())
            outs.append(seq)
        for a, b in zip(*outs):
            assert float((a - b).abs().max()) <= 1e-4
            assert torch.equal(a.argmax(-1), b.argmax(-1))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved

    gen = []
    for prm, dev in ((p_cpu, "cpu"), (p_gpu, "cuda")):
        eng = ServingEngine(model, max_batch=4, max_len=64, device=dev)
        eng.load(prm)
        rng = np.random.default_rng(3)
        reqs = [Request(request_id=r, prompt=rng.integers(
            0, cfg.vocab, rng.integers(4, 24), dtype=np.int32),
            max_new_tokens=6) for r in range(1, 9)]
        for r in reqs:
            eng.submit(r)
        launches = fused_lookup.launches
        stats = eng.run_until_done()
        gen.append([r.generated for r in reqs])
        if dev == "cuda":
            assert fused_lookup.launches - launches == stats["rounds"]
    assert gen[0] == gen[1]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m"])
def test_reduced_recurrent_decode_on_the_card_equals_the_cpu(arch):
    """The Mamba-2 / shared-attention and xLSTM decode paths at
    ``reduced`` size in f32 (TF32 off, f32 caches) on the draws as
    ``chip_smoke.conditioned`` conditions them (drawn, the shared
    block's saturated softmax and Mamba-2's fast-forgetting state make
    reduced zamba amplify a one-ulp change of its params, so two sum
    orders part by more than 1e-4): the chunked ``forward`` and three
    decode steps give the
    CPU's logits on the card within 1e-4, with equal argmax, and every
    cache leaf after the steps within 1e-4; then the sLSTM cell (which
    ``reduced(xlstm)``'s two blocks do not reach) on the card against
    the CPU, both branches, within 1e-5; and a ``ServingEngine`` on the
    card (the served cache dtypes) generates the CPU engine's tokens at
    temperature 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import conditioned
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_model
    from repro_torch.models import lm, xlstm_lm, zamba
    from repro_torch.models import xlstm as pxl
    from repro_torch.models.base import init_params
    from repro_torch.serving import Request, ServingEngine
    cfg = reduced(ARCHS[arch])
    model = build_model(cfg)
    fwd = zamba.forward if cfg.arch == "zamba" else xlstm_lm.forward

    def tree_to(t, **kw):
        if isinstance(t, dict):
            return {k: tree_to(v, **kw) for k, v in t.items()}
        if isinstance(t, tuple):
            return type(t)(*(tree_to(v, **kw) for v in t))
        return t.to(**kw)

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, tuple):
            return [x for v in t for x in leaves(v)]
        return [t]

    p_cpu = conditioned(tree_to(model.init_params(
        torch.Generator().manual_seed(1), "cpu"), dtype=torch.float32))
    p_gpu = tree_to(p_cpu, device="cuda")
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (3, 9)))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs, caches = [], []
        for prm, dev in ((p_cpu, "cpu"), (p_gpu, "cuda")):
            hidden, _ = fwd(prm, tok.to(dev), cfg)
            seq = [lm.logits_fn(prm, hidden, cfg).float().cpu()]
            cache = tree_to(model.init_caches(3, 32, device=dev),
                            dtype=torch.float32)
            for i in range(3):
                lg, cache = model.decode_fn(
                    prm, {"tokens": tok[:, i:i + 1].to(dev)}, cache, i)
                seq.append(lg.float().cpu())
            outs.append(seq)
            caches.append([t.float().cpu() for t in leaves(cache)])
        for a, b in zip(*outs):
            assert float((a - b).abs().max()) <= 1e-4
            assert torch.equal(a.argmax(-1), b.argmax(-1))
        for a, b in zip(*caches):
            assert float((a - b).abs().max()) <= 1e-4
        sl = init_params(pxl.slstm_specs(64, 4),
                         torch.Generator().manual_seed(4), "cpu")
        sl = {k: v.float() for k, v in sl.items()}
        x = torch.randn((2, 5, 64), generator=torch.Generator().manual_seed(5))
        for cached in (False, True):
            got = []
            for dev in ("cpu", "cuda"):
                c = (pxl.init_slstm_cache(2, 4, 16, device=dev) if cached
                     else None)
                o, nc = pxl.slstm_forward(tree_to(sl, device=dev),
                                          x.to(dev), n_heads=4, cache=c)
                got.append([o.cpu()] + ([t.cpu() for t in nc] if cached
                                        else []))
            for a, b in zip(*got):
                assert float((a - b).abs().max()) <= 1e-5
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved

    gen = []
    for prm, dev in ((p_cpu, "cpu"), (p_gpu, "cuda")):
        eng = ServingEngine(model, max_batch=4, max_len=64, device=dev)
        eng.load(prm)
        rng = np.random.default_rng(3)
        reqs = [Request(request_id=r, prompt=rng.integers(
            0, cfg.vocab, rng.integers(4, 24), dtype=np.int32),
            max_new_tokens=6) for r in range(1, 9)]
        for r in reqs:
            eng.submit(r)
        launches = fused_lookup.launches
        stats = eng.run_until_done()
        gen.append([r.generated for r in reqs])
        if dev == "cuda":
            assert fused_lookup.launches - launches == stats["rounds"]
    assert gen[0] == gen[1]


@pytest.mark.gpu
def test_xla_engine_on_the_card_equals_the_kernel_engine():
    """``QueryEngine(fused_impl="xla")`` on the card (the rank-router
    graph in torch ops, no kernel launch) answers as the kernel engine
    does, and its placement primitives equal the kernel's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed, span in ((0, 2 ** 22), (2, 2 ** 40)):
        idx, q = _index(seed, span)
        eng = idx.sync_device()
        xeng = ops.QueryEngine(eng.arrays, eng.err_lo, eng.err_hi,
                               fused_impl="xla", w_tile=eng.w_tile)
        launches = fused_lookup.launches
        got = xeng.lookup(q)
        assert fused_lookup.launches == launches
        want = eng.lookup(q)
        for g, w in zip(got[:3], want[:3]):
            assert np.array_equal(np.asarray(g), np.asarray(w))
        assert xeng.last_stage == "fused"
        keys = np.setdiff1d(np.floor(np.random.default_rng(seed).uniform(
            q.min(), q.max(), 3000)), q)
        place = gap_place.ingest_place.launches
        (gp, ge), (kp, ke) = xeng.ingest_place(keys), eng.ingest_place(keys)
        assert gap_place.ingest_place.launches == place + 1
        assert np.array_equal(ge, ke)
        for f in gp:
            assert np.array_equal(gp[f], kp[f]), f


@pytest.mark.gpu
def test_reduced_trainer_on_the_card_checkpoints_and_restores(tmp_path):
    """A few ``Trainer`` steps of ``reduced(internlm2-1.8b)`` on the card
    (f32 params from the CPU's draw, TF32 off) with a checkpoint, a crash
    and a resume: the card's per-step losses equal the CPU trainer's
    within 1e-4 relative, the resumed run replays the crashed run's
    steps, and the final checkpoint restores onto the card bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.data import (IndexedTokenDataset, PackedTokenStore,
                                  ShardedLoader)
    from repro_torch.models import build_model
    from repro_torch.train import (CheckpointManager, FailureInjector,
                                   TrainConfig, Trainer)
    from repro_torch.tree import leaf_paths, tree_map
    cfg = dataclasses.replace(reduced(ARCHS["internlm2-1.8b"]), remat="full")
    model = build_model(cfg)
    store = PackedTokenStore.synthetic(256, mean_len=33, vocab=cfg.vocab,
                                       seed=0)

    def trainer(dev, d, crash=None):
        ds = IndexedTokenDataset.build(store, method="pgm", sample_rate=0.1,
                                       device=dev)
        loader = ShardedLoader(ds, global_batch=4, seq_len=32, seed=0)
        tcfg = TrainConfig(total_steps=8, warmup_steps=2, ckpt_every=4,
                           ckpt_dir=str(tmp_path / d), log_every=1)
        tr = Trainer(model, tcfg, loader, device=dev,
                     failure_injector=FailureInjector(crash or {}))
        f32 = tree_map(lambda t: t.float(), model.init_params(
            torch.Generator().manual_seed(0), "cpu"))
        tr.init_state = lambda seed=0: {   # the CPU's draw on either device
            "params": tree_map(lambda t: t.to(dev), f32),
            "opt": tr._opt_init(tree_map(lambda t: t.to(dev), f32)),
            "residual": tree_map(lambda t: torch.zeros(
                (), device=dev), f32)}
        return tr

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = trainer("cpu", "cpu").run()
        crashed = trainer("cuda", "card", {6: "crash"})
        with pytest.raises(RuntimeError, match="injected crash"):
            crashed.run()
        crashed.ckpt.wait()
        crashed.watchdog.close()
        resumed = trainer("cuda", "card")
        out = resumed.run()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    card = crashed.metrics[:4] + out["metrics"]
    assert [m["step"] for m in card] == list(range(1, 9))
    for g, w in zip(card, cpu["metrics"]):
        assert abs(g["loss"] - w["loss"]) <= 1e-4 * abs(w["loss"]), (g, w)
    for g, w in zip(out["metrics"][:2], crashed.metrics[4:6]):
        assert abs(g["loss"] - w["loss"]) <= 1e-4 * abs(w["loss"])
    assert resumed.loader.step == 8
    got, extra = CheckpointManager(str(tmp_path / "card")).restore(
        template=out["state"])
    assert extra == {"step": 8, "loader_step": 8}
    for (_, a), (_, b) in zip(leaf_paths(got), leaf_paths(out["state"])):
        assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.fixture
def one_rank_nccl_group(tmp_path):
    """One process in an ``nccl`` group of one (a file store under
    ``tmp_path``), destroyed after the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_sharded_trainer_on_a_one_rank_mesh_is_bit_identical(
        tmp_path, one_rank_nccl_group):
    """``chip_smoke.py`` phase 16 at reduced size: two ``Trainer`` steps
    of ``reduced(internlm2-1.8b)`` (bf16, ``remat="full"``) on the card,
    plain and with the constrainer of ``make_mesh_for(1, 1)``, give
    bit-identical losses, gnorms and state; the sharded state's
    checkpoint restores through ``elastic_restore`` onto (1, 1) bit for
    bit."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.dist import activation_constrainer
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.elastic import elastic_restore
    from repro_torch.tree import leaf_paths
    cfg = dataclasses.replace(reduced(ARCHS["internlm2-1.8b"]), remat="full")
    model = build_model(cfg)
    mesh = make_mesh_for(1, 1)
    assert mesh.device_type == "cuda" and tuple(mesh.shape) == (1, 1)
    g = torch.Generator().manual_seed(3)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (4, 32), generator=g),
                "labels": torch.randint(0, cfg.vocab, (4, 32), generator=g),
                "mask": (torch.rand((4, 32), generator=g) > 0.1).float()}
               for _ in range(2)]
    runs = {}
    for label, hook in (("plain", None), ("mesh",
                                          activation_constrainer(mesh))):
        tr = Trainer(model, TrainConfig(total_steps=2, warmup_steps=1,
                                        ckpt_dir=str(tmp_path / label)),
                     None, constrain=hook, device="cuda")
        state = tr.init_state(0)
        ms = [tr.train_step(state, {k: v.cuda() for k, v in b.items()})
              for b in batches]
        runs[label] = (tr, state, [(float(m["loss"]), float(m["gnorm"]))
                                   for m in ms])
    (_, plain, m1), (tr, sharded, m2) = runs["plain"], runs["mesh"]
    assert m1 == m2
    assert isinstance(sharded["params"]["embed"], DTensor)

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t
    for (path, a), (_, b) in zip(leaf_paths(plain), leaf_paths(sharded)):
        assert torch.equal(a.detach(), whole(b).detach()), path
    tr.ckpt.save(2, sharded, extra={"step": 2})
    restored, rmesh, extra = elastic_restore(model, tr.cfg.ckpt_dir,
                                             template=plain)
    assert tuple(rmesh.shape) == (1, 1) and extra == {"step": 2}
    for (path, a), (_, b) in zip(leaf_paths(restored), leaf_paths(plain)):
        assert whole(a).device.type == "cuda"
        assert torch.equal(whole(a).detach(), b.detach()), path


@pytest.mark.gpu
def test_expert_parallel_moe_on_a_one_rank_mesh_equals_gspmd(
        one_rank_nccl_group):
    """``reduced(granite-moe-1b-a400m)`` in f32 on the card (TF32 off):
    the forward with ``moe_impl="ep"`` over ``make_mesh_for(1, 1)``
    (``moe_ep_shardmap``'s exchanges over an ``nccl`` group of one)
    within the reference's 2e-4 of ``moe_gspmd``."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.dist import activation_constrainer
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import build_model, lm
    from repro_torch.tree import tree_map
    cfg = reduced(ARCHS["granite-moe-1b-a400m"])
    ep = dataclasses.replace(cfg, moe_impl="ep")
    params = tree_map(lambda t: t.float().cuda(), build_model(cfg).init_params(
        torch.Generator().manual_seed(0), "cpu"))
    tokens = torch.randint(0, cfg.vocab, (2, 32),
                           generator=torch.Generator().manual_seed(1)).cuda()
    constrain = activation_constrainer(make_mesh_for(1, 1))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = lm.forward(params, tokens, cfg)
            got = lm.forward(params, tokens, ep, constrain)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert float((got - want).abs().max()) <= 2e-4


@pytest.mark.gpu
def test_dry_run_flops_equal_the_cards():
    """``chip_smoke.py`` phase 17 (a) at a small cut: internlm2-1.8b at
    full width and 2 layers, train_4k's sequence at 2 rows, through the
    plain step ``launch.dryrun.build_step`` builds: ``FlopCounterMode``
    on the card equals ``count_step`` over ``meta`` tensors exactly, and
    the card's peak is within 25% of the count's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    model = build_model(dataclasses.replace(ARCHS["internlm2-1.8b"],
                                            n_layers=2))
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=2)
    step, args = dryrun.build_step(model, shape, None)
    counted = dryrun.count_step(step, args)
    step, args = dryrun.build_step(model, shape, None, device="cuda")
    with FlopCounterMode(display=False) as flops:
        step(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(*args)
    peak = torch.cuda.max_memory_allocated()
    assert float(flops.get_total_flops()) == counted["flops_per_device"]
    assert abs(peak - counted["peak_bytes"]) <= 0.25 * counted["peak_bytes"]


@pytest.mark.gpu
def test_adafactor_trainer_on_a_one_rank_mesh_is_bit_identical(
        tmp_path, one_rank_nccl_group):
    """``chip_smoke.py`` phase 16's check for the tensor-parallel design
    with Adafactor: ``reduced(kimi-k2-1t-a32b)`` (MoE, FSDP, bf16) on
    the card, two ``Trainer`` steps plain and over ``make_mesh_for(1,
    1)``: the trainer runs "tensor-parallel", the factored moments are
    placed as DTensors, and losses, gnorms and every state leaf are bit
    for bit."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.dist import activation_constrainer
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaf_paths
    cfg = dataclasses.replace(reduced(ARCHS["kimi-k2-1t-a32b"]), remat="full")
    assert cfg.optimizer == "adafactor" and cfg.fsdp
    model = build_model(cfg)
    mesh = make_mesh_for(1, 1)
    g = torch.Generator().manual_seed(5)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (4, 32), generator=g),
                "labels": torch.randint(0, cfg.vocab, (4, 32), generator=g),
                "mask": (torch.rand((4, 32), generator=g) > 0.1).float()}
               for _ in range(2)]
    runs = {}
    for label, hook in (("plain", None), ("mesh",
                                          activation_constrainer(mesh))):
        tr = Trainer(model, TrainConfig(total_steps=2, warmup_steps=1,
                                        ckpt_dir=str(tmp_path / label)),
                     None, constrain=hook, device="cuda")
        state = tr.init_state(0)
        ms = [tr.train_step(state, {k: v.cuda() for k, v in b.items()})
              for b in batches]
        runs[label] = (tr, state, [(float(m["loss"]), float(m["gnorm"]))
                                   for m in ms])
    (_, plain, m1), (tr, sharded, m2) = runs["plain"], runs["mesh"]
    assert tr.design == "tensor-parallel"
    assert m1 == m2
    slot = sharded["opt"]["slots"]["layers"]["attn"]["wq"]
    assert isinstance(slot["vr"], DTensor) and isinstance(slot["vc"], DTensor)

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t
    for (path, a), (_, b) in zip(leaf_paths(plain), leaf_paths(sharded)):
        assert torch.equal(a.detach(), whole(b).detach()), path


@pytest.mark.gpu
def test_tensor_parallel_rank_share_flops_equal_the_cards():
    """``chip_smoke.py`` phase 17's rank share at a small cut:
    internlm2-1.8b at full width and 2 layers, train_4k's sequence at 2
    rows a rank, as rank 255 of a ``fake`` group of 256 over the
    pod16x16 mesh on the card (the tensor-parallel step on its shards,
    the collectives moving nothing): ``FlopCounterMode`` on the card
    equals ``count_step`` over ``meta`` tensors exactly, and the card's
    peak is within 25% of the count's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    model = build_model(dataclasses.replace(ARCHS["internlm2-1.8b"],
                                            n_layers=2))
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=32)
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device="cuda")
        step, args = dryrun.build_step(model, shape, mesh)
        counted = dryrun.count_step(step, args)
        step, args = dryrun.build_step(model, shape, mesh, device="cuda")
        assert step.design == "tensor-parallel"
        with FlopCounterMode(display=False) as flops:
            step(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(*args)
        peak = torch.cuda.max_memory_allocated()
        del step, args
    assert float(flops.get_total_flops()) == counted["flops_per_device"]
    assert abs(peak - counted["peak_bytes"]) <= 0.25 * counted["peak_bytes"]
