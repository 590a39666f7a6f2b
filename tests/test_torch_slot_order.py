"""The invariant the CUDA kernels' searches rest on, and the launch
shapes their wrappers compute, checked on the CPU.

``csrc/ingest_place.cu`` finds ``ub`` and ``pv`` by searches that start
at the predicted slot, and ``csrc/fused_lookup.cu`` (whole-window mode)
and ``csrc/ingest_place.cu`` (segment routing) count by bisects, where
the plain versions bisect the whole array or count literally.  Both give
the same index only if the device keys are non-decreasing in (hi, lo)
pair order: the slot keys over all of ``[0, Mpad)`` (a gap carries its
right neighbour's key; the tail and the padding are +inf) and the
segment first keys over ``[0, Kpad)``; and each slot's CSR chain of
link keys strictly increasing.  Every test here holds the
port's device images to that after a build and freeze, after delta
syncs that follow insert, delete and update batches, after the
two-dispatch ingest, and after a fused ingest's commit and split
commit, for narrow and wide keys, PGM and FITing.

``fused_launch_shape`` is the launch configuration ``fused_lookup``
computes in Python: tiles per CTA and dynamic shared memory, held
within the card's limits for every shape the engine can produce.

``csrc/lookup_kernel.cu`` and ``csrc/gap_place.cu`` search each tile or
chunk only inside the brackets its least and greatest key give, which
holds for the legacy narrow freeze's non-decreasing slot keys and
segment first keys (checked at w_tile 512, 2048, 4096); the card
tests' bracket cases are checked here to reach the paths they are
named for (``lookup_kernel_brackets``, ``gap_place_brackets``), and
the brackets to hold every key's count.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Index
from repro_torch.kernels import freeze, gap_place, lookup
from test_torch_kernel_gpu import (GAP_CASES, LEGACY_CASES, gap_case_args,
                                   legacy_case_args)


def _nondecreasing(hi, lo):
    """True when the (hi, lo) pairs never step down (NaN fails)."""
    h = hi.cpu().numpy()
    l = lo.cpu().numpy() if lo.numel() else np.zeros_like(h)
    return bool(np.all((h[:-1] < h[1:])
                       | ((h[:-1] == h[1:]) & (l[:-1] <= l[1:]))))


def _chains_increase(a):
    """True when each slot's CSR chain of link keys strictly increases
    in pair order (the chain search counts the keys <= q)."""
    off = a.link_offsets.cpu().numpy().astype(np.int64)[:a.n_slots + 1]
    total = int(off[-1])
    if total < 2:
        return True
    h = a.link_keys.cpu().numpy()[:total]
    l = (a.link_keys_lo.cpu().numpy()[:total] if a.link_keys_lo.numel()
         else np.zeros_like(h))
    same = ~np.isin(np.arange(1, total), off)   # j and j + 1 share a chain
    up = (h[:-1] < h[1:]) | ((h[:-1] == h[1:]) & (l[:-1] < l[1:]))
    return bool(np.all(up[same]))


def _check_images(idx, when):
    a = idx._engine.arrays
    assert _nondecreasing(a.slot_key, a.slot_key_lo), \
        f"slot keys step down {when}"
    assert _nondecreasing(a.seg_first_key, a.seg_first_key_lo), \
        f"segment first keys step down {when}"
    assert _chains_increase(a), f"a chain's keys do not increase {when}"
    assert a.slot_key.shape[0] >= a.n_slots
    assert torch.isinf(a.slot_key[a.n_slots:]).all()


def _spread(keys, n):
    """Absent keys half-way between neighbours, spread over the range:
    one per gap run, so the fused gate can commit them."""
    mids = np.setdiff1d(keys[:-1] + np.rint(np.diff(keys) * 0.5), keys)
    return mids[:: max(1, len(mids) // n)][:n]


SEQ_CASES = [(m, span, seed) for m in ("pgm", "fiting")
             for span in (2 ** 22, 2 ** 40) for seed in (0, 1)]


@pytest.mark.parametrize("method,span,seed", SEQ_CASES, ids=[
    f"{m}-{'narrow' if s <= 2 ** 24 else 'wide'}-{seed}"
    for m, s, seed in SEQ_CASES])
def test_device_keys_stay_in_pair_order(method, span, seed):
    rng = np.random.default_rng(seed)
    allk = np.unique(rng.choice(span, 30_000, replace=False)
                     ).astype(np.float64)
    perm = rng.permutation(allk.size)
    init, held = np.sort(allk[perm[:22_000]]), allk[perm[22_000:]]
    idx = Index.build(init, method=method, eps=64, gap_rho=0.15,
                      rng=np.random.default_rng(seed), device="cpu")
    idx.sync_device()
    _check_images(idx, "after build + freeze")
    keys_wide = idx._engine.arrays.key_wide
    assert keys_wide == (span > 2 ** 24)

    # two-dispatch ingest: device placements, host partition, delta
    idx.fused_ingest_enabled = False
    labels = set()
    for n in (2048, 1024, 600):
        batch, held = held[:n], held[n:]
        rep = idx.ingest(batch, 1_000_000 + np.arange(n))
        labels.add((rep.device, rep.placement))
        _check_images(idx, f"after a two-dispatch ingest ({rep.device})")
    assert ("delta", "device") in labels

    # deletes (slot and chain keys) and payload updates, then a sync
    live = idx.gapped.slot_key[idx.gapped.occupied]
    dk = rng.choice(live, 700, replace=False)
    idx.remove(dk)
    idx.sync_device()
    _check_images(idx, "after a delete batch")
    uk = rng.choice(np.setdiff1d(live, dk), 500, replace=False)
    idx.update_batch(uk, 5 + np.arange(uk.size))
    idx.sync_device()
    _check_images(idx, "after an update batch")
    batch, held = held[:1024], held[1024:]
    idx.ingest(batch, 2_000_000 + np.arange(batch.size))
    _check_images(idx, "after an ingest that follows deletes")

    # fused ingest: a batch built to commit in-graph, then raw traffic
    idx.fused_ingest_enabled = True
    live = np.sort(np.concatenate([idx.gapped.slot_key[idx.gapped.occupied],
                                   idx.gapped.links.chain_keys]))
    good = np.setdiff1d(_spread(live, 1500), held)
    rep = idx.ingest(good, 3_000_000 + np.arange(good.size))
    _check_images(idx, f"after a fused ingest ({rep.device})")
    rep = idx.ingest(held[:2048], 4_000_000 + np.arange(2048))
    _check_images(idx, f"after a fused attempt on raw traffic "
                       f"({rep.device})")
    assert idx.stats.get("fused_ingests", 0) >= 1


@pytest.mark.parametrize("span,seed", [(2 ** 22, 3), (2 ** 40, 5)],
                         ids=["narrow", "wide"])
def test_device_keys_in_pair_order_after_split_commit(span, seed):
    """A fused commit, then a batch whose last row collides with its
    last slot candidate: the prefix commits in-graph and the rest
    replays through the host partition and a delta sync."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.choice(span, 25_000, replace=False)
                     ).astype(np.float64)
    idx = Index.build(keys, method="pgm", eps=64, gap_rho=0.2,
                      rng=np.random.default_rng(1), device="cpu")
    idx.fused_ingest_enabled = True
    idx.sync_device()
    batch = _spread(keys, 3_000)
    rep = idx.ingest(batch, 1_000_000 + np.arange(batch.size))
    assert rep.device == "fused"
    _check_images(idx, "after a fused commit")
    live = np.sort(np.concatenate([keys, batch]))
    clean = np.setdiff1d(live[:-1] + np.rint(np.diff(live) * 0.3), live)
    clean = clean[:: len(clean) // 2048][:2048]
    prims, _esc = idx._engine.ingest_place(clean)
    j = np.flatnonzero(prims["free"] & prims["bracket"])[-1]
    batch2 = np.concatenate([clean, [clean[j] + 1.0]])
    rep2 = idx.ingest(batch2, 2_000_000 + np.arange(batch2.size))
    assert rep2.placement == "device-split"
    assert idx.stats["split_commits"] == 1
    _check_images(idx, "after a split commit")


# ---------------------------------------------------------------------------
# fused_lookup's launch shape
# ---------------------------------------------------------------------------

_STATIC_SMEM = 128         # the kernel's warp counts (32 ints)
_SMEM_LIMIT = 232_448      # what one block may use on the H100 (227 KB)


def _engine_shapes():
    """Every (num_tiles, q_tile, w_tile, flat_w, key_wide) the engine
    can hand the kernel: q_tile a power of two in [32, 512]
    (``auto_q_tile``) or any multiple of 32 up to 1,024 the wrapper
    takes, w_tile from 256 to 16,384, flat_w 0 or a power of two from 8
    to 256 (``_flat_width`` / ``_fused_flat_width``), batches from one
    tile to 2^22 queries."""
    q_tiles = sorted({32, 64, 96, 128, 256, 512, 640, 1024})
    for q_tile in q_tiles:
        for w_tile in (256, 512, 1024, 2048, 4096, 8192, 16384):
            for flat_w in (0, 8, 16, 32, 64, 128, 256):
                for key_wide in (False, True):
                    for n_q in (q_tile, 4096, 1 << 16, 1 << 20, 1 << 22):
                        if n_q % q_tile == 0:
                            yield n_q // q_tile, q_tile, w_tile, flat_w, \
                                key_wide


def test_fused_launch_shape_fits_the_card():
    seen = 0
    for num_tiles, q_tile, w_tile, flat_w, key_wide in _engine_shapes():
        for n_sm in (132, 114):
            tiles, smem = lookup.fused_launch_shape(
                num_tiles, q_tile, w_tile, flat_w, key_wide, n_sm)
            assert tiles >= 1 and tiles * q_tile <= 1024
            assert tiles * q_tile <= max(256, q_tile)
            assert smem + _STATIC_SMEM <= _SMEM_LIMIT
            win = 2 * w_tile * (8 if key_wide else 4)
            if flat_w:
                assert smem == 0
            elif win + _STATIC_SMEM <= _SMEM_LIMIT:
                # whole-window mode stages one window per tile
                assert smem == tiles * win
            else:
                assert smem == 0   # bisected in place
            seen += 1
    assert seen > 1000


@pytest.mark.parametrize("n_q,q_tile,flat_w,key_wide,want", [
    (1 << 20, 32, 32, True, (8, 0)),         # the read cell: 8 warps
    (4096, 32, 32, True, (1, 0)),            # serving batch: spread out
    (1 << 16, 32, 32, False, (3, 0)),        # 2,048 tiles over 132 SMs
    (1 << 20, 256, 32, True, (1, 0)),        # one 8-warp tile per CTA
    (1 << 20, 32, 0, False, (4, 4 * 16384)),  # whole window, narrow
    (1 << 20, 32, 0, True, (2, 2 * 32768)),   # whole window, wide
    (1 << 20, 512, 0, True, (1, 32768)),
])
def test_fused_launch_shape_at_engine_shapes(n_q, q_tile, flat_w, key_wide,
                                             want):
    assert lookup.fused_launch_shape(n_q // q_tile, q_tile, 2048, flat_w,
                                     key_wide, 132) == want


# ---------------------------------------------------------------------------
# the legacy kernel's and the Eq. 3 kernel's brackets
# ---------------------------------------------------------------------------

LEGACY_FREEZE = [(m, w) for m in ("pgm", "fiting") for w in (512, 2048, 4096)]


@pytest.mark.parametrize("method,w_tile", LEGACY_FREEZE,
                         ids=[f"{m}-w{w}" for m, w in LEGACY_FREEZE])
def test_legacy_freeze_keys_nondecreasing(method, w_tile):
    """``csrc/lookup_kernel.cu`` brackets a tile's ranks and segments by
    its least and greatest query: the narrow freeze it reads (keys below
    2^24, gap runs from an insert batch) must have non-decreasing slot
    keys and segment first keys, +inf padded, at each w_tile."""
    rng = np.random.default_rng(w_tile)
    keys = np.unique(rng.choice(2 ** 24, 20_000, replace=False)
                     ).astype(np.float64)
    idx = Index.build(keys, method=method, eps=64, gap_rho=0.15,
                      rng=np.random.default_rng(0), device="cpu")
    idx.gapped.insert_batch(_spread(keys, 1500),
                            5_000_000 + np.arange(1500))
    a = freeze.from_learned_index(idx, "cpu", w_tile=w_tile)
    assert not a.key_wide
    sk, segk = a.slot_key.numpy(), a.seg_first_key.numpy()
    assert sk.size % w_tile == 0 and sk.size >= 2 * w_tile
    assert np.all(sk[:-1] <= sk[1:]) and np.all(segk[:-1] <= segk[1:])
    # trailing gaps and the padding read +inf
    assert np.isfinite(sk[0]) and np.isposinf(sk[a.n_slots:]).all()
    n_seg = idx.mech.plm.n_segments
    assert np.isinf(segk[n_seg:]).all() and np.isfinite(segk[:n_seg]).all()
    # equal neighbours (gap runs) are present: the bracket must hold them
    assert np.any(sk[:a.n_slots - 1] == sk[1:a.n_slots])


def _tile_has(case, start, r_lo, r_hi, q, sk, base, w):
    """Whether some tile of a ``legacy_case_args`` case reaches what the
    case is for."""
    two_w = 2 * w
    width = r_hi - start
    if case == "below_above":
        return (bool(((r_hi == 0) & (base > 0)).any())
                and bool((r_lo == two_w).any()))
    if case == "all_padding":
        return bool(torch.isinf(q).all(dim=1).any())
    if case == "whole_window":
        return bool(((r_lo == 0) & (r_hi == two_w)).any()) and bool(
            (width > lookup.LEGACY_SLICE_CAP).any())
    if case == "gap_edges":     # the exact bracket's edges fall in runs
        hit = False
        for t in range(q.shape[0]):
            win = sk[int(base[t]):int(base[t]) + two_w]
            lo, hi = int(r_lo[t]), int(r_hi[t])
            if 0 < lo and hi < two_w and hi - lo >= 2:
                hit |= bool(win[lo] == win[lo + 1]
                            and win[hi - 1] == win[hi - 2])
        return hit
    if case == "unsorted":
        qs = torch.where(q.isnan(), float("inf"), q)
        return (bool((qs[:, 1:] < qs[:, :-1]).any())
                and bool(q.isnan().any()))
    raise ValueError(case)


@pytest.mark.parametrize("case", LEGACY_CASES)
def test_legacy_kernel_cases_reach_their_brackets(case):
    """The card tests' legacy-kernel cases (tests/test_torch_kernel_gpu.py)
    reach the paths they are named for, by ``lookup_kernel_brackets``
    on the same inputs; and the brackets hold every query's rank and
    segment count, by the plain version on the CPU."""
    q_tile, w_tile = 128, 2048
    args = legacy_case_args(case, "cpu")
    qt, tb, segk, _slope, _icept, sk = args
    tiling = dict(q_tile=q_tile, w_tile=w_tile)
    base = tb.long().clamp(0, sk.shape[0] // w_tile - 2) * w_tile
    q = qt.view(-1, q_tile)
    exact = lookup.lookup_kernel_brackets(qt, tb, segk, sk, slack=0,
                                          **tiling)
    assert _tile_has(case, *exact[:3], q, sk, base, w_tile)
    # the kernel's brackets: at most the slack wider at each end
    start, r_lo, r_hi, seg_lo, seg_hi = lookup.lookup_kernel_brackets(
        qt, tb, segk, sk, **tiling)
    slack = lookup.LEGACY_RANK_SLACK
    assert bool(((r_lo <= exact[1]) & (r_lo >= exact[1] - slack)
                 & (r_hi >= exact[2]) & (r_hi <= exact[2] + slack)).all())
    slot, _found, _fb, _pred = lookup.lookup_kernel(
        *args, q_tile=q_tile, w_tile=w_tile)
    rank = (slot.long() + 1 - base.repeat_interleave(q_tile)).view(-1,
                                                                   q_tile)
    cnt = torch.searchsorted(segk, qt, right=True).view(-1, q_tile)
    real = ~q.isnan()
    assert bool(((rank >= r_lo[:, None]) & (rank <= r_hi[:, None]))[real]
                .all())
    assert bool(((cnt >= seg_lo[:, None]) & (cnt <= seg_hi[:, None]))[real]
                .all())


def test_legacy_kernel_cases_tiles_mostly_in_one_segment():
    """Ordinary tiles of the cases route with no segment search: their
    least and greatest query share a segment count."""
    seen = same = 0
    for case in LEGACY_CASES:
        qt, tb, segk, _s, _i, sk = legacy_case_args(case, "cpu")
        _, _, _, lo, hi = lookup.lookup_kernel_brackets(
            qt, tb, segk, sk, q_tile=128, w_tile=2048)
        seen += lo.numel()
        same += int((lo == hi).sum())
    assert same >= seen // 2


@pytest.mark.parametrize("case", GAP_CASES)
def test_gap_place_cases_reach_their_brackets(case):
    """The card tests' Eq. 3 cases reach the paths they are named for,
    by ``gap_place_brackets`` on the same inputs; and the chunk
    brackets hold every real key's segment count."""
    args, n_real = gap_case_args(case, "cpu")
    x, segk = args[0], args[1]
    lo, hi = gap_place.gap_place_brackets(x, segk)
    n, k_pad, chunk = x.shape[0], segk.shape[0], gap_place.GAP_CHUNK
    rows = torch.minimum(hi, torch.tensor(k_pad - 1)) \
        - (lo - 1).clamp(min=0) + 1
    if case == "shuffled":
        assert bool((rows > gap_place.GAP_ROW_CAP).all())
    elif case == "shuffled_few":
        assert bool(((lo < hi) & (rows <= gap_place.GAP_ROW_CAP)).all())
    elif case == "one_segment":
        assert int(torch.isfinite(segk).sum()) == 1
        assert bool((lo == hi).all())
    elif case == "below_first":
        assert int(hi[0]) == 0
    elif case == "padding_mid_chunk":
        assert n_real % chunk and n % chunk and n_real < n
        assert int(hi[n_real // chunk]) == k_pad
    elif case == "ragged":
        assert n % 4 and n % chunk and n_real == n
    elif case == "unaligned":
        assert x.data_ptr() % 16 == 4
    cnt = torch.searchsorted(segk, x[:n_real], right=True)
    ci = torch.arange(n_real) // chunk
    assert bool(((cnt >= lo[ci]) & (cnt <= hi[ci])).all())
