"""The port's legacy lookup stages on the CPU against the reference.

* ``lookup_kernel_plain`` (the plain torch version of the CUDA legacy
  kernel) against ``lookup_kernel_call(..., interpret=True)`` on one
  shared ``tile_block``, over the three tile shapes of
  tests/test_kernels_lookup.py: slot, found and fb bit for bit; pred
  within one f32 spacing (XLA on the CPU may contract ``sl * (q - fk)
  + ic`` into an FMA, torch rounds the product and the sum
  separately), NaN on both sides for the +inf padding rows;
* ``batched_lookup(backend="pallas" | "xla" | "oracle")`` equals the
  reference's in payload, slot and found, bit for bit, over PGM,
  FITing and RMI, rho 0 and 0.2, narrow and wide keys, flat and bisect
  mode and int64 payloads.  The fallback counts may differ where the
  tile schedule's prediction rounds differently (the same FMA caveat);
  they agree within 0.5% of the batch;
* the overflow-to-oracle escape of tests/test_query_engine.py;
* ``QueryEngine``'s xla -> oracle downgrade and ``force_backend``, and
  its legacy stages against the reference's engine.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import make_keys
from repro.core import Index as RefIndex
from repro.kernels import batched_lookup as ref_batched_lookup
from repro.kernels import from_learned_index as ref_freeze
from repro.kernels import ops as ref_ops
from repro.kernels.lookup import lookup_kernel_call
from repro.kernels.ops import QueryEngine as RefEngine
from repro_torch.core import Index
from repro_torch.kernels import freeze, ops
from repro_torch.kernels.bounds import _flat_width
from repro_torch.kernels.lookup import lookup_kernel, lookup_kernel_plain
from repro_torch.kernels.ref import predict_ref

MAX_FB_DIFF = 0.005


def _mixed_queries(rng, keys, n_hit=1500, n_miss=400):
    lo, hi = keys[0], keys[-1]
    miss = np.setdiff1d(np.round(rng.uniform(lo, hi, 4 * n_miss)),
                        keys)[:n_miss]
    return np.concatenate([rng.choice(keys, n_hit), miss,
                           [keys[0] - 10.0, keys[-1] + 10.0]])


def _both(keys, method="pgm", gap_rho=0.2, payloads=None, **kw):
    args = dict(method=method, gap_rho=gap_rho, payloads=payloads, **kw)
    ref = RefIndex.build(keys, **args)
    port = Index.build(keys, device="cpu", **args)
    return ref, port


def _assert_same(got, want, label=""):
    for g, w, f in zip(got[:3], want[:3], ("payloads", "slots", "found")):
        assert np.array_equal(np.asarray(g), np.asarray(w)), (label, f)


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_tile,w_tile,win_chunk", [
    (128, 512, 128),
    (256, 2048, 512),
    (512, 4096, 1024),
])
def test_plain_matches_pallas_interpret(q_tile, w_tile, win_chunk):
    keys = make_keys("uniform_int", 20_000, seed=3)
    port = Index.build(keys, method="pgm", eps=32, device="cpu")
    a = freeze.from_learned_index(port, "cpu", w_tile=w_tile)
    rng = np.random.default_rng(4)
    q = np.sort(np.concatenate([
        rng.choice(keys, 1000),
        np.setdiff1d(np.round(rng.uniform(keys[0], keys[-1], 600)), keys),
        keys[0] - 1.0 - np.arange(20.0),          # below every key
        keys[-1] + 1.0 + np.arange(20.0)]))       # above every key
    n_real = q.size
    qp = np.concatenate([q, np.full((-n_real) % q_tile + q_tile, np.inf)])
    qs = torch.from_numpy(qp.astype(np.float32))
    # the pallas stage's tile schedule, then windows at the first and the
    # last block pair on two tiles
    err_lo = ops._pad_bounds(port.mech.plm.err_lo,
                             a.seg_first_key.shape[0], "cpu")
    y_hat, seg = predict_ref(qs, a.seg_first_key, a.seg_slope, a.seg_icept)
    lo = ops._clip(y_hat + err_lo[seg] - 1.0,
                   ops._slot_clip_hi(a.n_slots))
    tile_block = ops.tile_blocks(lo, a, q_tile=q_tile, w_tile=w_tile)
    max_block = a.slot_key.shape[0] // w_tile - 2
    assert max_block >= 1
    tile_block[0] = max_block
    tile_block[-2] = 0
    args = (qs, tile_block, a.seg_first_key, a.seg_slope, a.seg_icept,
            a.slot_key)
    tiling = dict(q_tile=q_tile, w_tile=w_tile, seg_chunk=512,
                  win_chunk=win_chunk)
    mine = lookup_kernel_plain(*args, **tiling)
    launches = lookup_kernel.launches
    via_wrapper = lookup_kernel(*args, **tiling)
    assert lookup_kernel.launches == launches
    for m, v in zip(mine[:3], via_wrapper[:3]):
        assert torch.equal(m, v)
    want = lookup_kernel_call(*[jnp.asarray(t.numpy()) for t in args],
                              interpret=True, **tiling)
    want = [np.asarray(w) for w in want]
    mine = [m.numpy() for m in mine]
    for name, m, w in zip(("slot", "found", "fb"), mine[:3], want[:3]):
        assert m.dtype == w.dtype, name
        assert np.array_equal(m, w), name
    pm, pw = mine[3], want[3]
    assert pm.dtype == pw.dtype == np.float32
    nan = np.isnan(pw)
    assert np.array_equal(np.isnan(pm), nan) and nan[n_real:].all()
    assert np.all(np.abs(pm[~nan] - pw[~nan])
                  <= np.spacing(np.abs(pw[~nan])))
    # the shape exercises both window edges and the escape flags
    assert mine[2][:n_real].any() and mine[1][:n_real].any()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(64)
    tb = torch.zeros(2, dtype=torch.int32)
    tab = torch.zeros(512)
    sk = torch.zeros(4096)
    lookup_kernel(q, tb, tab, tab, tab, sk, q_tile=32, w_tile=2048)
    with pytest.raises(ValueError, match="q_tile"):
        lookup_kernel(q[:40], tb, tab, tab, tab, sk, q_tile=32, w_tile=2048)
    with pytest.raises(ValueError, match="w_tile"):
        lookup_kernel(q, tb, tab, tab, tab, sk[:3000], q_tile=32,
                      w_tile=2048)
    with pytest.raises(TypeError, match="int32"):
        lookup_kernel(q, tb.long(), tab, tab, tab, sk, q_tile=32,
                      w_tile=2048)
    # a window wider than shared memory is taken: the kernel stages only
    # a tile's slice, and searches a slice too wide for its buffer in
    # place
    slot, found, fb, pred = lookup_kernel(
        q, tb, tab, tab, tab, torch.zeros(2 ** 16), q_tile=32,
        w_tile=2 ** 15, win_chunk=512)
    assert slot.shape == found.shape == fb.shape == pred.shape == (64,)


# ---------------------------------------------------------------------------
# batched_lookup on the legacy stages
# ---------------------------------------------------------------------------

# (name, method, mechanism kwargs, gap_rho, key bits, int64 payloads);
# the name ends in the search mode the error bounds select (a gapped
# build's windows are narrow: flat rank count; a gapless PGM / FITing
# build's are ~2 eps wide: the fixed-trip bisect)
CASES = [
    ("pgm_rho0_bisect", "pgm", dict(eps=64), 0.0, 22, False),
    ("pgm_rho0.2_flat", "pgm", dict(eps=64), 0.2, 22, False),
    ("fiting_rho0_bisect", "fiting", dict(eps=64), 0.0, 22, False),
    ("fiting_rho0.2_flat", "fiting", dict(eps=64), 0.2, 22, False),
    ("rmi_rho0_flat", "rmi", dict(n_leaf=512), 0.0, 22, False),
    ("rmi_rho0.2_flat", "rmi", dict(n_leaf=512), 0.2, 22, False),
    ("wide_rho0_bisect", "pgm", dict(eps=64), 0.0, 40, False),
    ("wide_rho0.2_flat", "pgm", dict(eps=64), 0.2, 40, False),
    ("i64_payloads_flat", "pgm", dict(eps=64), 0.2, 22, True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_batched_lookup_matches_reference(case):
    name, method, kw, rho, bits, i64 = case
    rng = np.random.default_rng(len(name) * 7 + bits)
    keys = np.unique(rng.choice(2 ** bits, 15_000, replace=False)
                     ).astype(np.float64)
    payloads = ((np.int64(3) << 40) + np.arange(keys.size, dtype=np.int64)
                if i64 else None)
    ref, port = _both(keys, method=method, gap_rho=rho, payloads=payloads,
                      **kw)
    plm = port.mech.plm
    flat = _flat_width(plm.err_lo, plm.err_hi)
    assert (flat > 0) == name.endswith("_flat")
    arrs = freeze.from_learned_index(port, "cpu")
    ref_arrs = ref_freeze(ref)
    assert arrs.key_wide == (bits > 24) and arrs.wide == i64
    q = rng.permutation(_mixed_queries(rng, keys))
    truth = port.lookup(q, backend="numpy-oracle").payloads
    for be in ("pallas", "xla", "oracle"):
        got = ops.batched_lookup(arrs, plm.err_lo, q, backend=be,
                                 err_hi_by_seg=plm.err_hi)
        want = ref_batched_lookup(ref_arrs, ref.mech.plm.err_lo, q,
                                  backend=be,
                                  err_hi_by_seg=ref.mech.plm.err_hi,
                                  interpret=True)
        assert got[0].dtype == np.int64
        _assert_same(got, want, be)
        assert np.array_equal(got[0], truth), be
        assert abs(int(got[3]) - int(want[3])) <= MAX_FB_DIFF * q.size, be


def test_default_backend_is_the_legacy_kernel(monkeypatch):
    keys = make_keys("uniform_int", 12_000, seed=5)
    ref, port = _both(keys)
    arrs = freeze.from_learned_index(port, "cpu")
    q = np.random.default_rng(5).choice(keys, 1500)
    calls = []
    real = ops.pallas_search
    monkeypatch.setattr(ops, "pallas_search",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = ops.batched_lookup(arrs, port.mech.plm.err_lo, q)
    oracle = ops.batched_lookup(arrs, port.mech.plm.err_lo, q,
                                use_kernel=False)
    assert calls == [1]
    want = ref_batched_lookup(ref_freeze(ref), ref.mech.plm.err_lo, q,
                              interpret=True)
    _assert_same(got, want)
    _assert_same(oracle, want)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.batched_lookup(arrs, port.mech.plm.err_lo, q, backend="cuda")


@pytest.mark.parametrize("seed", [0, 1])
def test_overflow_escapes_to_the_oracle(seed):
    """Broken bounds flag (almost) every query: the compaction buffer
    overflows and the batch re-runs on the oracle stage, exactly."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5_000, 25_000))
    keys = make_keys("uniform_int", n, seed=seed)
    ref, port = _both(keys, eps=64)
    arrs = freeze.from_learned_index(port, "cpu")
    plm = port.mech.plm
    q = _mixed_queries(rng, keys)
    out_o, slot_o, found_o, _ = ops.batched_lookup(arrs, plm.err_lo, q,
                                                   backend="oracle")
    for be in ("xla", "pallas"):
        ops._ESCAPES.count = 0
        ref_ops._ESCAPES.count = 0
        got = ops.batched_lookup(arrs, plm.err_lo + 1e6, q, backend=be,
                                 err_hi_by_seg=plm.err_hi + 1e6,
                                 fb_frac=0.001)
        want = ref_batched_lookup(ref_freeze(ref), plm.err_lo + 1e6, q,
                                  backend=be,
                                  err_hi_by_seg=plm.err_hi + 1e6,
                                  fb_frac=0.001, interpret=True)
        assert ops._ESCAPES.count == 1 == ref_ops._ESCAPES.count, be
        _assert_same(got, (out_o, slot_o, found_o), be)
        _assert_same(got, want, be)


# ---------------------------------------------------------------------------
# QueryEngine
# ---------------------------------------------------------------------------

def test_engine_xla_downgrade_and_force_backend():
    keys = make_keys("uniform_int", 20_000, seed=8)
    ref, port = _both(keys, eps=64, gap_rho=0.15)
    r_eng = RefEngine.from_index(ref, fused_impl="pallas", interpret=True)
    eng = ops.QueryEngine.from_index(port, "cpu")
    assert eng.backend == "fused" and eng.xla_min_bucket == 8192
    rng = np.random.default_rng(8)
    for kw in (dict(force_backend=True), dict()):
        q = rng.choice(keys, 512)
        got = eng.lookup(q, backend="xla", **kw)
        want = r_eng.lookup(q, backend="xla", **kw)
        _assert_same(got, want, kw)
        assert eng.last_stage == r_eng.last_stage
        assert np.array_equal(got[0], port.gapped.lookup_batch(q))
    assert eng.last_stage == "oracle"  # the non-forced request
    eng.lookup(rng.choice(keys, 512), backend="xla", force_backend=True)
    assert eng.last_stage == "xla"
    with pytest.raises(ValueError, match="unknown backend"):
        eng.lookup(keys[:4], backend="cuda")


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_engine_legacy_stages_match_reference_engine(wide):
    rng = np.random.default_rng(9 + wide)
    span = 2 ** 40 if wide else 2 ** 22
    keys = np.unique(rng.choice(span, 15_000, replace=False)
                     ).astype(np.float64)
    ref, port = _both(keys, eps=64, gap_rho=0.15)
    r_eng = RefEngine.from_index(ref, fused_impl="pallas", interpret=True)
    eng = ops.QueryEngine.from_index(port, "cpu")
    for backend, n_q in (("pallas", 2048), ("pallas", 9000),
                         ("xla", 9000)):
        q = _mixed_queries(rng, keys, n_hit=n_q - 402, n_miss=400)
        got = eng.lookup(q, backend=backend)
        want = r_eng.lookup(q, backend=backend)
        _assert_same(got, want, (backend, n_q))
        assert eng.last_stage == r_eng.last_stage, (backend, n_q)
        assert abs(got[3] - int(want[3])) <= MAX_FB_DIFF * q.size
        assert np.array_equal(got[0], port.gapped.lookup_batch(q))
    assert eng.last_stage == "xla"
    # wide keys route the legacy kernel to the xla stage, which a small
    # bucket then downgrades to the oracle stage
    eng.lookup(rng.choice(keys, 2048), backend="pallas")
    assert eng.last_stage == ("oracle" if wide else "pallas")
    assert eng.stats["calls"] == 4
