"""Device Eq. 3 in the port against the reference, on the CPU.

* ``prepare_gap_tables`` equals the reference's, array for array;
* ``gap_place_plain`` (the plain torch version of the CUDA kernel)
  against ``gap_place_call(..., interpret=True)`` on the same padded
  inputs.  Tolerance: one f32 spacing of the result.  XLA on the CPU
  contracts the reference's line ``base + (x - x0) * scale`` into an
  FMA, while torch (and the CUDA kernel, built with -fmad=false) rounds
  the product and the sum separately, so a row may differ by one
  rounding; the count of such rows is recorded.  The +inf padding rows
  are NaN on both sides;
* ``gap_positions_device(device="cpu")`` against the reference's and
  against the f64 oracle at the reference's tolerance (rtol 2e-5,
  atol 0.5), monotone, within the rho budget;
* the ordering the CUDA kernel's chunk brackets rest on: the f32 first
  keys of ``prepare_gap_tables`` non-decreasing and +inf padded, for
  narrow and wide keys, PGM and FITing, at rho 0.05, 0.15 and 0.3.

The cases are those of tests/test_kernels_gap_place.py, plus one key
set below 2^40.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import make_keys
from repro.core import mechanisms as ref_mech
from repro.kernels.gap_place import gap_place_call
from repro.kernels.ops import _pad_pow
from repro.kernels.ops_gap import gap_positions_device as ref_device
from repro.kernels.ops_gap import prepare_gap_tables as ref_tables
from repro_torch.core import mechanisms as port_mech
from repro_torch.kernels import gap_positions_device, gap_positions_oracle
from repro_torch.kernels.gap_place import gap_place, gap_place_plain
from repro_torch.kernels.ops_gap import prepare_gap_tables


def _keys(span_bits, n, seed):
    if span_bits == 22:
        return make_keys("uniform_int", n, seed=seed)
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, 2 ** span_bits, n)).astype(np.float64)


def _plms(name, kw, x):
    """The same mechanism fitted by each package on the same keys."""
    y = np.arange(x.size, dtype=np.float64)
    cls = {"pgm": "PGMMechanism", "fiting": "FITingMechanism"}[name]
    port = getattr(port_mech, cls)(**kw).fit(x, y).plm
    ref = getattr(ref_mech, cls)(**kw).fit(x, y).plm
    return port, ref


# (name, mechanism, kwargs, rho, key_tile, seg_chunk, key bits, n, seed)
CASES = [
    ("pgm_rho0.05", "pgm", dict(eps=64, recursive=False), 0.05, 1024, 512,
     22, 20_000, 1),
    ("pgm_rho0.3", "pgm", dict(eps=64, recursive=False), 0.3, 1024, 512,
     22, 20_000, 1),
    ("fiting_rho0.05", "fiting", dict(eps=64), 0.05, 1024, 512,
     22, 20_000, 1),
    ("fiting_rho0.3", "fiting", dict(eps=64), 0.3, 1024, 512,
     22, 20_000, 1),
    ("tile_256_128", "pgm", dict(eps=32, recursive=False), 0.2, 256, 128,
     22, 9_000, 2),
    ("tile_2048_1024", "pgm", dict(eps=32, recursive=False), 0.2, 2048,
     1024, 22, 9_000, 2),
    ("wide_2e40", "pgm", dict(eps=64, recursive=False), 0.15, 1024, 512,
     40, 60_000, 3),
]
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prepare_gap_tables_equal_reference(case):
    _, mech, kw, rho, _kt, seg_chunk, bits, n, seed = case
    x = _keys(bits, n, seed)
    y = np.arange(x.size, dtype=np.float64)
    port, ref = _plms(mech, kw, x)
    mine = prepare_gap_tables(x, y, port, rho, seg_chunk)
    want = ref_tables(x, y, ref, rho, seg_chunk)
    assert len(mine) == len(want) == 4
    for m, w in zip(mine, want):
        assert m.dtype == w.dtype == np.float32
        assert np.array_equal(m, w)
        assert m.shape[0] % seg_chunk == 0


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_matches_pallas_interpret(case, record_property):
    _, mech, kw, rho, key_tile, seg_chunk, bits, n, seed = case
    x = _keys(bits, n, seed)
    y = np.arange(x.size, dtype=np.float64)
    port, ref = _plms(mech, kw, x)
    tables = prepare_gap_tables(x, y, port, rho, seg_chunk)
    xp = _pad_pow(x.astype(np.float32), key_tile, np.float32(np.inf))
    assert xp.size > x.size  # the batch carries +inf padding rows
    args = [torch.from_numpy(a) for a in (xp, *tables)]
    tiling = dict(key_tile=key_tile, seg_chunk=seg_chunk)
    mine = gap_place_plain(*args, **tiling)
    # the wrapper takes the plain version for CPU tensors, unlaunched
    launches = gap_place.launches
    assert torch.equal(gap_place(*args, **tiling).isnan(), mine.isnan())
    assert gap_place.launches == launches
    want = np.asarray(gap_place_call(*[jnp.asarray(a) for a in (xp, *tables)],
                                     interpret=True, **tiling))
    mine = mine.numpy()
    assert mine.dtype == want.dtype == np.float32
    real = slice(0, x.size)
    assert np.isnan(mine[x.size:]).all() and np.isnan(want[x.size:]).all()
    assert np.isfinite(mine[real]).all()
    spacing = np.spacing(np.abs(want[real]))
    assert np.all(np.abs(mine[real] - want[real]) <= spacing)
    n_diff = int(np.count_nonzero(mine[real] != want[real]))
    record_property("rows_one_rounding_apart", n_diff)
    assert n_diff <= x.size


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gap_positions_device_matches_reference_and_oracle(case):
    _, mech, kw, rho, key_tile, seg_chunk, bits, n, seed = case
    x = _keys(bits, n, seed)
    port, ref = _plms(mech, kw, x)
    tiling = dict(key_tile=key_tile, seg_chunk=seg_chunk)
    dev = gap_positions_device(x, port, rho, device="cpu", **tiling)
    want = ref_device(x, ref, rho, interpret=True, **tiling)
    ora = gap_positions_oracle(x, port, rho)
    assert dev.dtype == np.float64 and dev.shape == x.shape
    # one f32 rounding of the line (the FMA finding), after the max
    spacing = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(dev - want) <= spacing)
    np.testing.assert_allclose(dev, ora, rtol=2e-5, atol=0.5)
    assert np.all(np.diff(dev) >= 0)
    # budget: total inserted gaps <= rho * n (+ rounding)
    assert dev[-1] - (x.size - 1) <= rho * x.size + 1.0


def test_gap_positions_device_default_is_cuda(monkeypatch):
    x = make_keys("uniform_int", 2_000, seed=4)
    plm = port_mech.PGMMechanism(eps=32, recursive=False).fit(
        x, np.arange(x.size, dtype=np.float64)).plm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gap_positions_device(x, plm, 0.2)


TABLE_CASES = [(m, bits, rho) for m in ("pgm", "fiting") for bits in (22, 40)
               for rho in (0.05, 0.15, 0.3)]


@pytest.mark.parametrize("mech,bits,rho", TABLE_CASES, ids=[
    f"{m}-{'narrow' if b == 22 else 'wide'}-rho{r}"
    for m, b, r in TABLE_CASES])
def test_gap_table_first_keys_sorted_and_padded(mech, bits, rho):
    """``csrc/gap_place.cu`` brackets a chunk's segments by its least and
    greatest key: the f32 first keys of ``prepare_gap_tables`` must be
    non-decreasing and +inf padded (the other tables 0 padded), for
    narrow and wide keys, PGM and FITing, at each rho."""
    x = _keys(bits, 30_000, 6)
    kw = dict(eps=32) if mech == "fiting" else dict(eps=32, recursive=False)
    port, _ = _plms(mech, kw, x)
    segk, base, x0, scale = prepare_gap_tables(
        x, np.arange(x.size, dtype=np.float64), port, rho, 512)
    k = port.n_segments
    assert segk.dtype == np.float32 and segk.size % 512 == 0
    assert np.all(segk[:-1] <= segk[1:])
    assert np.isfinite(segk[:k]).all() and np.isposinf(segk[k:]).all()
    assert np.array_equal(segk[:k], port.seg_first_key.astype(np.float32))
    for t in (base, x0, scale):
        assert t.size == segk.size and not t[k:].any()
    # every key routes to a real row
    cnt = np.searchsorted(segk, x.astype(np.float32), side="right")
    assert cnt.min() >= 1 and cnt.max() <= k
