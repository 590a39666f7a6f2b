"""``ingest_place_plain`` (the plain torch version of the port's CUDA
ingest-place kernel) against the reference's TPU kernel
``ingest_place_call(..., interpret=True)`` on identical inputs, and the
escape-patched primitives against the host oracle
``GappedArray.placement_primitives``.

Tolerance: raw ``p``, ``pv``, ``ub`` and ``flags`` are compared bit for
bit.  XLA on the CPU may contract a product and a sum of the pair
arithmetic into one FMA where torch rounds them separately, which can
move a prediction that sits on a rounding boundary; such a row must
carry the escape flag on at least one side, and at most 0.5% of a batch
may differ.  After the host patch of escape rows the primitives are
exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import Index as RefIndex
from repro.kernels import from_learned_index as ref_freeze
from repro.kernels import ops_gap as ref_ops_gap
from repro.kernels.gap_place import ingest_place_call
from repro_torch.core import Index
from repro_torch.kernels import freeze, gap_place, ops_gap

MAX_ROW_DIFF = 0.005


def _pair(span, method, seed, n=25_000):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.choice(span, n, replace=False)).astype(np.float64)
    kw = dict(method=method, eps=64, gap_rho=0.2)
    ref = RefIndex.build(keys, rng=np.random.default_rng(seed), **kw)
    port = Index.build(keys, rng=np.random.default_rng(seed), device="cpu",
                       **kw)
    # chains, so the bracket reads chain maxima
    mids = np.setdiff1d(keys[:-1] + np.rint(np.diff(keys) * 0.5),
                        keys)[:3000]
    for idx in (ref, port):
        idx.gapped.insert_batch(mids, 7_000_000 + np.arange(mids.size))
        idx.sync_device()
    return keys, ref, port, rng


def _batch(keys, ga, rng, n=4000):
    """Absent keys: random gaps, keys next to chained slots, below the
    first slot and above the last."""
    live = np.sort(np.concatenate([keys, ga.links.chain_keys]))
    cand = np.setdiff1d(np.floor(rng.uniform(keys[0], keys[-1], 2 * n)),
                        live)
    ck = ga.links.chain_keys
    near_chain = np.setdiff1d(np.concatenate([ck + 1.0, ck - 1.0]), live)
    edges = np.array([keys[0] - 1.0, keys[0] - 977.0, keys[-1] + 1.0,
                      keys[-1] + 12_345.0])
    out = np.unique(np.concatenate(
        [rng.permutation(cand)[:n - 500],
         rng.permutation(near_chain)[:496], edges]))
    return rng.permutation(out)


def _tables(arrays):
    """The reference kernel's 13 inputs (zero lo tables when narrow)."""
    a = arrays
    zeros = jnp.zeros_like
    wide = a.key_wide
    return (a.seg_first_key, a.seg_first_key_lo if wide
            else zeros(a.seg_first_key), a.seg_slope, a.seg_slope_lo,
            a.seg_icept, a.seg_icept_lo, a.slot_key,
            a.slot_key_lo if wide else zeros(a.slot_key), a.link_offsets,
            a.link_keys, a.link_keys_lo if wide else zeros(a.link_keys))


def _port_tables(arrays):
    a = arrays
    return (a.seg_first_key, a.seg_first_key_lo, a.seg_slope,
            a.seg_slope_lo, a.seg_icept, a.seg_icept_lo, a.slot_key,
            a.slot_key_lo, a.link_offsets, a.link_keys, a.link_keys_lo)


CASES = [(2 ** 22, "pgm", 0), (2 ** 40, "pgm", 1), (2 ** 22, "fiting", 2),
         (2 ** 40, "fiting", 3)]


@pytest.mark.parametrize("span,method,seed", CASES,
                         ids=[f"{'wide' if c[0] > 2 ** 24 else 'narrow'}-"
                              f"{c[1]}" for c in CASES])
def test_plain_matches_pallas_interpret(span, method, seed):
    keys, ref, port, rng = _pair(span, method, seed)
    batch = _batch(keys, port.gapped, rng)
    ra, pa = ref._engine.arrays, port._engine.arrays
    assert pa.key_wide == (span > 2 ** 24) and pa.link_keys.shape[0] > 0
    x_hi, x_lo = freeze.split_key_pair(batch)
    n, n_pad = batch.size, 4096
    xh = np.concatenate([x_hi, np.full(n_pad - n, np.inf, np.float32)])
    xl = np.concatenate([x_lo, np.zeros(n_pad - n, np.float32)])
    want = ingest_place_call(jnp.asarray(xh), jnp.asarray(xl), *_tables(ra),
                             key_tile=512, n_slots=ra.n_slots,
                             interpret=True)
    got = gap_place.ingest_place(torch.from_numpy(xh), torch.from_numpy(xl),
                                 *_port_tables(pa), n_slots=pa.n_slots)
    want = [np.asarray(w)[:n] for w in want]
    got = [g.numpy()[:n] for g in got]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
    diff = np.zeros(n, bool)
    for g, w in zip(got, want):
        diff |= g != w
    esc = ((got[3] | want[3]) & 4) != 0
    assert not np.any(diff & ~esc), np.flatnonzero(diff & ~esc)[:10]
    assert diff.sum() <= MAX_ROW_DIFF * n
    # the batch reaches every edge the kernel has
    ub = got[2]
    assert ub.min() == -1
    assert ub.max() == np.flatnonzero(port.gapped.occupied)[-1]
    assert np.any(got[3] & 1) and np.any(got[3] & 2)

    # through the wrappers: escape-patched primitives == host oracle
    prims, esc_p = ops_gap.ingest_place(pa, batch)
    rprims, esc_r = ref_ops_gap.ingest_place(ra, batch, impl="pallas",
                                             interpret=True)
    host = port.gapped.placement_primitives(batch)
    for f in host:
        same = prims[f] == rprims[f]
        assert np.all(same | esc_p | esc_r), f
        prims[f][esc_p] = host[f][esc_p]
        assert np.array_equal(prims[f], host[f]), f
    assert np.array_equal(host["p"],
                          ref.gapped.placement_primitives(batch)["p"])


def test_empty_link_table_reads_one_inf_row():
    """An index frozen without link headroom and without chains has a
    zero-length link table; both packages substitute one +inf row."""
    keys = np.arange(0, 24_000, 2, dtype=np.float64)
    kw = dict(method="pgm", eps=64, gap_rho=0.3)
    ref = RefIndex.build(keys, **kw)
    port = Index.build(keys, device="cpu", **kw)
    assert port.gapped.links.total == 0  # linear keys build no chains
    ra = ref_freeze(ref)
    pa = freeze.from_learned_index(port, "cpu")
    assert pa.link_keys.shape[0] == 0
    batch = np.concatenate([keys[:-1:7] + 1.0, [-5.0, 30_001.0]])
    prims, esc = ops_gap.ingest_place(pa, batch)
    rprims, resc = ref_ops_gap.ingest_place(ra, batch, impl="pallas",
                                            interpret=True)
    assert np.array_equal(esc, resc)
    host = port.gapped.placement_primitives(batch)
    for f in prims:
        assert np.array_equal(prims[f], rprims[f]), f
        assert np.array_equal(prims[f][~esc], host[f][~esc]), f


def test_split_key_pair_never_yields_negative_zero():
    """The fused graph's two stable sorts order -0.0 and +0.0 as equal
    where the reference's lax.sort orders -0.0 first; the split never
    produces a -0.0 lo half, so the orders agree."""
    rng = np.random.default_rng(5)
    keys = np.concatenate([
        rng.integers(-2 ** 47, 2 ** 47, 20_000).astype(np.float64),
        np.arange(-64, 64, dtype=np.float64), [0.0, 2.0 ** 24 + 1]])
    hi, lo = freeze.split_key_pair(keys)
    assert not np.any(np.signbit(lo) & (lo == 0))


def test_wrapper_checks_and_never_runs_plain_on_cuda(monkeypatch):
    """Bad inputs raise; a CUDA tensor goes to the kernel launch, never
    to the plain version."""
    t = torch.zeros(8)
    off = torch.zeros(9, dtype=torch.int32)
    good = [t, t, t, t, t, t, t, t, t, t, off, t, t]
    with pytest.raises(TypeError):
        gap_place.ingest_place(*good[:10], off.float(), t, t, n_slots=8)
    with pytest.raises(ValueError):
        gap_place.ingest_place(t, torch.zeros(4), *good[2:], n_slots=8)
    called = []
    monkeypatch.setattr(gap_place, "ingest_place_plain",
                        lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(gap_place, "_launch",
                        lambda *a, **k: called.append("kernel"))
    monkeypatch.setattr(gap_place, "_check",
                        lambda *a, **k: torch.device("cuda"))
    gap_place.ingest_place(*good, n_slots=8)
    assert called == ["kernel"]
