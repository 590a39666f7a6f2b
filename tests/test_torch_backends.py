"""The handle's lookup backends on the CPU against the reference's: the
registry, the capability checks (the legacy ``pallas`` kernel is
narrow-only), the stage labels, and ``xla-windowed`` lookups across
delta-synced writes.  Mirrors tests/test_index_handle.py; payloads,
slots and found are bit-identical."""

import numpy as np
import pytest

from conftest import make_keys
from repro.core import BACKENDS as REF_BACKENDS
from repro.core import Index as RefIndex
from repro_torch.core import BACKENDS, Index


def _both(keys, **kw):
    kw = dict(method="pgm", eps=64, **kw)
    return RefIndex.build(keys, **kw), Index.build(keys, device="cpu", **kw)


def _assert_same(got, want, label=""):
    assert np.array_equal(got.payloads, want.payloads), label
    assert np.array_equal(got.slots, want.slots), label
    assert np.array_equal(got.found, want.found), label
    assert got.backend == want.backend, (label, got.backend, want.backend)
    assert got.epoch == want.epoch, label


def test_registry_equals_the_reference():
    assert set(BACKENDS) == set(REF_BACKENDS) == {
        "fused", "pallas", "xla-windowed", "numpy-oracle"}
    for name, spec in BACKENDS.items():
        ref = REF_BACKENDS[name]
        assert (spec.device, spec.wide_keys, spec.min_batch,
                spec.engine_backend) == (ref.device, ref.wide_keys,
                                         ref.min_batch, ref.engine_backend)


def test_labels_and_answers_equal_the_reference():
    """The same calls on both handles: default resolution, explicit
    legacy stages, small batches; each labelled as the reference
    labels it, with the same answers."""
    x = make_keys("uniform_int", 9_000, seed=6)
    ref, port = _both(x, gap_rho=0.1)
    rng = np.random.default_rng(6)
    q = np.concatenate([rng.choice(x, 3000),
                        np.setdiff1d(rng.integers(0, 2 ** 22, 1200), x)])
    calls = [(q, None), (q, "pallas"), (q, "xla-windowed"), (q, "fused"),
             (q[:100], None), (q[:600], "xla-windowed"),
             (q[:600], "pallas"), (q[:700], "numpy-oracle")]
    labels = []
    for qq, be in calls:
        got, want = port.lookup(qq, backend=be), ref.lookup(qq, backend=be)
        _assert_same(got, want, be)
        assert np.array_equal(got.payloads, port.gapped.lookup_batch(qq))
        labels.append(got.backend)
    assert labels == ["fused", "pallas", "xla-windowed", "fused",
                      "numpy-oracle", "xla-windowed", "pallas",
                      "numpy-oracle"]
    with pytest.raises(ValueError, match="unknown backend"):
        port.lookup(x[:4], backend="cuda")


def test_pallas_refused_on_wide_keys():
    """+2^30 offsets need more than 24 mantissa bits: the legacy kernel
    is refused with the failed capability; the default and
    ``xla-windowed`` serve the index on the device."""
    x = make_keys("uniform_int", 9_000, seed=6)
    wide_keys = np.unique(x + 2.0 ** 30)
    ref, port = _both(wide_keys, gap_rho=0.1)
    for idx in (ref, port):
        with pytest.raises(ValueError, match="hi/lo"):
            idx.lookup(wide_keys[:2048], backend="pallas")
    assert port.resolve_backend(10_000).name == "fused"
    truth = np.searchsorted(wide_keys, wide_keys[:2048])
    for be in (None, "xla-windowed"):
        got = port.lookup(wide_keys[:2048], backend=be)
        _assert_same(got, ref.lookup(wide_keys[:2048], backend=be), be)
        assert np.array_equal(got.payloads, truth)


def test_capability_follows_ingested_keys():
    """Ingesting a key past 2^24 into a narrow index flips the pallas
    capability check, in both packages alike."""
    x = make_keys("uniform_int", 8_000, seed=12)
    ref, port = _both(x, gap_rho=0.2)
    for idx in (ref, port):
        assert idx.lookup(x[:1024], backend="pallas").backend == "pallas"
        idx.ingest(np.array([2.0 ** 30 + 1]), np.array([5]))
        with pytest.raises(ValueError, match="hi/lo"):
            idx.lookup(x[:1024], backend="pallas")
    q = np.full(4096, 2.0 ** 30 + 1)
    got = port.lookup(q, backend="xla-windowed")
    _assert_same(got, ref.lookup(q, backend="xla-windowed"))
    assert np.all(got.payloads == 5)


@pytest.mark.parametrize("seed", [0, 1])
def test_xla_windowed_rounds_match_the_reference_and_host(seed):
    """Interleaved ingest / lookup rounds on delta-synced device state:
    every ``xla-windowed`` lookup equals the reference's and the host
    oracle's (tests/test_index_handle.py's delta rounds)."""
    rng = np.random.default_rng(seed)
    x = make_keys("uniform_int", 20_000, seed=seed)
    ref, port = _both(x, gap_rho=0.25)
    pool = np.setdiff1d(
        np.unique(rng.integers(1, 2 ** 22, 40_000)).astype(np.float64), x)
    rng.shuffle(pool)
    q0 = rng.choice(x, 4096)
    _assert_same(port.lookup(q0, backend="xla-windowed"),
                 ref.lookup(q0, backend="xla-windowed"))
    assert port.device_epoch == port.epoch == 0
    for rnd in range(3):
        batch = pool[rnd * 1000: rnd * 1000 + 700]
        pay = 10_000_000 + np.arange(700) + rnd
        reps = [idx.ingest(batch, pay) for idx in (ref, port)]
        assert reps[1].device == reps[0].device
        assert reps[1].device in ("delta", "refreeze")
        assert port.device_epoch == port.epoch == ref.epoch
        q = np.concatenate([batch, rng.choice(x, 2000),
                            pool[rnd * 1000 + 700: rnd * 1000 + 1000]])
        got = port.lookup(q, backend="xla-windowed")
        _assert_same(got, ref.lookup(q, backend="xla-windowed"), rnd)
        truth_pay, _, truth_found = port.gapped.lookup_batch(q, full=True)
        assert np.array_equal(got.payloads, truth_pay)
        assert np.array_equal(got.found, truth_found)
    assert port.stats["delta_updates"] >= 1


def test_xla_windowed_after_delta_equals_fresh_freeze():
    """After the same writes, a delta-updated engine and a freshly
    frozen one answer ``xla-windowed`` lookups bit-identically."""
    x = make_keys("iot", 20_000, seed=4)
    rng = np.random.default_rng(4)
    kw = dict(method="pgm", eps=64, gap_rho=0.25, device="cpu")
    idx_delta, idx_fresh = Index.build(x, **kw), Index.build(x, **kw)
    # policy thresholds off, so the writes take the delta arm
    idx_delta.refreeze_contested_frac = 1.1
    idx_delta.refreeze_link_growth = 10.0
    mids = np.setdiff1d(x[:-1] + np.diff(x) * rng.random(len(x) - 1), x)
    warm = (mids[800:1600], np.arange(800))
    idx_delta.ingest(*warm)          # grows the frozen capacities
    idx_fresh.ingest(*warm)          # no engine yet: host only
    idx_delta.lookup(rng.choice(x, 4096), backend="xla-windowed")
    pay = 5_000_000 + np.arange(800)
    rep = idx_delta.ingest(mids[:800], pay)
    assert rep.device == "delta"
    idx_fresh.ingest(mids[:800], pay)
    idx_fresh.refreeze()
    q = np.concatenate([mids[:800], rng.choice(x, 4000)])
    r_delta = idx_delta.lookup(q, backend="xla-windowed")
    r_fresh = idx_fresh.lookup(q, backend="xla-windowed")
    assert r_delta.backend == r_fresh.backend == "xla-windowed"
    assert np.array_equal(r_delta.payloads, r_fresh.payloads)
    assert np.array_equal(r_delta.found, r_fresh.found)
    assert np.array_equal(r_delta.slots, r_fresh.slots)
    assert np.array_equal(r_delta.payloads[:800], pay)
