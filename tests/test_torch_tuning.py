"""Self-tuning in the port against the reference: the §3 MDL
auto-tuner (``core.tuning.autotune``) picks the same winner with the
same score and candidates, ``Index.build(method="auto")`` builds the
same index, ``Index.mdl()`` reports are equal before and after an
ingest, and ``Index.retrain`` gives the same state, epoch and record.
A retrain drops the device cache; the next lookup refreezes.  Inputs
are made with numpy from a seed (the repo's synthetic key families)
and handed to both packages, with equal ``rng`` seeds; comparisons are
exact."""

import copy
import dataclasses

import numpy as np
import pytest

from conftest import make_keys
from repro.core import Index as RefIndex
from repro.core import tuning as ref_tuning
from repro.serving import EpochPipeline as RefPipeline
from repro_torch.core import Index
from repro_torch.core import tuning
from repro_torch.serving import EpochPipeline


def _report(rep):
    return dataclasses.asdict(rep)


def _choice(c):
    d = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    d["report"] = _report(c.report)
    return d


def _state_equal(a, b):
    ga, gb = a.gapped, b.gapped
    assert np.array_equal(a.keys, b.keys)
    assert np.array_equal(ga.slot_key, gb.slot_key)
    assert np.array_equal(ga.occupied, gb.occupied)
    assert np.array_equal(ga.payload, gb.payload)
    assert ga.n_keys == gb.n_keys and ga.rho == gb.rho
    assert a.epoch == b.epoch
    for x, y in zip(ga.export_csr_links(), gb.export_csr_links()):
        assert np.array_equal(x, y)
    pa, pb = a.mech.plm, b.mech.plm
    for f in ("seg_first_key", "slope", "icept", "err_lo", "err_hi"):
        assert np.array_equal(getattr(pa, f), getattr(pb, f)), f


def _answers_equal(a, b, q):
    ra, rb = a.lookup(q), b.lookup(q)
    assert np.array_equal(ra.payloads, rb.payloads)
    assert np.array_equal(ra.slots, rb.slots)
    assert np.array_equal(ra.found, rb.found)


@pytest.mark.parametrize("kind,seed,kw", [
    ("iot", 0, {}),
    ("weblogs", 1, {"dynamic": True}),
    ("longitude", 3, {"alpha": 100.0}),
    ("iot", 2, {"size_budget_bytes": 1}),
    ("iot", 10, {"queries": "hot"}),
])
def test_autotune_picks_the_reference_winner(kind, seed, kw):
    x = make_keys(kind, 40_000, seed=seed)
    if kw.get("queries") == "hot":
        kw = {"queries": np.random.default_rng(seed).choice(
            x[: x.size // 50], 8_000)}
    a = ref_tuning.autotune(x, rng=np.random.default_rng(seed), **kw)
    b = tuning.autotune(x, rng=np.random.default_rng(seed), **kw)
    assert _choice(a) == _choice(b)
    assert b.score == min(c["mdl"] for c in b.candidates) or not b.budget_met


@pytest.mark.parametrize("case", ["gapped", "static", "explicit_rate"])
def test_build_auto_matches_the_reference(case):
    x = make_keys("iot", 30_000, seed=4)
    kw = {"gapped": dict(gap_rho=0.15),
          "static": {},
          "explicit_rate": dict(gap_rho=0.15, sample_rate=0.07)}[case]
    ref = RefIndex.build(x, method="auto", rng=np.random.default_rng(4),
                         **kw)
    port = Index.build(x, method="auto", rng=np.random.default_rng(4),
                       device="cpu", **kw)
    assert _choice(port.tuned) == _choice(ref.tuned)
    assert (port.method, port.sample_rate, port.mech_kwargs) == (
        ref.method, ref.sample_rate, ref.mech_kwargs)
    if case == "explicit_rate":
        assert port.sample_rate == 0.07
    else:
        assert port.sample_rate == port.tuned.sample_rate
    q = np.random.default_rng(5).choice(x, 4_000)
    if case == "static":
        assert port.gapped is None
        assert np.array_equal(port.predict(q), ref.predict(q))
    else:
        _state_equal(port, ref)
    r = port.lookup(q)
    assert r.found.all()
    assert np.array_equal(r.payloads, np.searchsorted(x, q))
    _answers_equal(port, ref, np.concatenate([q, q + 0.5]))


@pytest.mark.parametrize("wide", [False, True])
def test_mdl_reports_equal_before_and_after_ingest(wide):
    rng = np.random.default_rng(6)
    hi = 2 ** 39 if wide else 2 ** 22
    keys = np.unique(rng.choice(hi, 25_000, replace=False)) * 2.0
    kw = dict(method="pgm", eps=64, gap_rho=0.15, sample_rate=0.05)
    ref = RefIndex.build(keys, rng=np.random.default_rng(7), **kw)
    port = Index.build(keys, rng=np.random.default_rng(7), device="cpu",
                       **kw)
    for alpha in (1.0, 4.0):
        assert _report(port.mdl(alpha)) == _report(ref.mdl(alpha))
    step = float(np.mean(np.diff(keys)))
    tail = np.rint(keys[-1] / 2.0 + step * (1.0 + np.arange(800))) * 2.0
    for idx in (ref, port):
        idx.ingest(tail, 1_000_000 + np.arange(tail.size))
    after = _report(port.mdl())
    assert after == _report(ref.mdl())
    assert after["l_data_given_model"] > _report(
        Index.build(keys, rng=np.random.default_rng(7), device="cpu",
                    **kw).mdl())["l_data_given_model"]


@pytest.mark.parametrize("case", ["same", "switched", "gap_rho"])
@pytest.mark.parametrize("wide", [False, True])
def test_retrain_equals_the_reference(case, wide):
    rng = np.random.default_rng(11)
    hi = 2 ** 39 if wide else 2 ** 22
    keys = np.unique(rng.choice(hi, 20_000, replace=False)) * 2.0
    kw = dict(method="pgm", eps=64, gap_rho=0.15)
    ref = RefIndex.build(keys, rng=np.random.default_rng(1), **kw)
    port = Index.build(keys, rng=np.random.default_rng(1), device="cpu",
                       **kw)
    step = float(np.mean(np.diff(keys)))
    tail = np.rint(keys[-1] / 2.0 + step * (1.0 + np.arange(600))) * 2.0
    args = {"same": dict(sample_rate=0.05),
            "switched": dict(method="fiting", eps=128.0),
            "gap_rho": dict(sample_rate=0.1, gap_rho=0.3)}[case]
    recs = []
    for idx in (ref, port):
        idx.ingest(tail, 1_000_000 + np.arange(tail.size))
        recs.append(idx.retrain(rng=np.random.default_rng(3), **args))
    for r in recs:
        del r["seconds"], r["learn_seconds"]
    assert recs[0] == recs[1]
    assert recs[1]["epoch"] == port.epoch == 2
    _state_equal(port, ref)
    assert (port.method, port.sample_rate, port.gap_rho,
            port.mech_kwargs) == (ref.method, ref.sample_rate,
                                  ref.gap_rho, ref.mech_kwargs)
    assert port.stats["retrains"] == ref.stats["retrains"] == 1
    q = np.concatenate([keys[::9], tail, tail + 1.0])
    _answers_equal(port, ref, q)
    assert port.lookup(tail).found.all()


def test_retrain_rejects_a_static_index():
    x = make_keys("iot", 5_000, seed=4)
    idx = Index.build(x, method="pgm", eps=64, device="cpu")
    with pytest.raises(NotImplementedError):
        idx.retrain()


def test_retrain_drops_the_device_cache_and_refreezes():
    x = make_keys("iot", 20_000, seed=0)
    kw = dict(method="pgm", eps=64, gap_rho=0.15)
    ref = RefIndex.build(x, rng=np.random.default_rng(0), **kw)
    port = Index.build(x, rng=np.random.default_rng(0), device="cpu", **kw)
    q = np.random.default_rng(1).choice(x, 2_048)
    assert port.lookup(q).backend in ("fused", "device-oracle")
    assert port.device_epoch == port.epoch == 0
    assert port._engine is not None and port._keycap_cache is not None
    for idx in (ref, port):
        idx.retrain(sample_rate=0.05, rng=np.random.default_rng(2))
    assert port._engine is None and port._mirror is None
    assert port.device_epoch == -1 and port._keycap_cache is None
    assert port._pending_touch == [] and port.device.type == "cpu"
    res = port.lookup(q)
    assert res.backend in ("fused", "device-oracle") and res.epoch == 1
    assert port.device_epoch == 1 and port.stats["refreezes"] == 2
    _answers_equal(port, ref, np.concatenate([q, q + 0.25]))


def test_pipeline_retrain_keeps_the_pinned_snapshot():
    """``EpochPipeline.retrain`` behind a pinned snapshot, both
    packages: the snapshot answers do not move, the retrained epoch
    serves from the next publish, and the two agree throughout."""
    x = make_keys("weblogs", 20_000, seed=2)
    kw = dict(method="pgm", eps=32.0, gap_rho=0.2, sample_rate=0.05)
    ref = RefIndex.build(x, rng=np.random.default_rng(17), **kw)
    port = Index.build(x, rng=np.random.default_rng(17), device="cpu", **kw)
    fresh = np.setdiff1d(x[:-1] + np.diff(x) / 4.0, x)[-64:]
    q = np.concatenate([x[::13], fresh])
    out = []
    for idx, cls in ((ref, RefPipeline), (port, EpochPipeline)):
        pipe = cls(idx)
        pre = pipe.lookup(q)
        pipe.ingest(fresh, 40_000_000 + np.arange(fresh.size))
        pipe.retrain(sample_rate=0.05, rng=np.random.default_rng(19))
        held = pipe.lookup(q)
        assert held.epoch == pre.epoch and held.backend == "snapshot"
        assert np.array_equal(held.payloads, pre.payloads)
        pipe.publish()
        post = pipe.lookup(q)
        out.append((pre, held, post, dict(pipe.stats)))
        pipe.close()
    for a, b in zip(out[0][:3], out[1][:3]):
        assert a.epoch == b.epoch
        assert np.array_equal(a.payloads, b.payloads)
        assert np.array_equal(a.found, b.found)
    assert out[0][3] == out[1][3]
    assert out[1][2].found[-64:].all()


def test_deepcopy_drops_the_device_cache_and_keeps_the_device():
    x = make_keys("iot", 8_000, seed=3)
    port = Index.build(x, method="pgm", eps=64, gap_rho=0.15, device="cpu")
    port.lookup(x[:1_024])
    port.fused_ingest_enabled = None
    dup = copy.deepcopy(port)
    assert dup._engine is None and dup.device_epoch == -1
    assert dup.device == port.device and dup.fused_ingest_enabled is None
    assert dup.gapped is not port.gapped and dup.epoch == port.epoch
    assert dup.stats == port.stats and dup.stats is not port.stats
    fresh = np.setdiff1d(x[:-1] + np.diff(x) / 2.0, x)[:700]
    dup.ingest(fresh, np.arange(fresh.size))
    assert port.epoch == 0 and not port.lookup(fresh).found.any()
    assert dup.lookup(fresh).found.all()
