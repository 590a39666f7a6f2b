"""The slice as a whole: the port's ``Index.build`` + ``lookup`` (on the
CPU) answers exactly as the reference's ``Index.build`` + ``lookup``,
and a reference index carried across with ``convert.index_from_state``
answers identically.  Payloads, slots and found are bit-identical."""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import Index as RefIndex
from repro_torch import convert
from repro_torch.core import BACKENDS, Index


def _mixed(rng, keys, chain_keys, n=3000):
    present = np.concatenate([rng.choice(keys, int(0.6 * n)),
                              rng.choice(chain_keys, int(0.1 * n))])
    absent = np.setdiff1d(np.floor(rng.uniform(keys[0], keys[-1], n)),
                          keys)[:int(0.25 * n)]
    out = np.concatenate([keys[0] - 1.0 - rng.integers(0, 1000, 75),
                          keys[-1] + 1.0 + rng.integers(0, 1000, 75)])
    return rng.permutation(np.concatenate([present, absent, out]))


def _ref_state(ref):
    """The leaves ``Index.save_snapshot`` writes, plus the PLM arrays in
    place of the pickled mechanism."""
    ga = ref.gapped
    offsets, lkeys, lpays = ga.export_csr_links()
    plm = ref.mech.plm
    state = {"keys": ref.keys, "slot_key": ga.slot_key,
             "occupied": ga.occupied, "payload": ga.payload,
             "offsets": offsets, "chain_keys": lkeys,
             "chain_payloads": lpays}
    state.update({f: getattr(plm, f) for f in convert.PLM_LEAVES})
    meta = {"method": ref.method, "n_keys": int(ga.n_keys),
            "rho": float(ga.rho), "epoch": int(ref.epoch),
            "gap_rho": float(ref.gap_rho),
            "sample_rate": float(ref.sample_rate),
            "plm_n_keys": int(plm.n_keys)}
    return state, meta


def _assert_same(a, b):
    assert np.array_equal(a.payloads, b.payloads)
    assert np.array_equal(a.slots, b.slots)
    assert np.array_equal(a.found, b.found)


@pytest.mark.parametrize("span,sample_rate", [(2 ** 22, 1.0),
                                              (2 ** 40, 0.01)])
def test_index_matches_reference(span, sample_rate):
    rng = np.random.default_rng(21)
    keys = np.unique(rng.choice(span, 25_000, replace=False)
                     ).astype(np.float64)
    kw = dict(method="pgm", eps=64, gap_rho=0.15, sample_rate=sample_rate)
    ref = RefIndex.build(keys, rng=np.random.default_rng(7), **kw)
    port = Index.build(keys, rng=np.random.default_rng(7), device="cpu",
                       **kw)
    assert port.epoch == ref.epoch == 0
    q = _mixed(rng, keys, port.gapped.links.chain_keys)
    want = ref.lookup(q)
    got = port.lookup(q)
    assert got.backend == "fused" and want.backend == "fused"
    assert got.epoch == 0 and port.device_epoch == 0
    _assert_same(got, want)
    assert np.array_equal(got.payloads, port.gapped.lookup_batch(q))
    # small batches go to the host oracle, as in the reference
    small = port.lookup(q[:100])
    assert small.backend == "numpy-oracle"
    assert np.array_equal(small.payloads, ref.lookup(q[:100]).payloads)
    # a host mutation moves the epoch; the next lookup brings the device
    # forward by a delta update
    port.gapped.insert_batch(np.array([keys[0] + 0.5]), np.array([42]))
    assert port.epoch == 1 and port.device_epoch == 0
    res = port.lookup(np.concatenate([[keys[0] + 0.5], q]))
    assert res.payloads[0] == 42 and port.device_epoch == 1
    assert port.stats["refreezes"] == 1
    assert port.stats["delta_updates"] == 1


def test_index_from_state_answers_identically():
    rng = np.random.default_rng(22)
    keys = np.unique(rng.choice(2 ** 40, 20_000, replace=False)
                     ).astype(np.float64)
    ref = RefIndex.build(keys, method="pgm", eps=64, gap_rho=0.15,
                         sample_rate=0.05, rng=np.random.default_rng(3))
    mids = np.setdiff1d(keys[:-1] + np.rint(np.diff(keys) * 0.5),
                        keys)[:1500]
    ref.ingest(mids, 9_000_000 + np.arange(mids.size))
    state, meta = _ref_state(ref)
    port = convert.index_from_state(state, meta, device="cpu")
    assert port.epoch == ref.epoch > 0
    q = _mixed(rng, keys, ref.gapped.links.chain_keys)
    _assert_same(port.lookup(q), ref.lookup(q))
    _assert_same(port.lookup(q, backend="numpy-oracle"),
                 ref.lookup(q, backend="numpy-oracle"))


def test_bare_index_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    """An ``Index`` constructed directly resolves its device as
    ``build`` does: cuda by default, which raises without CUDA."""
    keys = np.arange(100, dtype=np.float64)
    built = Index.build(keys, gap_rho=0.1, device="cpu")
    assert built.device == torch.device("cpu")
    bare = dict(keys=keys, mech=built.mech, method="pgm",
                gapped=built.gapped)
    assert Index(**bare, device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Index(**bare)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert Index(**bare).device == torch.device("cuda")


def test_unported_entry_points_raise_naming_their_item():
    keys = np.arange(1000, dtype=np.float64)
    # every lookup backend of the reference is ported (A8)
    assert sorted(BACKENDS) == ["fused", "numpy-oracle", "pallas",
                                "xla-windowed"]
    # durability (A9), self-tuning (A15) and sharding (A11) are ported:
    # build(shards=...) returns the sharded index on the asked device,
    # and no entry point of the port raises NotImplementedError for an
    # item of the queue any more
    from repro_torch.dist import ShardedIndex
    sharded = Index.build(keys, shards=2, gap_rho=0.2, device="cpu")
    assert isinstance(sharded, ShardedIndex)
    assert [sh.device.type for sh in sharded.shards] == ["cpu", "cpu"]
    assert np.array_equal(sharded.lookup(keys[::3]).payloads,
                          np.arange(1000)[::3])
    src = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    for path in src.rglob("*.py"):
        text = path.read_text()
        assert "_not_ported" not in text, path
        assert "item A11" not in text, path
        # partitioning (A13d) is ported: no note still waits for it
        assert "A13d" not in text, path
