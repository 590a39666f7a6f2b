"""Delta sync: after mixed insert / delete / payload-update batches,
``delta_update``'s device tensors equal a fresh freeze of the same host
state at the frozen capacities, field for field, and equal the
reference's ``delta_update`` on the same mutations (with ``n_changed``
and ``touched_keys``); and the declines (link capacity, chain
headroom, ``max_diff_frac``, payload width) give the reference's
``delta`` / ``refreeze`` labels.  All comparisons are exact.
"""

import numpy as np
import pytest

from repro.core import Index as RefIndex
from repro.kernels import ops as ref_ops
from repro_torch.core import Index
from repro_torch.kernels import delta, freeze


def _both(keys, payloads=None, **kw):
    kw = dict(dict(method="pgm", eps=64, gap_rho=0.15), **kw)
    ref = RefIndex.build(keys, rng=np.random.default_rng(2),
                         payloads=payloads, **kw)
    port = Index.build(keys, rng=np.random.default_rng(2), device="cpu",
                       payloads=payloads, **kw)
    ref.sync_device()
    port.sync_device()
    return ref, port


def _fresh_images(port, statics):
    imgs, _ = freeze._freeze_numpy(
        port, max_chain=statics["max_chain"], link_cap=statics["link_cap"],
        force_wide=statics["wide"], force_key_wide=statics["key_wide"])
    return imgs


def _mutate(rng, idx_pair, keys, held, step, slot_deletes):
    """One round of host mutations, the same on both sides.  A deleted
    slot leaves the payload sentinel INT64_MIN behind, which a narrow
    (i32) freeze cannot hold, so narrow cases delete chain keys only."""
    batch = held[step * 900:(step + 1) * 900]
    ga = idx_pair[1].gapped
    dk = rng.choice(ga.links.chain_keys, 150, replace=False)
    if slot_deletes:
        dk = np.concatenate([dk, rng.choice(keys, 300, replace=False)])
    uk = rng.choice(np.setdiff1d(keys, dk), 200, replace=False)
    for idx in idx_pair:
        idx.gapped.insert_batch(batch, 5_000_000 + np.arange(batch.size))
        idx.gapped.delete_batch(dk)
        idx.gapped.update_batch(uk, 77 + np.arange(uk.size))


CASES = [("narrow", 2 ** 22, False), ("wide", 2 ** 40, False),
         ("wide_payload", 2 ** 40, True)]


@pytest.mark.parametrize("name,span,wpay", CASES,
                         ids=[c[0] for c in CASES])
def test_delta_images_equal_fresh_freeze_and_reference(name, span, wpay):
    rng = np.random.default_rng(7)
    allk = np.unique(rng.choice(span, 30_000, replace=False)
                     ).astype(np.float64)
    perm = rng.permutation(allk.size)
    keys, held = np.sort(allk[perm[:25_000]]), allk[perm[25_000:]]
    pay = ((np.int64(3) << 40) + np.arange(keys.size, dtype=np.int64)
           if wpay else None)
    ref, port = _both(keys, pay)
    for step in range(3):
        if step == 2:
            # a fused commit leaves the mirror's images dirty; the next
            # host delta rebuilds them from the sources first
            batch = np.setdiff1d(
                port.gapped.slot_key[:-1:40] + 1.0,
                np.concatenate([port.gapped.slot_key, held,
                                port.gapped.links.chain_keys]))[:600]
            for idx in (ref, port):
                idx.fused_ingest_enabled = True
                rep = idx.ingest(batch, np.arange(batch.size))
            assert port._mirror.images is None or rep.device != "fused"
        _mutate(rng, (ref, port), keys, held, step, slot_deletes=wpay)
        r_arrays, r_n, r_touched = ref_ops.delta_update(
            ref._engine.arrays, ref._mirror, ref)
        p_arrays, p_n, p_touched = delta.delta_update(
            port._engine.arrays, port._mirror, port)
        assert p_arrays is not None and r_arrays is not None
        assert p_n == r_n > 0
        assert np.array_equal(p_touched, r_touched)
        fresh = _fresh_images(port, port._mirror.statics)
        n_off = port.gapped.n_slots + 1
        for f in delta.DELTA_FIELDS:
            got = getattr(p_arrays, f).numpy()
            if f == "link_offsets":
                # past n_slots + 1 the padded tail keeps the frozen total
                # in both packages; no slot reads it
                assert np.array_equal(got[:n_off], fresh[f][:n_off])
            else:
                assert np.array_equal(got, fresh[f]), f
            assert np.array_equal(got, np.asarray(getattr(r_arrays, f))), f
            if got.size:
                assert np.array_equal(port._mirror.images[f], got), f
        for idx, arrays in ((ref, r_arrays), (port, p_arrays)):
            idx._engine.swap_arrays(arrays)
            idx._device_epoch = idx.epoch
    assert port._mirror.sources.keys() == ref._mirror.sources.keys()
    for f, v in ref._mirror.sources.items():
        assert np.array_equal(port._mirror.sources[f], v), f


def _labels(ref, port, calls):
    """Run the same calls on both; the reports / sync stats agree."""
    for call in calls:
        a, b = call(ref), call(port)
        if hasattr(a, "device"):
            assert (a.device, a.placement, a.slot, a.chain) == (
                b.device, b.placement, b.slot, b.chain)
    keep = ("refreezes", "delta_updates", "delta_elems", "ingests",
            "bound_refreshes")
    assert ({k: ref.stats[k] for k in keep}
            == {k: port.stats[k] for k in keep})
    return port.stats


def test_declines_give_the_reference_labels():
    rng = np.random.default_rng(9)
    keys = np.unique(rng.choice(2 ** 22, 25_000, replace=False)
                     ).astype(np.float64)
    ref, port = _both(keys)
    q = rng.choice(keys, 2000)
    st0 = dict(port.stats)
    # payload width: an int64 payload past a narrow i32 freeze
    uk = keys[:600]
    st = _labels(ref, port, [
        lambda i: i.update_batch(uk, (np.int64(1) << 40) + np.arange(600)),
        lambda i: i.lookup(q)])
    assert st["refreezes"] == st0["refreezes"] + 1
    # max_diff_frac: a payload update of more than half of the slots
    big = keys
    assert np.count_nonzero(np.isin(port.gapped.slot_key[
        port.gapped.occupied], big)) > 0.5 * port.gapped.n_slots
    st0 = dict(st)
    st = _labels(ref, port, [
        lambda i: i.update_batch(big, 10 ** 6 + np.arange(big.size)),
        lambda i: i.lookup(q)])
    assert st["refreezes"] == st0["refreezes"] + 1
    # a slot delete leaves INT64_MIN in the payload, past the i32 freeze
    st0 = dict(st)
    st = _labels(ref, port, [lambda i: i.remove(keys[700:720]),
                             lambda i: i.lookup(q)])
    assert st["refreezes"] == st0["refreezes"] + 1
    # a small update is a pure payload delta
    st0 = dict(st)
    st = _labels(ref, port, [
        lambda i: i.update_batch(keys[:50], np.arange(50)),
        lambda i: i.lookup(q)])
    assert st["delta_updates"] == st0["delta_updates"] + 1
    assert st["refreezes"] == st0["refreezes"]


def test_link_capacity_decline_refreezes_like_the_reference():
    """Linear keys and a tiny gap budget freeze the link table at its
    floor; chain inserts past it decline the delta (refreeze)."""
    keys = np.arange(0, 24_000, 2, dtype=np.float64)
    ref, port = _both(keys, gap_rho=0.01)
    ref.refreeze_link_growth = port.refreeze_link_growth = 10.0
    cap = int(port._engine.arrays.link_keys.shape[0])
    small = keys[100:140] + 1.0
    mids = keys[1000:1000 + 4 * cap:2] + 1.0
    st = _labels(ref, port, [lambda i: i.ingest(small, np.arange(40))])
    assert st["delta_updates"] == 1
    assert port.gapped.links.total > 0
    st = _labels(ref, port, [
        lambda i: i.ingest(mids, np.arange(mids.size))])
    assert st["refreezes"] == 2  # the build's freeze + the decline
    assert int(port._engine.arrays.link_keys.shape[0]) > cap
