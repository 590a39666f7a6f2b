"""``fused_lookup_plain`` (the port's plain torch version of the fused
kernel) against the reference's ``fused_lookup_call(...,
interpret=True)`` on identical inputs.

Tolerance: on every real row that neither side flags as an escape,
slot / resolved / out / out_hi are exact.  The two flagged sets may
differ, because XLA on the CPU may contract ``slope * dx + icept_fold``
into one FMA (repro/kernels/lookup.py:285-289) while torch rounds the
product and the sum separately: the window base can then move by one
slot, which only moves escape flags.  Their symmetric difference is
held to at most 0.5% of the batch.  Where the flagged sets agree, the
per-tile compaction (fb_loc, fb_cnt) is exact too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.lookup import fused_lookup_call
from repro_torch.core import Index
from repro_torch.kernels import ops
from repro_torch.kernels.lookup import fused_lookup, fused_lookup_plain

MAX_FLAG_DIFF = 0.005


def _index(seed, span):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.choice(span, 25_000, replace=False)
                     ).astype(np.float64)
    idx = Index.build(keys, method="pgm", eps=64, gap_rho=0.15,
                      device="cpu")
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


@pytest.mark.parametrize("name,seed,span,flat_w", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_pallas_interpret(name, seed, span, flat_w):
    idx, q = _index(seed, span)
    eng = idx.sync_device()
    a = eng.arrays
    assert a.key_wide == (span > 2 ** 24) and a.max_chain > 0
    qh, ql = ops.split_queries(np.sort(q), a.key_wide)
    n_real, n_pad = q.size, 4096
    assert 3500 < n_real < n_pad
    qh = np.concatenate([qh, np.full(n_pad - n_real, np.inf, np.float32)])
    if a.key_wide:
        ql = np.concatenate([ql, np.zeros(n_pad - n_real, np.float32)])
    q_tile = ops.auto_q_tile(n_pad, a.n_slots, eng.w_tile)
    fw = eng._fused_width_for(n_pad) if flat_w is None else flat_w
    args = ops.fused_args(torch.from_numpy(qh), torch.from_numpy(ql), a,
                          eng._elo, eng._radix_table, eng._radix_scale,
                          q_tile=q_tile, w_tile=eng.w_tile)
    statics = ops.fused_statics(a, q_tile=q_tile, w_tile=eng.w_tile,
                                flat_w=fw)
    mine = fused_lookup_plain(*args, **statics)
    # the wrapper takes the plain version for CPU tensors, unlaunched
    launches = fused_lookup.launches
    via_wrapper = fused_lookup(*args, **statics)
    assert fused_lookup.launches == launches
    for x, y in zip(mine, via_wrapper):
        assert torch.equal(x, y)
    ref = fused_lookup_call(*[jnp.asarray(t.numpy()) for t in args],
                            win_chunk=512, interpret=True, **statics)
    ref = [np.asarray(r) for r in ref]
    mine = [m.numpy() for m in mine]
    r = slice(0, n_real)
    fb_ref, fb_mine = ref[4][r], mine[4][r]
    flag_diff = np.count_nonzero(fb_ref != fb_mine)
    assert flag_diff <= MAX_FLAG_DIFF * n_real, flag_diff
    both = ~fb_ref & ~fb_mine
    for k, field in enumerate(("slot", "res", "out", "out_hi")):
        if field == "out_hi" and not a.wide:
            assert mine[k].size == 0 and ref[k].size == 0
            continue
        assert np.array_equal(mine[k][r][both], ref[k][r][both]), field
    # compaction: ascending local indices, padded with q_tile
    t = n_pad // q_tile
    loc, cnt, fbm = mine[5].reshape(t, q_tile), mine[6], mine[4]
    for i in range(t):
        flagged = np.flatnonzero(fbm[i * q_tile:(i + 1) * q_tile])
        assert cnt[i] == flagged.size
        assert np.array_equal(loc[i, :cnt[i]], flagged)
        assert np.all(loc[i, cnt[i]:] == q_tile)
    if flag_diff == 0 and np.array_equal(ref[4], mine[4]):
        assert np.array_equal(ref[5], mine[5])
        assert np.array_equal(ref[6], mine[6])

