"""Device oracle stage in plain torch.

Counterpart of ``repro.kernels.ref`` (``lookup_ref``, ``predict_ref``,
``chain_hit_index``, ``resolve_chains``) and of the pair helpers and
epilogue in ``repro.kernels.ops`` (``_ple``, ``_peq``, ``_pair_bisect``,
``_pair_oracle``, ``_epilogue``).  For each query q:

* ``slot``  — rightmost slot with slot_key <= q (-1 below all keys);
* ``found`` — slot_key[slot] == q (first-level hit);
* the epilogue gathers the payload and bisects the slot's CSR chain.

Every compare has an f32 (hi, lo) pair variant for wide keys.  All
functions run on whatever device their tensors lie on.  The pair
bisect, the chain scan and ``epilogue_parts`` also take tables stacked
as ``(S, m)`` with ``(S, n)`` queries: each row of queries reads its
own row of the tables (``_take``), which is what the reference's
``jax.vmap`` over the shard axis computes.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["lookup_ref", "predict_ref", "chain_hit_index", "resolve_chains",
           "pair_oracle", "epilogue", "epilogue_parts"]


def _take(table, idx):
    """``table[idx]`` for a 1-D table; for a stacked ``(S, m)`` table
    and ``(S, n)`` indices, row s of the indices reads row s of the
    table (``torch.gather`` along dim 1).  Indices are in range."""
    if table.dim() == 1:
        return table[idx]
    return torch.gather(table, 1, idx)


def _ple(kh, kl, qh, ql):
    """Lexicographic (hi, lo) <=, elementwise."""
    return (kh < qh) | ((kh == qh) & (kl <= ql))


def _peq(kh, kl, qh, ql):
    return (kh == qh) & (kl == ql)


def _bisect(lo, hi, trips: int, go_at):
    """Branchless fixed-trip bisect: the rightmost index in [lo, hi]
    where ``go_at(index)`` holds (lo may start at -1)."""
    for _ in range(trips):
        upd = lo < hi
        mid = (lo + hi + 1) >> 1
        go = go_at(mid)
        lo = torch.where(upd & go, mid, lo)
        hi = torch.where(upd, torch.where(go, hi, mid - 1), hi)
    return lo


def _pair_bisect(kh, kl, qh, ql, lo0, hi0, trips: int):
    """Rightmost index in [lo0, hi0] with pair(key) <= pair(q)."""
    m_max = kh.shape[-1] - 1

    def go_at(mid):
        midc = mid.clamp(0, m_max).long()
        return _ple(_take(kh, midc), _take(kl, midc), qh, ql)

    return _bisect(lo0, hi0, trips, go_at)


def pair_oracle(qh, ql, slot_key, slot_key_lo):
    """Full-array pair search (the wide-key oracle): slot + found."""
    m_pad = slot_key.shape[0]
    trips = int(np.ceil(np.log2(max(m_pad, 2)))) + 1
    lo0 = torch.full(qh.shape, -1, dtype=torch.int32, device=qh.device)
    hi0 = torch.full(qh.shape, m_pad - 1, dtype=torch.int32,
                     device=qh.device)
    slot = _pair_bisect(slot_key, slot_key_lo, qh, ql, lo0, hi0, trips)
    safe = slot.clamp_min(0).long()
    found = (slot >= 0) & _peq(slot_key[safe], slot_key_lo[safe], qh, ql)
    return slot, found


def predict_ref(queries, seg_first_key, seg_slope, seg_icept):
    """Segment routing + linear prediction (f32): ``(y_hat, seg)``.

    One torch op per step, so the product is rounded before the sum
    (XLA on the CPU may contract the reference's line into an FMA).
    """
    seg = (torch.searchsorted(seg_first_key, queries, right=True)
           - 1).clamp(0, seg_first_key.shape[0] - 1)
    fk = seg_first_key[seg]
    return seg_slope[seg] * (queries - fk) + seg_icept[seg], seg


def lookup_ref(queries, slot_key):
    """Narrow-key oracle: full-array searchsorted."""
    slot = torch.searchsorted(slot_key, queries, right=True,
                              out_int32=True) - 1
    safe = slot.clamp_min(0).long()
    found = (slot >= 0) & (slot_key[safe] == queries)
    return slot, found


def oracle_search(qh, ql, slot_key, slot_key_lo, key_wide: bool):
    """(slot, found) by the full-array oracle, pair-aware."""
    if key_wide:
        return pair_oracle(qh, ql, slot_key, slot_key_lo)
    return lookup_ref(qh, slot_key)


def chain_hit_index(queries, slot, found, link_offsets, link_keys,
                    max_chain: int, queries_lo=None, link_keys_lo=None):
    """Index into the CSR link tables of the entry matching q, else -1.

    Per-slot chains are key-sorted, so the scan is a branchless bisect
    of ``bit_length(max_chain)`` trips over each query's ``[start,
    end)`` CSR range.  ``queries_lo``/``link_keys_lo`` switch every
    compare to the f32 hi/lo pair; pass None for narrow keys.
    """
    miss = torch.full(queries.shape, -1, dtype=torch.int32,
                      device=queries.device)
    if link_keys.shape[-1] == 0 or max_chain <= 0:
        return miss
    wide = queries_lo is not None and link_keys_lo is not None
    l_max = link_keys.shape[-1] - 1
    safe_slot = slot.clamp(0, link_offsets.shape[-1] - 2).long()
    start = _take(link_offsets, safe_slot)
    end = _take(link_offsets, safe_slot + 1)
    scan = (slot >= 0) & ~found & (end > start)

    def go_at(mid):
        midc = mid.clamp(0, l_max).long()
        kh = _take(link_keys, midc)
        if wide:
            return _ple(kh, _take(link_keys_lo, midc), queries, queries_lo)
        return kh <= queries

    lo = _bisect(start - 1, end - 1, int(max_chain).bit_length(), go_at)
    loc = lo.clamp(0, l_max).long()
    eq = _take(link_keys, loc) == queries
    if wide:
        eq = eq & (_take(link_keys_lo, loc) == queries_lo)
    hit = scan & (lo >= start) & eq
    return torch.where(hit, lo, miss)


def resolve_chains(queries, slot, found, payload, link_offsets, link_keys,
                   link_payloads, max_chain: int):
    """Payloads per query: a first-level hit gives ``payload[slot]``, a
    miss the chain scan's ``link_payloads`` entry, else -1 (narrow keys
    and payloads).  Kept for the reference's API: the engine's
    ``epilogue`` fuses the same gathers and handles hi/lo pairs."""
    safe_slot = slot.clamp(0, payload.shape[0] - 1).long()
    out = torch.where(found, payload[safe_slot],
                      torch.full_like(payload[safe_slot], -1))
    if link_keys.shape[0] == 0 or max_chain <= 0:
        return out
    hit = chain_hit_index(queries, slot, found, link_offsets, link_keys,
                          max_chain)
    return torch.where(hit >= 0, link_payloads[hit.clamp_min(0).long()]
                       .to(out.dtype), out)


def epilogue(queries, queries_lo, slot, found, a, max_chain: int):
    """Fused slot->payload gather + CSR chain scan (hi/lo aware) over
    the frozen ``IndexArrays`` ``a``.

    Returns ``(lo32, hi32, resolved)``; ``hi32`` is zero-length when
    payloads are narrow, ``resolved`` marks first-level OR chain hits.
    """
    return epilogue_parts(
        queries, queries_lo, slot, found, a.payload, a.payload_hi,
        a.link_offsets, a.link_keys, a.link_keys_lo, a.link_payloads,
        a.link_payload_hi, max_chain, a.wide, a.key_wide)


def epilogue_parts(queries, queries_lo, slot, found, payload, payload_hi,
                   link_offsets, link_keys, link_keys_lo, link_payloads,
                   link_payload_hi, max_chain: int, wide: bool,
                   key_wide: bool):
    """``epilogue`` over the images as separate tensors (the reference's
    ``_epilogue`` signature); the tables may be stacked ``(S, m)`` with
    ``(S, n)`` queries (see the module doc)."""
    safe_slot = slot.clamp(0, payload.shape[-1] - 1).long()
    hit = chain_hit_index(
        queries, slot, found, link_offsets, link_keys, max_chain,
        queries_lo=queries_lo if key_wide else None,
        link_keys_lo=link_keys_lo if key_wide else None)
    has_links = link_keys.shape[-1] > 0 and max_chain > 0
    neg = torch.full_like(slot, -1)
    out = torch.where(found, _take(payload, safe_slot), neg)
    resolved = found
    hit_i = hit.clamp_min(0).long()
    if has_links:
        out = torch.where(hit >= 0, _take(link_payloads, hit_i), out)
        resolved = found | (hit >= 0)
    if not wide:
        return out, slot.new_zeros(0), resolved
    out_hi = torch.where(found, _take(payload_hi, safe_slot), neg)
    if has_links:
        out_hi = torch.where(hit >= 0, _take(link_payload_hi, hit_i),
                             out_hi)
    return out, out_hi, resolved
