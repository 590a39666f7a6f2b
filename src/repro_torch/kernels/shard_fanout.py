"""Per-shard fan-out of the fused rank-router search, in torch ops.

Counterpart of ``repro.kernels.shard_fanout``, the kernels half of
``dist.sharded``: the per-shard frozen images are STACKED into
``(S, ...)`` tensors and one function serves a whole query batch:

1. **route** — every query block is routed with the learned two-segment
   router (a product and a sum per query, two torch ops, never fused)
   backed by an EXACT boundary check: mispredicted rows take a
   fixed-trip bisect over the shard boundaries, so routing is exact by
   construction and the prediction only decides how often the bisect
   runs (the mispredict count comes home as telemetry);
2. **bucket-count + exchange** — a stable sort by destination shard and
   a counting sort place each block's queries in an ``(S, cap)`` send
   buffer; rows at ``pos >= cap`` are dropped from the buffer and
   flagged (they resolve through the host escape patch, and the
   per-bucket cap sticky-grows like the engine's escape buffer); the
   exchange hands each shard's rows to the device that holds the shard;
3. **per-shard fused search** — the SAME ``ops.fused_search`` +
   ``ref.epilogue_parts`` as the single-index graph, batched over the
   shard axis: row s of the queries gathers from row s of the stacked
   slot, chain and rank-table images (``torch.gather`` along dim 1, in
   place of the reference's ``jax.vmap``);
4. **return + inverse permutation** — the exchange back, then the
   counting sort's inverse restores caller order.

The reference is single-controller: one process drives a mesh of
``D = largest_divisor_leq(S, len(jax.devices()))`` devices and its two
``all_to_all``s move the send buffers between them.  Here one process
does the same with the visible devices of the index's type
(``fanout_devices``): ``D`` is the largest divisor of ``S`` at most
their count, shard ``s`` lives on device ``s // (S // D)``, the batch is
cut into ``D`` blocks routed on their devices, and the exchanges are
block copies between devices (at ``D = 1`` the identity reshape the
reference's one-device graph is).

Exactness contract: per-shard results are exact by the fused search's
bracket validation (escapes are flagged and host-patched); ROUTING is
exact because the boundary backstop compares in the same rounded key
representation (f32, or f32 hi/lo pair) the per-shard search uses, and
stacking refuses key sets whose rounded shard boundaries are not
strictly ordered — so the sharded answer equals the single-device
answer over the same keys bit for bit.  Slots come back shard-local;
``lookup`` offsets them by the per-shard slot base.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..device import resolve_device
from .bounds import build_rank_router
from .freeze import _CapacityError, _freeze_numpy, _round_pow2, split_key_pair
from .lookup import _clip
from .ops import fused_pipeline, resolve_escapes_host, split_queries
from .ref import _pair_bisect, _ple

__all__ = ["ShardFanout", "FanoutUnavailable", "stack_shard_images",
           "largest_divisor_leq", "fanout_devices"]


class FanoutUnavailable(Exception):
    """The shard set cannot be served by the fused fan-out graph
    (non-PLM mechanism, aliasing keys, unordered rounded boundaries);
    the caller keeps the host route + per-shard path."""


def largest_divisor_leq(s: int, n: int) -> int:
    """Largest divisor of ``s`` that is ``<= n`` (>= 1)."""
    for d in range(min(s, max(n, 1)), 0, -1):
        if s % d == 0:
            return d
    return 1


def fanout_devices(device: torch.device) -> List[torch.device]:
    """The devices a fan-out over shards on ``device`` may place its
    stacked shards on: every visible CUDA device for a cuda index, the
    CPU for a cpu one."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _pad_to(a: np.ndarray, n: int, fill) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = np.full(n - a.shape[0], fill, a.dtype)
    return np.concatenate([a, pad])


def stack_shard_images(shards, *, w_tile: int = 2048):
    """Freeze every shard (``_freeze_numpy``) and stack the padded
    images into ``(S, ...)`` numpy arrays with shared statics.

    Shards are frozen with ``force_wide``/``force_key_wide`` set to the
    OR across shards, so one set of statics serves all of them — narrow
    shards in a wide stack carry zero lo-residuals, which is exact.
    Per-shard rank-router tables are built on the padded slot keys and
    stacked alongside.  Returns ``(stacked, statics)``.
    """
    imgs = [_freeze_numpy(sh, w_tile=w_tile) for sh in shards]
    wide = any(st["wide"] for _, st in imgs)
    key_wide = any(st["key_wide"] for _, st in imgs)
    imgs = [
        (arr, st) if (st["wide"] == wide and st["key_wide"] == key_wide)
        else _freeze_numpy(sh, w_tile=w_tile, force_wide=wide,
                           force_key_wide=key_wide)
        for sh, (arr, st) in zip(shards, imgs)
    ]
    m_pad = max(a["slot_key"].shape[0] for a, _ in imgs)
    o_pad = max(a["link_offsets"].shape[0] for a, _ in imgs)
    l_pad = max(max(a["link_keys"].shape[0] for a, _ in imgs), 1)

    def col(field, n, fill, dtype):
        return np.stack([
            _pad_to(np.asarray(a[field], dtype), n, fill) for a, _ in imgs])

    stacked = {
        "slot_key": col("slot_key", m_pad, np.inf, np.float32),
        "payload": col("payload", m_pad, -1, np.int32),
        "link_keys": col("link_keys", l_pad, np.inf, np.float32),
        "link_payloads": col("link_payloads", l_pad, -1, np.int32),
        # offset tails repeat the per-shard total so padded slots read
        # empty chains
        "link_offsets": np.stack([
            _pad_to(np.asarray(a["link_offsets"], np.int32), o_pad,
                    a["link_offsets"][-1]) for a, _ in imgs]),
        "slot_key_lo": (col("slot_key_lo", m_pad, 0.0, np.float32)
                        if key_wide else np.zeros((len(imgs), 0),
                                                  np.float32)),
        "link_keys_lo": (col("link_keys_lo", l_pad, 0.0, np.float32)
                         if key_wide else np.zeros((len(imgs), 0),
                                                   np.float32)),
        "payload_hi": (col("payload_hi", m_pad, -1, np.int32)
                       if wide else np.zeros((len(imgs), 0), np.int32)),
        "link_payload_hi": (col("link_payload_hi", l_pad, -1, np.int32)
                            if wide else np.zeros((len(imgs), 0),
                                                  np.int32)),
    }
    tables, scales, trips = [], [], 1
    for a, st in imgs:
        tbl, scl, tr, _meta = build_rank_router(
            a["slot_key"], a["slot_key_lo"] if st["key_wide"] else None)
        tables.append(tbl)
        scales.append(scl)
        trips = max(trips, tr)
    stacked["rank_table"] = np.stack(tables)
    stacked["rank_scale"] = np.stack(scales)
    statics = {
        "n_shards": len(imgs),
        "trips": trips,
        "max_chain": max(st["max_chain"] for _, st in imgs),
        "wide": wide,
        "key_wide": key_wide,
        "n_slots": np.array([st["n_slots"] for _, st in imgs], np.int64),
    }
    return stacked, statics


def _live_extent(ga):
    """(min, max) live key of a gapped array, chains included."""
    sk = np.asarray(ga.slot_key, np.float64)[np.asarray(ga.occupied, bool)]
    lo, hi = float(sk[0]), float(sk[-1])
    ck = np.asarray(ga.links.chain_keys, np.float64)
    if ck.size:
        lo = min(lo, float(np.min(ck)))
        hi = max(hi, float(np.max(ck)))
    return lo, hi


def _round_key_repr(q64: np.ndarray, key_wide: bool) -> np.ndarray:
    """f64 value of a query's frozen-representation rounding (pair sum
    when wide, f32 round trip when narrow) — the order the device
    compares in."""
    q64 = np.asarray(q64, np.float64)
    if key_wide:
        hi, lo = split_key_pair(q64)
        return hi.astype(np.float64) + lo.astype(np.float64)
    with np.errstate(over="ignore"):
        return q64.astype(np.float32).astype(np.float64)


def _route_block(qh, ql, bnd_hi, bnd_lo, rparams, s, r_trips, key_wide):
    """Learned two-segment route + exact boundary backstop.

    ``rparams`` is the f32 octet [x0_hi, x0_lo, slope0, icept0, slope1,
    icept1, split_hi, split_lo].  The prediction picks the shard; ONE
    boundary-pair gather certifies it (``bnd[s-1] <= q < bnd[s]``), and
    certified-wrong rows take a fixed-trip bisect over the (S-1,)
    boundary array — exact in the same rounded representation the
    per-shard search compares in.  The prediction's product and sum
    are two ops (XLA-CPU may contract the reference's into one FMA,
    which moves only the mispredict count).  Returns ``(dst i32,
    mispredicts)``.
    """
    if s == 1:
        return (torch.zeros(qh.shape, dtype=torch.int32, device=qh.device),
                torch.zeros((), dtype=torch.int64, device=qh.device))
    if key_wide:
        x = (qh - rparams[0]) + (ql - rparams[1])
        seg1 = _ple(rparams[6], rparams[7], qh, ql)
    else:
        x = qh - rparams[0]
        seg1 = qh >= rparams[6]
    pred = torch.where(seg1, x * rparams[4] + rparams[5],
                       x * rparams[2] + rparams[3])
    s_hat = _clip(torch.round(pred), float(s - 1)).int()
    lo_i = (s_hat - 1).clamp(0, s - 2).long()
    hi_i = s_hat.clamp(0, s - 2).long()
    if key_wide:
        lo_ok = (s_hat == 0) | _ple(bnd_hi[lo_i], bnd_lo[lo_i], qh, ql)
        hi_ok = (s_hat == s - 1) | ~_ple(bnd_hi[hi_i], bnd_lo[hi_i], qh, ql)
    else:
        lo_ok = (s_hat == 0) | (bnd_hi[lo_i] <= qh)
        hi_ok = (s_hat == s - 1) | (bnd_hi[hi_i] > qh)
    ok = lo_ok & hi_ok
    # exact backstop: rightmost boundary <= q (the pair compare is the
    # plain f32 compare when the lo planes are zero)
    zl = torch.zeros_like(qh) if not key_wide else ql
    bl = torch.zeros_like(bnd_hi) if not key_wide else bnd_lo
    i = _pair_bisect(
        bnd_hi, bl, qh, zl,
        torch.full(qh.shape, -1, dtype=torch.int32, device=qh.device),
        torch.full(qh.shape, s - 2, dtype=torch.int32, device=qh.device),
        r_trips)
    dst = torch.where(ok, s_hat, i + 1)
    mis = (~ok & torch.isfinite(qh)).sum()
    return dst, mis


class ShardFanout:
    """Stacked shard state on the fan-out's devices + the fan-out.

    Built by ``dist.sharded.ShardedIndex`` from its per-shard handles;
    tagged with the shard epochs it froze at (the owner rebuilds on
    staleness).  ``lookup`` pads the batch to a D-divisible power-of-two
    bucket, runs the fan-out, and patches flagged rows (search escapes
    + exchange-capacity overflows) through the per-shard host views in
    O(#escapes).
    """

    def __init__(self, stacked: dict, statics: dict, bounds: np.ndarray,
                 router_params: np.ndarray, epochs: tuple,
                 min_bucket: int = 512, device=None):
        self.S = int(statics["n_shards"])
        self._stacked_np = stacked  # numpy originals feed the host views
        self.statics = statics
        self.epochs = tuple(epochs)
        self.min_bucket = int(min_bucket)
        devs = fanout_devices(resolve_device(device))
        self.D = largest_divisor_leq(self.S, len(devs))
        self.devices = devs[:self.D]
        s_loc = self.S // self.D
        # shard s on device s // s_loc: device j holds rows
        # [j * s_loc, (j + 1) * s_loc) of every stacked image
        self.stacked = [
            {k: torch.from_numpy(np.ascontiguousarray(
                v[j * s_loc:(j + 1) * s_loc])).to(dev)
             for k, v in stacked.items()}
            for j, dev in enumerate(self.devices)]
        key_wide = statics["key_wide"]
        if self.S > 1:
            b64 = np.asarray(bounds, np.float64)
            bh, blo = split_key_pair(b64)
            blo = blo if key_wide else np.zeros_like(blo)
            self._bounds_rounded = _round_key_repr(b64, key_wide)
            self.r_trips = int(np.ceil(np.log2(max(self.S - 1, 2)))) + 1
        else:
            bh = np.zeros(1, np.float32)
            blo = np.zeros(1, np.float32)
            self._bounds_rounded = np.zeros(0, np.float64)
            self.r_trips = 1
        rp = np.asarray(router_params, np.float32)
        # the router's tables, replicated on every device
        self._router = [
            tuple(torch.from_numpy(a).to(dev) for a in (bh, blo, rp))
            for dev in self.devices]
        self.slot_base = np.concatenate(
            [[0], np.cumsum(np.asarray(statics["n_slots"], np.int64))[:-1]])
        self._host_views: dict = {}
        self._cap_boost: dict = {}
        self.stats = {"fanout_lookups": 0, "mispredicts": 0,
                      "routed": 0, "escapes": 0, "cap_overflows": 0}

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, shards, bounds, router_params, *,
              min_bucket: int = 512) -> "ShardFanout":
        """Stack + place the shard images of a list of ``Index``
        handles, on the devices of the shards' device type.  Raises
        ``FanoutUnavailable`` when the fused graph cannot serve them
        exactly (see module doc)."""
        for sh in shards:
            if getattr(sh.mech, "plm", None) is None:
                raise FanoutUnavailable(
                    f"shard mechanism {sh.method!r} exports no PLM")
            wide, exact = sh._key_caps()
            if wide and not exact:
                raise FanoutUnavailable(
                    "shard keys alias in the f32 hi/lo pair representation")
        try:
            stacked, statics = stack_shard_images(shards)
        except _CapacityError as e:  # pragma: no cover - defensive
            raise FanoutUnavailable(str(e)) from None
        kw = statics["key_wide"]
        # the rounded shard boundaries must stay strictly interleaved
        # with the rounded shard contents, or routing (exact in rounded
        # space) could disagree with the single-device rounded search
        ext = np.array([_live_extent(sh.gapped) for sh in shards])
        firsts = _round_key_repr(ext[:, 0], kw)
        lasts = _round_key_repr(ext[:, 1], kw)
        if not (np.all(np.diff(firsts) > 0)
                and np.all(lasts[:-1] < firsts[1:])):
            raise FanoutUnavailable(
                "rounded shard boundaries are not strictly ordered")
        return cls(stacked, statics, bounds, router_params,
                   tuple(sh.epoch for sh in shards),
                   min_bucket=min_bucket, device=shards[0].device)

    def device_bytes(self) -> int:
        """Bytes of the stacked images on the fan-out's devices."""
        return sum(t.numel() * t.element_size()
                   for part in self.stacked for t in part.values())

    # ------------------------------------------------------------------
    def _shard_host_views(self, s: int) -> dict:
        """Lazily built host view of shard ``s``'s frozen image, shaped
        for ``resolve_escapes_host`` (exact in the device's rounded
        representation)."""
        v = self._host_views.get(s)
        if v is not None:
            return v
        st, a = self.statics, self._stacked_np
        sk = a["slot_key"][s].astype(np.float64)
        lk = a["link_keys"][s].astype(np.float64)
        pay = a["payload"][s].astype(np.int64)
        lp = a["link_payloads"][s].astype(np.int64)
        if st["key_wide"]:
            sk = sk + a["slot_key_lo"][s].astype(np.float64)
            lk = lk + a["link_keys_lo"][s].astype(np.float64)
        if st["wide"]:
            pay = (pay & 0xFFFFFFFF) | (
                a["payload_hi"][s].astype(np.int64) << 32)
            lp = (lp & 0xFFFFFFFF) | (
                a["link_payload_hi"][s].astype(np.int64) << 32)
        v = {"slot_key": sk, "payload": pay,
             "offsets": a["link_offsets"][s], "link_keys": lk,
             "link_payloads": lp, "max_chain": st["max_chain"],
             "key_wide": st["key_wide"]}
        self._host_views[s] = v
        return v

    def route_host(self, q64: np.ndarray) -> np.ndarray:
        """Exact host routing in the device's rounded representation —
        the authority the escape patch and the host fan-in path use."""
        if self.S == 1:
            return np.zeros(np.asarray(q64).shape[0], np.int64)
        qr = _round_key_repr(q64, self.statics["key_wide"])
        return np.searchsorted(self._bounds_rounded, qr,
                               side="right").astype(np.int64)

    # ------------------------------------------------------------------
    def _route_send(self, d: int, qh, ql, cap: int) -> dict:
        """Block ``d`` on its device: route, stable sort by destination,
        counting positions, and the ``(S, cap)`` send buffers (rows at
        ``pos >= cap`` stay out of them and are flagged ``dropped``)."""
        S = self.S
        key_wide = self.statics["key_wide"]
        bnd_hi, bnd_lo, rparams = self._router[d]
        nq = qh.shape[0]
        dst, mis = _route_block(qh, ql, bnd_hi, bnd_lo, rparams, S,
                                self.r_trips, key_wide)
        order = torch.sort(dst, stable=True).indices
        dsts = dst[order].long()
        qhs = qh[order]
        counts = torch.bincount(dst.long(), minlength=S)
        start = torch.cumsum(counts, 0) - counts
        pos = torch.arange(nq, device=qh.device) - start[dsts]
        dropped = (pos >= cap) & torch.isfinite(qhs)
        keep = pos < cap

        def send(vals, fill):
            buf = torch.full((S, cap), fill, dtype=vals.dtype,
                             device=qh.device)
            buf[dsts[keep], pos[keep]] = vals[keep]
            return buf

        inv = torch.empty_like(order)
        inv[order] = torch.arange(nq, device=qh.device)
        return {"dst": dst, "mis": mis, "dsts": dsts, "inv": inv,
                "pos_c": pos.clamp(0, cap - 1), "dropped": dropped,
                "send_h": send(qhs, float("inf")),
                "send_l": (send(ql[order], 0.0) if key_wide else None)}

    def _exchange_in(self, blocks, field: str, j: int, cap: int):
        """Device j's received rows: for each of its local shards, the
        cap rows of every source block, block after block — the
        reference's ``all_to_all`` + ``(D, s_loc, cap) -> (s_loc,
        D * cap)``."""
        s_loc = self.S // self.D
        dev = self.devices[j]
        recv = torch.stack([b[field][j * s_loc:(j + 1) * s_loc].to(dev)
                            for b in blocks])
        return recv.transpose(0, 1).reshape(s_loc, self.D * cap)

    def _exchange_back(self, per_dev, d: int, cap: int):
        """Block d's ``(S, cap)`` result rows gathered back from every
        device (the second ``all_to_all``)."""
        s_loc = self.S // self.D
        dev = self.devices[d]
        return torch.cat([v.reshape(s_loc, self.D, cap)[:, d].to(dev)
                          for v in per_dev])

    def _search(self, j: int, rq_h, rq_l):
        """The per-shard fused search + epilogue over device j's local
        shards, batched over the shard axis."""
        st, a = self.statics, self.stacked[j]
        return fused_pipeline(
            rq_h, rq_l, a["slot_key"], a["slot_key_lo"], a["payload"],
            a["payload_hi"], a["link_offsets"], a["link_keys"],
            a["link_keys_lo"], a["link_payloads"], a["link_payload_hi"],
            a["rank_table"], a["rank_scale"], trips=st["trips"],
            max_chain=st["max_chain"], wide=st["wide"],
            key_wide=st["key_wide"])

    def _run(self, qh: np.ndarray, ql: np.ndarray, cap: int):
        """The fan-out over a padded bucket: per block on its device,
        route and send; exchange; search; exchange back; home.  Returns
        host arrays ``(out, out_hi, slot, found, fb, dst, mis, n_drop)``
        in bucket order."""
        D = self.D
        wide = self.statics["wide"]
        nq_loc = qh.shape[0] // D
        blocks = []
        for d, dev in enumerate(self.devices):
            sl = slice(d * nq_loc, (d + 1) * nq_loc)
            blocks.append(self._route_send(
                d, torch.from_numpy(qh[sl]).to(dev),
                torch.from_numpy(ql[sl]).to(dev), cap))
        per_dev = []
        for j in range(D):
            rq_h = self._exchange_in(blocks, "send_h", j, cap)
            rq_l = (self._exchange_in(blocks, "send_l", j, cap)
                    if self.statics["key_wide"] else torch.zeros_like(rq_h))
            out, out_hi, slot, resolved, fb = self._search(j, rq_h, rq_l)
            flags = (resolved.to(torch.int8)
                     | (fb.to(torch.int8) << 1))
            per_dev.append((out, out_hi if wide else None, slot, flags))
        parts = []
        for d, b in enumerate(blocks):
            def home(k, d=d, b=b):  # per-shard rows -> block d's order
                back = self._exchange_back([p[k] for p in per_dev], d, cap)
                return back[b["dsts"], b["pos_c"]][b["inv"]]
            fl = home(3)
            out_q = home(0)
            fb_q = ((fl >> 1) & 1).bool() | b["dropped"][b["inv"]]
            found_q = (fl & 1).bool() & ~fb_q
            parts.append([t.cpu().numpy() for t in (
                out_q, home(1) if wide else out_q, home(2), found_q, fb_q,
                b["dst"])] + [int(b["mis"]), int(b["dropped"].sum())])
        cols = [np.concatenate([p[i] for p in parts]) for i in range(6)]
        return (*cols, sum(p[6] for p in parts), sum(p[7] for p in parts))

    # ------------------------------------------------------------------
    def _bucket(self, n: int) -> int:
        # D-divisible with a power-of-two per-device block
        nq_loc = _round_pow2(-(-max(n, self.min_bucket) // self.D))
        return self.D * nq_loc

    def _cap_for(self, bucket: int) -> int:
        nq_loc = bucket // self.D
        base = _round_pow2(max(16, -(-2 * nq_loc // max(self.S, 1))))
        cap = base * self._cap_boost.get(bucket, 1)
        return min(cap, _round_pow2(nq_loc))

    def lookup(self, q64: np.ndarray):
        """Fan-out lookup: ``(payload_i64, slot_i64 global, found,
        shard_of, n_escapes, n_mispredict)`` in caller order, exact
        (flagged rows host-patched)."""
        q64 = np.asarray(q64, np.float64)
        n = q64.shape[0]
        bucket = self._bucket(n)
        cap = self._cap_for(bucket)
        qp = np.full(bucket, np.inf, np.float64)
        qp[:n] = q64
        qh, ql = split_queries(qp, self.statics["key_wide"])
        if not self.statics["key_wide"]:
            ql = np.zeros(bucket, np.float32)
        out, out_hi, slot, found, fb, dst, mis, n_drop = self._run(
            qh, ql, cap)
        if n_drop:
            # sticky per-bucket escalation, like the engine's escape
            # buffer: the flagged rows still resolve exactly (host
            # patch below); later calls get a wider exchange
            self._cap_boost[bucket] = min(
                self._cap_boost.get(bucket, 1) * 4, 64)
            self.stats["cap_overflows"] += 1
        pay = out[:n].astype(np.int64)
        if self.statics["wide"]:
            pay = (out_hi[:n].astype(np.int64) << 32) | (pay & 0xFFFFFFFF)
        slot_np = slot[:n].astype(np.int64)
        found_np = np.array(found[:n], bool)
        fb_np = fb[:n]
        shard_of = dst[:n].astype(np.int64)
        idx = np.flatnonzero(fb_np)
        if idx.size:
            # patch against the shard the fan-out routed to — routing
            # is exact, so this is also the host-rounded authority
            for s in np.unique(shard_of[idx]):
                rows = idx[shard_of[idx] == s]
                r, res, p = resolve_escapes_host(
                    self._shard_host_views(int(s)), q64[rows])
                pay[rows] = p
                slot_np[rows] = r
                found_np[rows] = res
        glob = slot_np >= 0
        slot_np = np.where(glob, slot_np + self.slot_base[shard_of], -1)
        self.stats["fanout_lookups"] += 1
        self.stats["routed"] += n
        self.stats["mispredicts"] += int(mis)
        self.stats["escapes"] += int(idx.size)
        return pay, slot_np, found_np, shard_of, int(idx.size), int(mis)
