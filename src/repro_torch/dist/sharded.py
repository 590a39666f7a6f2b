"""Range-partitioned ``ShardedIndex``: a learned router over learned
indexes (the two-stage decomposition of "A Scalable Learned Index
Scheme in Storage Systems", at shard granularity).

A copy of the reference's ``repro.dist.sharded``.  Its only changes:
``build`` and ``restore`` take ``device`` (cuda unless ``"cpu"``; every
shard's device state lives there, and split halves are built on their
shard's device), and the imports name the port's modules.

Architecture
------------
* **Shards** are full ``core.Index`` handles over disjoint key
  ranges; shard ``s`` owns ``[first_key[s], first_key[s+1])`` (the last
  shard is right-open to +inf, the first left-open to -inf).  Keys that
  arrive BETWEEN shards route LEFT, to the predecessor's shard, for
  both lookups and ingest — so the routing boundaries never drift and a
  lookup always lands where the matching ingest landed.
* **Router** (``ShardRouter``): the paper's RMI idea at shard
  granularity — a two-segment linear model fit on the shard boundary
  keys predicts the shard id in one multiply-add per query, and an
  exact ``searchsorted`` backstop certifies it.  Routing is therefore
  EXACT by construction; the model only determines how often the
  backstop is a gather (hit) vs a bisect (mispredict, counted).
* **Fused fan-out** (``kernels.shard_fanout.ShardFanout``): the
  per-shard frozen images are stacked, placed over the visible devices
  of the shards' type (shard s on device s // (S // D)), and one
  fan-out serves a whole batch: route -> bucket-count -> exchange ->
  per-shard fused search -> inverse-permutation gather.  Built lazily
  and tagged with the shard epochs; any shard
  mutation makes it stale and the next large lookup rebuilds it.
* **Ingest** is shard-local: the exact host route groups the batch, and
  every shard runs its OWN ``Index.ingest`` — on engines with the fused
  write graph enabled that is the single-dispatch path, and an in-graph
  abort falls back to that shard's host partition only.  The
  per-shard ``IngestReport``s aggregate into a ``ShardedIngestReport``
  (sums preserve the ``slot + chain == n`` invariant).
* **Rebalance**: when skewed writes pile onto one shard past the
  occupancy watermark (``split_occupancy_factor`` x mean keys, floored
  by ``min_split_keys``) or its chains exceed ``split_chain_depth``,
  ``split_shard`` extracts the live (key, payload) set from the gapped
  array + CSR chains, rebuilds two gap-inserted halves around the
  median occupied key, splices them into the shard list, and patches
  the router with the new boundary.

Result contract: ``lookup`` returns the same typed ``LookupResult``
with payloads/found BIT-IDENTICAL to a single-device ``Index`` built
over the same key/payload set (both key widths;
tests/test_torch_sharded.py holds the port to the reference on every
case of the reference's tests/test_sharded_index.py).  Slots are
physical and the sharded
physical layout legitimately differs; they come back offset by the
per-shard slot base so they remain unique and monotone per shard.

``ShardedIndex`` is duck-type compatible with the single ``Index``
handle where it matters: ``lookup(queries)`` / ``ingest(keys,
payloads)`` / ``epoch`` / ``stats`` — so ``serving.MicroBatchQueue``
aggregates over a sharded backend unchanged.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from ..core import keys64 as _k64
from ..core import sampling as _sampling
from ..core.handle import Index
from ..core.results import IngestReport, LookupResult
from ..device import resolve_device

__all__ = ["ShardRouter", "ShardedIndex", "ShardedIngestReport"]


@dataclasses.dataclass(frozen=True)
class ShardedIngestReport(IngestReport):
    """Aggregate of the per-shard reports (device="sharded").  The
    scalar counters are sums — ``slot + chain == n`` and the contested
    bound survive summation — and ``per_shard`` keeps the individual
    ``(shard_id, IngestReport)`` pairs for telemetry."""

    per_shard: tuple = ()


class ShardRouter:
    """Two-segment linear-on-boundaries learned router with an exact
    backstop.  ``bounds`` are the S-1 internal boundaries (first key of
    shards 1..S-1); ``route`` is EXACT (searchsorted authority), the
    learned prediction is raced against it only to count mispredicts —
    the device graph uses the same model with an in-graph exact bisect
    backstop (``kernels.shard_fanout._route_block``)."""

    def __init__(self, bounds: np.ndarray,
                 lo_key: Optional[float] = None):
        self.bounds = np.asarray(bounds, np.float64).copy()
        if self.bounds.size and not np.all(np.diff(self.bounds) > 0):
            raise ValueError("shard boundaries must be strictly increasing")
        # global min key anchors (lo_key -> shard 0) so queries inside
        # shard 0 interpolate instead of rounding up to the first
        # boundary's anchor (without it the fit has no point below y=1)
        self.lo_key = None if lo_key is None else float(lo_key)
        self.stats = {"routed": 0, "mispredicted": 0}
        self._fit()

    @property
    def n_shards(self) -> int:
        return int(self.bounds.shape[0]) + 1

    # ------------------------------------------------------------------
    def _fit(self) -> None:
        b = self.bounds
        if b.size == 0:
            self._params = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
            return
        # anchor boundary b_i at y = (i+1) - 0.5: shard j's key range
        # then maps to (j - 0.5, j + 0.5) and rint() recovers j across
        # the WHOLE range, not just its left half (the lo_key anchor is
        # shard 0's left edge, y = -0.5)
        anchors = b
        ys = np.arange(1, b.shape[0] + 1, dtype=np.float64) - 0.5
        if self.lo_key is not None and self.lo_key < b[0]:
            anchors = np.concatenate([[self.lo_key], b])
            ys = np.concatenate([[-0.5], ys])
        x0 = float(anchors[0])
        split = float(anchors[anchors.shape[0] // 2])
        xs = anchors - x0
        hi = anchors >= split

        def seg(x: np.ndarray, y: np.ndarray, empty_icept: float):
            if x.size == 0:
                return 0.0, empty_icept
            if x.size == 1:
                # an anchor sits on a shard's LEFT edge (y = j - 0.5);
                # nudge into the shard interior, else rint's round-half-
                # to-even sends every key at/above it one shard low
                return 0.0, float(y[0]) + 0.25
            a = np.vstack([x, np.ones_like(x)]).T
            slope, icept = np.linalg.lstsq(a, y, rcond=None)[0]
            if not (slope >= 0.0) or not np.isfinite(icept):
                return 0.0, float(np.mean(y))
            return float(slope), float(icept)

        s0, i0 = seg(xs[~hi], ys[~hi], 0.0)
        s1, i1 = seg(xs[hi], ys[hi], float(ys[-1]))
        self._params = (x0, s0, i0, s1, i1, split)

    def predict(self, q: np.ndarray) -> np.ndarray:
        """Learned shard-id prediction (clipped round) — NOT exact; use
        ``route`` for answers."""
        x0, s0, i0, s1, i1, split = self._params
        q = np.asarray(q, np.float64)
        x = q - x0
        pred = np.where(q >= split, x * s1 + i1, x * s0 + i0)
        return np.clip(np.rint(pred), 0, self.n_shards - 1).astype(np.int64)

    def route(self, q: np.ndarray) -> np.ndarray:
        """Exact f64 shard id per query (route-left semantics: a key
        between shards belongs to its predecessor's shard)."""
        q = np.asarray(q, np.float64)
        self.stats["routed"] += int(q.shape[0])
        if self.bounds.size == 0:
            return np.zeros(q.shape[0], np.int64)
        exact = np.searchsorted(self.bounds, q, side="right").astype(np.int64)
        self.stats["mispredicted"] += int(
            np.count_nonzero(self.predict(q) != exact))
        return exact

    def insert_boundary(self, pos: int, key: float) -> None:
        """Patch in the boundary of a split: shard ``pos`` became
        ``pos`` (left half) and ``pos + 1`` (right half, first key
        ``key``).  Refits the model on the new boundary set."""
        self.bounds = np.insert(self.bounds, pos, float(key))
        if not np.all(np.diff(self.bounds) > 0):  # pragma: no cover
            raise ValueError("split boundary breaks the shard ordering")
        self._fit()

    def device_params(self) -> np.ndarray:
        """The f32 octet the in-graph router consumes: [x0_hi, x0_lo,
        slope0, icept0, slope1, icept1, split_hi, split_lo]."""
        from ..kernels.freeze import split_key_pair
        x0, s0, i0, s1, i1, split = self._params
        hi, lo = split_key_pair(np.array([x0, split], np.float64))
        return np.array([hi[0], lo[0], s0, i0, s1, i1, hi[1], lo[1]],
                        np.float32)


class ShardedIndex:
    """Range-partitioned learned index (see module doc)."""

    def __init__(self, shards: List[Index], router: ShardRouter, *,
                 method: str = "pgm", sample_rate: float = 1.0,
                 gap_rho: float = 0.1, mech_kwargs: Optional[dict] = None,
                 split_occupancy_factor: float = 4.0,
                 min_split_keys: int = 4096, split_chain_depth: int = 24,
                 min_device_batch: int = 512):
        if len(shards) != router.n_shards:
            raise ValueError(
                f"{len(shards)} shards vs router for {router.n_shards}")
        self.shards = list(shards)
        self.router = router
        self.method = method
        self.sample_rate = sample_rate
        self.gap_rho = gap_rho
        self.mech_kwargs = dict(mech_kwargs or {})
        self.split_occupancy_factor = float(split_occupancy_factor)
        self.min_split_keys = int(min_split_keys)
        self.split_chain_depth = int(split_chain_depth)
        self.min_device_batch = int(min_device_batch)
        self._mutations = 0
        self._fan = None
        self._fan_failed_tag: Optional[tuple] = None
        self.stats = {"lookups": 0, "ingests": 0, "splits": 0,
                      "retrains": 0, "fanout_lookups": 0,
                      "grouped_lookups": 0, "rebalance_seconds": 0.0}

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, keys: np.ndarray, *, shards: int, method: str = "pgm",
              sample_rate: float = 1.0, gap_rho: float = 0.1,
              rng: Optional[np.random.Generator] = None,
              payloads: Optional[np.ndarray] = None,
              min_device_batch: int = 512,
              fused_ingest_enabled: Optional[bool] = None,
              device=None, **mech_kwargs) -> "ShardedIndex":
        """Equal-count range partition + per-shard gap-inserted builds.

        Payloads default to the GLOBAL key position (``arange(n)``
        sliced per shard), exactly what a single-device ``Index.build``
        stores — this is what makes the bit-identity contract hold.
        ``gap_rho`` must be positive: shards serve the dynamic gapped
        path (a static sharded build has nothing to rebalance).

        Each shard builds with its OWN child generator spawned from
        ``rng`` (``core.sampling.spawn_rngs``), so sampled per-shard
        builds draw independent streams — one shared generator would
        sample every shard identically.  ``method="auto"`` runs the
        MDL auto-tuner PER SHARD (each shard's key distribution picks
        its own mechanism/budget — ``core.tuning``).

        Every shard's device state lives on ``device`` (cuda unless
        ``device="cpu"``; without CUDA the default raises).
        """
        dev = resolve_device(device)
        keys = _k64.write_keys(keys, "ShardedIndex.build")
        s = int(shards)
        if keys.ndim != 1:
            raise ValueError("need a 1-D key array")
        if s < 1:
            raise ValueError("shards must be >= 1")
        if gap_rho <= 0.0:
            raise ValueError("ShardedIndex requires gap insertion "
                             "(gap_rho > 0)")
        n = keys.shape[0]
        if n < 2 * s:
            raise ValueError(f"{n} keys cannot fill {s} shards "
                             "(need >= 2 per shard)")
        if not bool(np.all(np.diff(keys) > 0)):
            raise ValueError("keys must be sorted, strictly increasing")
        if payloads is None:
            payloads = np.arange(n, dtype=np.int64)
        else:
            payloads = np.asarray(payloads, np.int64)
            if payloads.shape != keys.shape:
                raise ValueError("payloads must match keys 1:1")
        cuts = np.round(np.linspace(0, n, s + 1)).astype(np.int64)
        handles = []
        shard_rngs = _sampling.spawn_rngs(rng, s)
        for (a, b), srng in zip(zip(cuts[:-1], cuts[1:]), shard_rngs):
            sh = Index.build(keys[a:b], method=method,
                             sample_rate=sample_rate, gap_rho=gap_rho,
                             rng=srng, payloads=payloads[a:b],
                             device=dev, **mech_kwargs)
            sh.min_device_batch = min_device_batch
            sh.fused_ingest_enabled = fused_ingest_enabled
            handles.append(sh)
        router = ShardRouter(keys[cuts[1:-1]], lo_key=keys[0])
        return cls(handles, router, method=method, sample_rate=sample_rate,
                   gap_rho=gap_rho, mech_kwargs=mech_kwargs,
                   min_device_batch=min_device_batch)

    # ------------------------------------------------------------------
    @property
    def epoch(self) -> int:
        """Monotone sharded-state version: total shard mutations plus
        topology changes (splits count through ``_mutations``)."""
        return int(sum(sh.epoch for sh in self.shards)) + self._mutations

    @property
    def n_keys(self) -> int:
        return int(sum(sh.gapped.n_keys for sh in self.shards))

    def _slot_bases(self) -> np.ndarray:
        sizes = np.array([sh.gapped.n_slots for sh in self.shards],
                         np.int64)
        return np.concatenate([[0], np.cumsum(sizes)[:-1]])

    # ------------------------------------------------------------------
    # fused fan-out (lazy, epoch-tagged)
    # ------------------------------------------------------------------
    def _fanout(self):
        tag = tuple(sh.epoch for sh in self.shards)
        if self._fan is not None and self._fan.epochs == tag:
            return self._fan
        if self._fan_failed_tag == tag:
            return None
        from ..kernels.shard_fanout import FanoutUnavailable, ShardFanout
        boosts = dict(self._fan._cap_boost) if self._fan is not None else {}
        try:
            fan = ShardFanout.build(self.shards, self.router.bounds,
                                    self.router.device_params(),
                                    min_bucket=self.min_device_batch)
        except FanoutUnavailable:
            self._fan = None
            self._fan_failed_tag = tag
            return None
        fan._cap_boost.update(boosts)  # keep the exchange sizing learned
        self._fan = fan                # under previous epochs
        self._fan_failed_tag = None
        return fan

    # ------------------------------------------------------------------
    def lookup(self, queries, *, backend: Optional[str] = None,
               queries_sorted: bool = False) -> LookupResult:
        """Batched lookup.  Large batches (>= ``min_device_batch``) run
        the single fused fan-out dispatch; small batches and explicit
        per-shard backends take the exact host route + grouped per-shard
        lookups.  ``backend="fanout"`` forces the fan-out."""
        queries = np.atleast_1d(np.asarray(queries, np.float64))
        self.stats["lookups"] += 1
        n = queries.shape[0]
        if backend == "fanout" or (
                backend is None and n >= self.min_device_batch):
            fan = self._fanout()
            if fan is not None:
                pay, slot, found, _shard, esc, mis = fan.lookup(queries)
                self.stats["fanout_lookups"] += 1
                self.router.stats["routed"] += n
                self.router.stats["mispredicted"] += mis
                return LookupResult(
                    payloads=pay, slots=slot, found=found,
                    backend="sharded-fanout", epoch=self.epoch,
                    fallbacks=esc)
            if backend == "fanout":
                raise RuntimeError(
                    "shard fan-out unavailable for this shard set "
                    "(non-PLM mechanism or aliasing keys)")
        dst = self.router.route(queries)
        pay = np.full(n, -1, np.int64)
        slot = np.full(n, -1, np.int64)
        found = np.zeros(n, bool)
        fallbacks = 0
        bases = self._slot_bases()
        for s in np.unique(dst):
            rows = np.flatnonzero(dst == s)
            r = self.shards[s].lookup(queries[rows], backend=backend)
            pay[rows] = np.asarray(r.payloads, np.int64)
            sl = np.asarray(r.slots, np.int64)
            slot[rows] = np.where(sl >= 0, sl + bases[s], -1)
            found[rows] = np.asarray(r.found, bool)
            fallbacks += int(r.fallbacks)
        self.stats["grouped_lookups"] += 1
        return LookupResult(payloads=pay, slots=slot, found=found,
                            backend="sharded-host", epoch=self.epoch,
                            fallbacks=fallbacks)

    # ------------------------------------------------------------------
    def ingest(self, keys, payloads) -> ShardedIngestReport:
        """Shard-local batched insert: the exact route groups the batch
        (stable — per-shard relative order is the caller's), every
        touched shard runs its own ``Index.ingest`` (fused single
        dispatch where that shard's engine allows; an abort falls back
        to THAT shard's host partition only), and the reports
        aggregate.  Finishes with the rebalance watermark check."""
        keys = np.atleast_1d(_k64.write_keys(keys, "ShardedIndex.ingest"))
        payloads = np.atleast_1d(np.asarray(payloads, np.int64))
        if keys.shape != payloads.shape:
            raise ValueError("payloads must match keys 1:1")
        t0 = time.perf_counter()
        dst = self.router.route(keys)
        reports = []
        for s in np.unique(dst):
            rows = np.flatnonzero(dst == s)
            reports.append(
                (int(s), self.shards[s].ingest(keys[rows], payloads[rows])))
        self.stats["ingests"] += 1
        self._mutations += 1
        self.maybe_rebalance()
        reps = [r for _, r in reports]
        return ShardedIngestReport(
            n=sum(r.n for r in reps), slot=sum(r.slot for r in reps),
            chain=sum(r.chain for r in reps),
            contested=sum(r.contested for r in reps),
            epoch=self.epoch, device="sharded",
            device_elems=sum(r.device_elems for r in reps),
            seconds=time.perf_counter() - t0, placement="sharded",
            abort_reasons=tuple(
                rr for r in reps for rr in r.abort_reasons),
            fused_aborts=sum(r.fused_aborts for r in reps),
            split_commits=sum(r.split_commits for r in reps),
            per_shard=tuple(reports))

    # ------------------------------------------------------------------
    # durability (serving/wal.py crash recovery rides on these)
    # ------------------------------------------------------------------
    def save_snapshot(self, directory, *, step: Optional[int] = None,
                      keep: int = 3, wal_lsn: int = 0) -> str:
        """Checkpoint every shard through ``Index.save_snapshot`` (one
        ``train/checkpoint.py``-format subdirectory per shard) plus a
        ``sharded_manifest.json`` capturing the router boundaries and
        topology knobs.  The manifest is published last (tmp→rename),
        so a crash mid-save can never shadow a complete checkpoint with
        a partial one."""
        import json
        import os
        s = int(step if step is not None else self.epoch)
        d = str(directory)
        os.makedirs(d, exist_ok=True)
        for i, sh in enumerate(self.shards):
            sh.save_snapshot(os.path.join(d, f"shard_{i:03d}"), step=s,
                             keep=keep)
        manifest = {
            "kind": "sharded",
            "n_shards": len(self.shards),
            "bounds": [float(b) for b in self.router.bounds],
            "lo_key": self.router.lo_key,
            "method": self.method,
            "sample_rate": float(self.sample_rate),
            "gap_rho": float(self.gap_rho),
            "mech_kwargs": self.mech_kwargs,
            "split_occupancy_factor": self.split_occupancy_factor,
            "min_split_keys": self.min_split_keys,
            "split_chain_depth": self.split_chain_depth,
            "min_device_batch": self.min_device_batch,
            "mutations": self._mutations,
            "epoch": int(self.epoch),
            "step": s,
            "wal_lsn": int(wal_lsn),
        }
        tmp = os.path.join(d, "sharded_manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(d, "sharded_manifest.json"))
        return d

    @classmethod
    def restore(cls, directory, step: Optional[int] = None, device=None):
        """Load a ``save_snapshot`` checkpoint -> ``(sharded, extra)``.
        Shards restore bit-identically, their device state on ``device``
        (cuda unless ``device="cpu"``); the router refits on the saved
        boundaries (deterministic), so routing matches the saved
        instance exactly."""
        import json
        import os
        dev = resolve_device(device)
        d = str(directory)
        with open(os.path.join(d, "sharded_manifest.json")) as f:
            m = json.load(f)
        s = int(step) if step is not None else int(m["step"])
        shards = []
        for i in range(int(m["n_shards"])):
            sh, _ = Index.restore(os.path.join(d, f"shard_{i:03d}"),
                                  step=s, device=dev)
            shards.append(sh)
        return cls._from_manifest(shards, m), m

    @classmethod
    def _from_manifest(cls, shards, m: dict) -> "ShardedIndex":
        """The sharded index over ``shards`` (one per manifest shard, in
        order) with the manifest ``m``'s knobs, router and mutation
        count: the one reader of ``sharded_manifest.json``'s fields,
        shared by ``restore`` and ``convert.sharded_from_state``."""
        for sh in shards:
            sh.min_device_batch = int(m["min_device_batch"])
        router = ShardRouter(np.array(m["bounds"], np.float64),
                             lo_key=m["lo_key"])
        out = cls(shards, router, method=m["method"],
                  sample_rate=float(m["sample_rate"]),
                  gap_rho=float(m["gap_rho"]),
                  mech_kwargs=dict(m["mech_kwargs"]),
                  split_occupancy_factor=float(m["split_occupancy_factor"]),
                  min_split_keys=int(m["min_split_keys"]),
                  split_chain_depth=int(m["split_chain_depth"]),
                  min_device_batch=int(m["min_device_batch"]))
        out._mutations = int(m["mutations"])
        return out

    # ------------------------------------------------------------------
    # split / rebalance
    # ------------------------------------------------------------------
    def _split_candidate(self) -> Optional[int]:
        sizes = np.array([sh.gapped.n_keys for sh in self.shards],
                         np.float64)
        mean = float(sizes.mean())
        cand, cand_size = None, -1.0
        for s, sh in enumerate(self.shards):
            ga = sh.gapped
            if ga.n_keys < max(self.min_split_keys, 4):
                continue
            if (ga.n_keys > self.split_occupancy_factor * mean
                    or ga.links.max_chain > self.split_chain_depth):
                if sizes[s] > cand_size:
                    cand, cand_size = s, float(sizes[s])
        return cand

    def _retrain_candidate(self) -> Optional[int]:
        """A shard past the chain-depth watermark that is too SMALL to
        split (below ``min_split_keys``): splitting can't help it, but
        a sampled retrain flattens its chains in O(n_s) learning +
        O(n_shard) placement.  Deepest chain wins."""
        cand, cand_depth = None, -1
        for s, sh in enumerate(self.shards):
            ga = sh.gapped
            if ga.n_keys >= max(self.min_split_keys, 4):
                continue  # big enough to split — the split path owns it
            depth = ga.links.max_chain
            if depth > self.split_chain_depth and depth > cand_depth:
                cand, cand_depth = s, depth
        return cand

    def maybe_rebalance(self,
                        force_shard: Optional[int] = None) -> Optional[dict]:
        """Split the most-overloaded shard if any is past the
        occupancy/chain-depth watermark (or split ``force_shard``
        unconditionally).  When nothing is splittable, a shard past the
        chain-depth watermark but below the split size floor gets a
        sampled RETRAIN instead (same trigger machinery, cheaper
        remedy).  Returns the split/retrain record or None."""
        s = force_shard if force_shard is not None else self._split_candidate()
        if s is not None:
            return self.split_shard(int(s))
        if force_shard is None:
            r = self._retrain_candidate()
            if r is not None:
                return self.retrain(shard=int(r))
        return None

    def retrain(self, shard: Optional[int] = None,
                sample_rate: Optional[float] = None,
                rng: Optional[np.random.Generator] = None) -> dict:
        """Sampled refit of one shard (or every shard when ``shard`` is
        None) via ``Index.retrain`` — independent child generators per
        shard, epoch bumped through ``_mutations`` so pinned
        ``ShardedSnapshot``s stay isolated (shard arrays are replaced,
        never mutated).  Returns an aggregate record."""
        t0 = time.perf_counter()
        ids = list(range(len(self.shards))) if shard is None else [int(shard)]
        rngs = _sampling.spawn_rngs(rng, len(ids))
        recs = []
        for s, srng in zip(ids, rngs):
            recs.append((s, self.shards[s].retrain(
                sample_rate=sample_rate, rng=srng)))
        self._mutations += 1
        dt = time.perf_counter() - t0
        self.stats["retrains"] += 1
        self.stats["rebalance_seconds"] += dt
        return {"kind": "retrain", "shards": [s for s, _ in recs],
                "seconds": dt, "per_shard": recs}

    def split_shard(self, s: int,
                    rng: Optional[np.random.Generator] = None) -> dict:
        """Split shard ``s`` at its median live key: extract the live
        (key, payload) set (``GappedArray.live_items``), rebuild two
        gap-inserted halves with the same mechanism settings (each with
        its own spawned generator), splice them in, and patch the
        router boundary."""
        sh = self.shards[s]
        ga = sh.gapped
        t0 = time.perf_counter()
        k, p = ga.live_items()
        n = k.shape[0]
        if n < 4:
            raise ValueError(f"shard {s} too small to split ({n} keys)")
        mid = n // 2
        halves = []
        half_rngs = _sampling.spawn_rngs(rng, 2)
        for (a, b), hrng in zip(((0, mid), (mid, n)), half_rngs):
            h = Index.build(k[a:b], method=self.method,
                            sample_rate=self.sample_rate,
                            gap_rho=self.gap_rho, payloads=p[a:b],
                            rng=hrng, device=sh.device, **self.mech_kwargs)
            h.min_device_batch = sh.min_device_batch
            h.fused_ingest_enabled = sh.fused_ingest_enabled
            halves.append(h)
        self.shards[s: s + 1] = halves
        self.router.insert_boundary(s, float(k[mid]))
        self._mutations += 1
        dt = time.perf_counter() - t0
        self.stats["splits"] += 1
        self.stats["rebalance_seconds"] += dt
        return {"shard": int(s), "boundary": float(k[mid]),
                "n_left": int(mid), "n_right": int(n - mid),
                "seconds": dt}
