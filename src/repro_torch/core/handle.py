"""The port's ``Index`` handle: ``repro.core.Index``'s read path and
its §5.3 write path.

``Index.build`` learns on the host (§4 sampling, mechanism fit, Eq. 3
gap insertion, refit) and places the keys in the gapped array on one of
two paths that give the same arrays: on the index's device
(``kernels.place.build_gapped_device``) when that device is CUDA and
the mechanism predicts through its PLM (``pgm``, ``fiting``), on the
host otherwise (``gaps.build_gapped``, a copy of the reference's: CPU
indexes, ``rmi``, ``btree``).  ``lookup`` answers batched point lookups
on a backend from the registry:

=============  ======  ==========  =========  ==========================
name           device  wide keys   min batch  notes
=============  ======  ==========  =========  ==========================
fused          yes     yes (hi/lo  512        the hand-written CUDA
                       f32 pair)              fused-lookup kernel, one
                                              launch per batch
pallas         yes     no          512        LEGACY multi-op path
                                              around the hand-written
                                              CUDA legacy-lookup kernel
                                              (debug / reference)
xla-windowed   yes     yes (hi/lo  512        legacy multi-op windowed
                       f32 pair)              rank / bisect in torch
                                              ops (debug / reference)
numpy-oracle   no      yes (f64)   0          host reference; exact
=============  ======  ==========  =========  ==========================

``lookup(backend=None)`` sends small batches to ``numpy-oracle`` and
the rest to ``fused``; the legacy ``pallas`` / ``xla-windowed`` stages
serve only when asked for by name.  A request that cannot serve the
index (``pallas`` with keys past f32 exactness, any device backend
with keys that alias in the f32 hi/lo pair) raises with the
capability that failed.

Writes (``ingest``, ``remove``, the scalar and batch ``insert`` /
``delete`` / ``update``) mutate the host state and bump ``epoch``.
When the device state is at the host epoch, ``ingest`` computes the
batch's placement primitives on the device (the CUDA ingest-place
kernel, escape rows patched on the host), or runs the whole batch as
one fused ingest whose output tensors the engine adopts; the device
then follows by a delta update of the changed elements, or by a full
refreeze past the policy thresholds or when a frozen capacity no
longer holds.  The device gates (``n_slots < 2^24`` for device
placement, ``< 2^22`` for the fused ingest) are the reference's, so the
reports' ``placement`` and ``device`` labels match it.

Durability and self-tuning follow the reference: ``save_snapshot`` /
``restore`` write and read its checkpoint layout (either package
restores the other's snapshots), ``build(method="auto")`` runs the §3
MDL auto-tuner, ``retrain`` refits the live state on a sample and
``mdl`` scores it.  A restore or a retrain leaves the device state
empty; the first device lookup refreezes on ``device``.

The device is ``cuda`` unless the index is given ``device="cpu"``;
without CUDA the default raises.  ``build(shards=...)`` returns the
range-partitioned ``dist.ShardedIndex`` (same call surface, per-shard
gap-inserted builds + a learned router) on the same device.
"""

from __future__ import annotations

import copy as _copy
import dataclasses
import io
import pickle
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..spans import span
from . import gaps as _gaps
from . import mdl as _mdl
from . import sampling as _sampling
from .mechanisms import MECHANISMS
from .results import IngestReport, LookupResult, host_lookup_result

__all__ = ["Index", "BackendSpec", "BACKENDS"]


def _mechanism_factory(method: str, **kwargs):
    cls = MECHANISMS[method]
    return lambda: cls(**kwargs)


# A pickle names the module of every class it holds.  The mechanisms
# are a verbatim copy of the reference's, so a snapshot's mechanism is
# pickled under the reference's module name (which the reference's
# stock ``pickle.loads`` resolves) and read back through a map to the
# port's copy: snapshots cross-restore both ways.
_PORT_MECH = __package__ + ".mechanisms"
_REF_MECH = "repro.core.mechanisms"


class _MechPickler(pickle._Pickler):
    """Writes classes of the port's ``mechanisms`` under
    ``repro.core.mechanisms``, without importing the reference."""

    def save_global(self, obj, name=None):
        # STACK_GLOBAL: the protocol is pickle.DEFAULT_PROTOCOL (>= 4)
        if getattr(obj, "__module__", None) != _PORT_MECH:
            return super().save_global(obj, name)
        self.save(_REF_MECH)
        self.save(name or obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _MechUnpickler(pickle.Unpickler):
    """Reads ``repro.core.mechanisms`` classes as the port's copies and
    refuses every other module of the reference."""

    def find_class(self, module, name):
        if module == _REF_MECH:
            module = _PORT_MECH
        elif module == "repro" or module.startswith("repro."):
            raise pickle.UnpicklingError(
                f"{module}.{name}: a snapshot's mechanism may name only "
                f"{_REF_MECH} of the reference")
        return super().find_class(module, name)


def _dump_mech(mech) -> bytes:
    buf = io.BytesIO()
    _MechPickler(buf, protocol=pickle.DEFAULT_PROTOCOL).dump(mech)
    return buf.getvalue()


def _load_mech(data: bytes):
    return _MechUnpickler(io.BytesIO(data)).load()


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Capability record for one lookup backend."""

    name: str
    device: bool            # runs on the frozen device arrays
    wide_keys: bool         # exact beyond f32 (2^24) key magnitudes
    min_batch: int          # below this the backend loses to the host
    engine_backend: Optional[str]  # kernels.ops.QueryEngine stage

    def available(self) -> bool:
        """Whether the backend may be picked without being asked for.
        Host backends always are.  The reference's ``pallas`` is picked
        only on a TPU, where its kernel is native; the port's is picked
        only where ``torch.cuda.is_available()``, where
        csrc/lookup_kernel.cu is native (on the CPU an explicit request
        runs the kernel's plain version)."""
        if not self.device:
            return True
        if self.name == "pallas":
            return torch.cuda.is_available()
        return True


BACKENDS: Dict[str, BackendSpec] = {
    "fused": BackendSpec("fused", device=True, wide_keys=True,
                         min_batch=512, engine_backend="fused"),
    "pallas": BackendSpec("pallas", device=True, wide_keys=False,
                          min_batch=512, engine_backend="pallas"),
    "xla-windowed": BackendSpec("xla-windowed", device=True, wide_keys=True,
                                min_batch=512, engine_backend="xla"),
    "numpy-oracle": BackendSpec("numpy-oracle", device=False, wide_keys=True,
                                min_batch=0, engine_backend=None),
}


@dataclasses.dataclass
class Index:
    """A built learned index over sorted unique f64 keys (see module
    doc).  Host state: ``keys`` / ``mech`` / ``gapped``; device state: a
    lazily frozen ``kernels.ops.QueryEngine`` on ``device``."""

    keys: np.ndarray
    mech: object
    method: str
    gapped: Optional[_gaps.GappedArray] = None
    sample_rate: float = 1.0
    gap_rho: float = 0.0
    build_seconds: float = 0.0
    learn_seconds: float = 0.0
    mech_kwargs: dict = dataclasses.field(default_factory=dict)
    # the auto-tuner's TunedChoice when built with method="auto"
    tuned: object = dataclasses.field(default=None, repr=False,
                                      compare=False)
    # cuda unless "cpu" is asked for (see device.resolve_device)
    device: Optional[torch.device] = None
    # --- device-sync policy knobs -------------------------------------
    refreeze_contested_frac: float = 0.25
    refreeze_link_growth: float = 0.10
    min_device_batch: int = 512
    # single-dispatch fused ingest.  None = on for a cuda engine whose
    # fused_impl is "kernel" (the reference's "on for accelerator
    # engines"), off otherwise; True/False force the arm either way
    fused_ingest_enabled: Optional[bool] = None
    # when the fused gate vetoes a batch, retry its longest locally
    # clean prefix in-graph and replay only the rest on the host path
    fused_split_commit: bool = True
    # delta syncs refresh window bounds for touched segments only; past
    # this fraction of all segments the refresh is skipped
    refresh_segments_frac: float = 0.25
    # --- device state (rebuilt lazily) ---------------------------------
    _engine: object = dataclasses.field(default=None, repr=False,
                                        compare=False)
    _mirror: object = dataclasses.field(default=None, repr=False,
                                        compare=False)
    _device_epoch: int = dataclasses.field(default=-1, repr=False,
                                           compare=False)
    _keycap_cache: object = dataclasses.field(default=None, repr=False,
                                              compare=False)
    # mutated key values since the last device sync — feeds the
    # incremental window-bound refresh
    _pending_touch: list = dataclasses.field(default_factory=list,
                                             repr=False, compare=False)
    stats: dict = dataclasses.field(default_factory=lambda: {
        "refreezes": 0, "delta_updates": 0, "delta_elems": 0,
        "lookups": 0, "ingests": 0, "bound_refreshes": 0,
        "retrains": 0, "search_probes": 0, "freeze_seconds": 0.0})

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        keys: np.ndarray,
        method: str = "pgm",
        sample_rate: float = 1.0,
        gap_rho: float = 0.0,
        rng: Optional[np.random.Generator] = None,
        payloads: Optional[np.ndarray] = None,
        shards: Optional[int] = None,
        device=None,
        **mech_kwargs,
    ):
        """Build an index; its device state lives on ``device`` (cuda
        unless ``device="cpu"``).  The mechanism learns on the host.  A
        gapped build places its keys on ``device`` when that is CUDA and
        ``method`` is one of ``kernels.place.PLM_METHODS`` (``pgm``,
        ``fiting``), on the host otherwise; both give the same arrays
        (see the module doc).  ``payloads``
        overrides the stored payload per key (default: the key's
        position) — gapped builds only.  ``shards=`` builds the
        range-partitioned ``dist.ShardedIndex`` instead.

        ``method="auto"`` runs the §3 MDL auto-tuner
        (``core.tuning.autotune``) over a (mechanism, eps, sample-size)
        grid on a sample of the keys and builds the winner; the choice
        is recorded on ``index.tuned``.  The default ``sample_rate=1.0``
        then means "let the tuner pick"; pass an explicit rate to pin
        it."""
        if shards is not None:
            from ..dist.sharded import ShardedIndex
            return ShardedIndex.build(
                keys, shards=int(shards), method=method,
                sample_rate=sample_rate, gap_rho=gap_rho, rng=rng,
                payloads=payloads, device=device, **mech_kwargs)
        dev = resolve_device(device)
        keys = np.asarray(keys, np.float64)
        if keys.ndim != 1 or keys.shape[0] < 2:
            raise ValueError("need a 1-D array of at least two keys")
        if not bool(np.all(np.diff(keys) > 0)):
            raise ValueError("keys must be sorted, strictly increasing (unique)")
        if payloads is not None:
            payloads = np.asarray(payloads, np.int64)
            if payloads.shape != keys.shape:
                raise ValueError("payloads must match keys 1:1")
            if gap_rho <= 0.0:
                raise ValueError("explicit payloads need a gapped build "
                                 "(gap_rho > 0); static builds store "
                                 "positions")
        tuned = None
        if method == "auto":
            from . import tuning as _tuning
            tuned = _tuning.autotune(
                keys, queries=mech_kwargs.pop("queries", None),
                dynamic=gap_rho > 0.0, rng=rng,
                **{k: mech_kwargs.pop(k) for k in
                   ("alpha", "size_budget_bytes", "max_err_budget")
                   if k in mech_kwargs})
            method = tuned.method
            mech_kwargs = dict(tuned.mech_kwargs, **mech_kwargs)
            if sample_rate >= 1.0:  # default sentinel: tuner's pick
                sample_rate = tuned.sample_rate
        factory = _mechanism_factory(method, **mech_kwargs)
        t0 = time.perf_counter()
        if gap_rho > 0.0:
            refit_factory = None
            if method in ("pgm", "fiting") and "eps" in mech_kwargs:
                # D_g is near-linear: a tighter refit eps gives precise
                # placement and short linking arrays
                rkw = dict(mech_kwargs)
                rkw["eps"] = max(4.0, float(mech_kwargs["eps"]) / 16.0)
                refit_factory = _mechanism_factory(method, **rkw)
            from ..kernels import place as _place
            kw = dict(payloads=payloads, rho=gap_rho,
                      sample_rate=sample_rate, rng=rng,
                      refit_factory=refit_factory)
            if dev.type == "cuda" and method in _place.PLM_METHODS:
                gapped = _place.build_gapped_device(factory, keys,
                                                    device=dev, **kw)
            else:
                gapped = _gaps.build_gapped(factory, keys, **kw)
            mech = gapped.mech
        else:
            gapped = None
            if sample_rate < 1.0:
                mech = _sampling.fit_sampled(factory, keys, rate=sample_rate,
                                             rng=rng)
            else:
                mech = factory()
                mech.fit(keys, np.arange(keys.shape[0], dtype=np.float64))
        dt = time.perf_counter() - t0
        timings = getattr(gapped, "build_timings", None) or {}
        return cls(keys=keys, mech=mech, method=method, gapped=gapped,
                   sample_rate=sample_rate, gap_rho=gap_rho,
                   build_seconds=dt,
                   learn_seconds=float(timings.get("learn_seconds", dt)),
                   mech_kwargs=dict(mech_kwargs), tuned=tuned, device=dev)

    # ------------------------------------------------------------------
    # epoch protocol
    # ------------------------------------------------------------------
    @property
    def epoch(self) -> int:
        """Monotone host-state version (0 for an untouched build)."""
        return self.gapped.version if self.gapped is not None else 0

    @property
    def device_epoch(self) -> int:
        """Epoch the frozen device state reflects (-1: not frozen)."""
        return self._device_epoch

    def __deepcopy__(self, memo):
        # the device state is a cache keyed by epoch: the copy rebuilds
        # it lazily on the same device instead of copying the engine's
        # tensors and kernel handles
        new = Index(
            keys=_copy.deepcopy(self.keys, memo),
            mech=_copy.deepcopy(self.mech, memo),
            method=self.method,
            gapped=_copy.deepcopy(self.gapped, memo),
            sample_rate=self.sample_rate,
            gap_rho=self.gap_rho,
            build_seconds=self.build_seconds,
            learn_seconds=self.learn_seconds,
            mech_kwargs=dict(self.mech_kwargs),
            tuned=self.tuned,
            device=self.device,
            refreeze_contested_frac=self.refreeze_contested_frac,
            refreeze_link_growth=self.refreeze_link_growth,
            min_device_batch=self.min_device_batch,
            fused_ingest_enabled=self.fused_ingest_enabled,
            fused_split_commit=self.fused_split_commit,
            refresh_segments_frac=self.refresh_segments_frac,
            stats=_copy.deepcopy(self.stats, memo),
        )
        new.__class__ = self.__class__
        memo[id(self)] = new
        return new

    # ------------------------------------------------------------------
    # backend resolution
    # ------------------------------------------------------------------
    def _key_caps(self):
        """(wide, device_exact) of the live key set, cached per epoch:
        ``wide`` when keys exceed f32 exactness (2^24) and ride the
        hi/lo pair; ``device_exact`` when the pair search cannot
        conflate stored keys (every key pair-exact, or the pair mapping
        alias-free over the stored set)."""
        cached = self._keycap_cache
        if cached is not None and cached[0] == self.epoch:
            return cached[1], cached[2]
        from ..kernels import freeze as _fz
        if self.gapped is not None:
            arrs = (self.gapped.slot_key, self.gapped.links.chain_keys)
        else:
            arrs = (self.keys,)
        wide = any(_fz.keys_need_pair(a) for a in arrs)
        indiv = all(_fz.keys_pair_exact(a) for a in arrs)
        exact = indiv
        if wide and not indiv:
            merged = (np.sort(np.concatenate(arrs)) if len(arrs) > 1
                      and arrs[1].size else arrs[0])
            exact = _fz.pair_alias_free(merged)
        self._keycap_cache = (self.epoch, wide, exact, indiv)
        return wide, exact

    def _key_caps_after_batch(self, batch: np.ndarray) -> None:
        """Incremental cap maintenance after an ingest, O(batch log n):

        * all-exact set + per-key pair-exact batch: roll the cache
          forward directly;
        * alias-free continuous set: a NEW alias must pair a new key
          with one of its key-order neighbours, so checking the batch
          against its bracketing stored keys (slot keys + the
          bracketing slots' chains) suffices;
        * anything else leaves the cache stale for a full recompute.
        """
        cached = self._keycap_cache
        if cached is None or not cached[2]:
            return  # no cache, or already inexact (stays inexact)
        from ..kernels import freeze as _fz
        batch = np.asarray(batch, np.float64)
        wide = cached[1] or _fz.keys_need_pair(batch)
        if cached[3] and _fz.keys_pair_exact(batch):
            self._keycap_cache = (self.epoch, wide, True, True)
            return
        ga = self.gapped
        if ga is None:
            return
        # a value's predecessor lives on the PREV occupied slot (left
        # searchsorted - 1) or its chain, its bracketing chain on the
        # occupied upper bound (right searchsorted - 1); the successor
        # is that slot's right neighbour's carried key
        bs = np.unique(batch)
        m = ga.n_slots
        jr = np.searchsorted(ga.slot_key, bs, side="right") - 1
        jl = np.searchsorted(ga.slot_key, bs, side="left") - 1
        s_chain = np.unique(np.clip(np.concatenate([jl, jr]), 0, m - 1))
        s_vals = np.unique(np.clip(np.concatenate([jl, jr, jr + 1]),
                                   0, m - 1))
        nb = ga.slot_key[s_vals]
        off, ck, _ = ga.links.csr()
        starts, ends = off[s_chain], off[s_chain + 1]
        lens = ends - starts
        if int(lens.sum()):
            base = np.repeat(starts, lens)
            step = np.arange(int(lens.sum())) - np.repeat(
                np.cumsum(lens) - lens, lens)
            chain_nb = ck[base + step]
        else:
            chain_nb = np.zeros(0, np.float64)
        cand = np.concatenate([bs, nb[np.isfinite(nb)], chain_nb])
        exact = _fz.pair_alias_free(np.sort(np.unique(cand)))
        self._keycap_cache = (self.epoch, wide, bool(exact), False)

    def _roll_caps(self) -> None:
        """Advance the keycap cache to the current epoch UNCHANGED — for
        mutations that cannot worsen key capabilities (payload updates;
        deletes, which can only remove aliasing)."""
        cached = self._keycap_cache
        if cached is not None:
            self._keycap_cache = (self.epoch,) + cached[1:]

    def resolve_backend(self, n_queries: int,
                        requested: Optional[str] = None) -> BackendSpec:
        """Pick a backend from the capability registry (see module doc)."""
        has_plm = getattr(self.mech, "plm", None) is not None
        if requested is not None:
            try:
                spec = BACKENDS[requested]
            except KeyError:
                raise ValueError(
                    f"unknown backend {requested!r}; registered: "
                    f"{sorted(BACKENDS)}") from None
            if spec.device:
                if not has_plm:
                    raise ValueError(
                        f"backend {requested!r} cannot serve this index: "
                        f"mechanism {self.method!r} does not export a "
                        "piecewise linear model — use 'numpy-oracle'")
                wide, exact = self._key_caps()
                if wide and not spec.wide_keys:
                    raise ValueError(
                        f"backend {requested!r} cannot serve this index: "
                        "keys exceed f32 exactness (2^24) and the backend "
                        "lacks hi/lo wide-key support — use 'xla-windowed' "
                        "or 'numpy-oracle'")
                if wide and not exact:
                    raise ValueError(
                        f"backend {requested!r} cannot serve this index: "
                        "distinct keys alias in the f32 hi/lo pair "
                        "representation (exact only up to ~2^48) — only "
                        "'numpy-oracle' can distinguish them")
            return spec
        if n_queries < self.min_device_batch or not has_plm:
            return BACKENDS["numpy-oracle"]
        wide, exact = self._key_caps()
        if wide and not exact:  # beyond 2^48: only the host is exact
            return BACKENDS["numpy-oracle"]
        return BACKENDS["fused"]

    # ------------------------------------------------------------------
    # device state lifecycle
    # ------------------------------------------------------------------
    def refreeze(self):
        """Full rebuild of the frozen device state (arrays + query-safe
        window bounds + host mirror) at the current epoch.  Returns the
        engine."""
        from ..kernels.delta import freeze_state
        t0 = time.perf_counter()
        stages = {}
        self._engine, self._mirror = freeze_state(self, self.device,
                                                  stages=stages)
        self._device_epoch = self.epoch
        self._pending_touch = []  # fresh bounds cover everything logged
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["refreezes"] += 1
        self.stats["freeze_seconds"] = time.perf_counter() - t0
        self.stats["freeze_stages"] = stages
        return self._engine

    def _log_touch(self, keys) -> None:
        """Record mutated key values for the next delta's incremental
        window-bound refresh (cleared by any device sync)."""
        keys = np.atleast_1d(np.asarray(keys, np.float64))
        if keys.size:
            self._pending_touch.append(keys)
            if len(self._pending_touch) > 32:  # bound the log
                self._pending_touch = [
                    np.unique(np.concatenate(self._pending_touch))]

    def sync_device(self):
        """Bring the frozen device state to the current epoch NOW (delta
        update when possible, refreeze otherwise).  Returns the
        engine."""
        return self._sync_device()

    def _sync_device(self, prefer_delta: bool = True):
        """Bring the device state to the current epoch (delta if allowed
        and possible, else refreeze)."""
        if self._engine is None:
            return self.refreeze()
        if self._device_epoch == self.epoch:
            return self._engine
        from ..kernels.delta import delta_update
        if prefer_delta:
            new_arrays, n_elems, touched_keys = delta_update(
                self._engine.arrays, self._mirror, self)
            if new_arrays is not None:
                self._engine.swap_arrays(new_arrays)
                self._device_epoch = self.epoch
                self.stats["delta_updates"] += 1
                self.stats["delta_elems"] += n_elems
                pending = ([np.asarray(touched_keys, np.float64)]
                           if touched_keys is not None else [])
                pending += [np.asarray(a, np.float64)
                            for a in self._pending_touch]
                self._pending_touch = []
                self._refresh_window_bounds(
                    np.concatenate(pending) if pending
                    else np.zeros(0, np.float64))
                return self._engine
        return self.refreeze()

    def _refresh_window_bounds(self, touched_keys) -> None:
        """Incremental per-segment window-bound refresh after a delta
        update: only segments whose keys moved (plus their key-order
        neighbours) recompute.  Near-global churn (more than
        ``refresh_segments_frac`` of the segments touched) skips it —
        stale bounds only cost fallbacks, and the refreeze policy
        catches sustained growth."""
        eng = self._engine
        if (eng is None or touched_keys is None
                or np.asarray(touched_keys).size == 0
                or self.refresh_segments_frac <= 0):  # refresh disabled
            return
        plm = getattr(self.mech, "plm", None)
        if plm is None:
            return
        from ..kernels.bounds import query_window_bounds
        eng.refresh_rank_rows(touched_keys, self.gapped.slot_key)
        segs = np.unique(plm.segment_of(np.asarray(touched_keys,
                                                   np.float64)))
        # boundary terms reach into the neighbouring segments' key spans
        segs = np.unique(np.clip(
            np.concatenate([segs - 1, segs, segs + 1]),
            0, plm.n_segments - 1))
        if segs.size > max(8.0, self.refresh_segments_frac
                           * plm.n_segments):
            return
        err_hi_prev = (eng.err_hi if eng.err_hi is not None
                       else np.zeros_like(eng.err_lo))
        lo, hi = query_window_bounds(
            self, segments=segs, base=(eng.err_lo, err_hi_prev))
        eng.refresh_bounds(lo, hi)
        self.stats["bound_refreshes"] = (
            self.stats.get("bound_refreshes", 0) + 1)

    def _link_growth_fraction(self) -> float:
        """Chained keys added since the last freeze, relative to the
        index size AT that freeze (a stable denominator)."""
        if self.gapped is None or self._mirror is None:
            return 0.0
        grown = self.gapped.links.total - self._mirror.links_at_freeze
        return grown / max(self._mirror.n_keys_at_freeze, 1)

    def device_bytes(self) -> int:
        """Bytes of the frozen device images (0 before the first
        freeze)."""
        eng = self._engine
        return 0 if eng is None else eng.arrays.nbytes()

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------
    def predict(self, qs: np.ndarray) -> np.ndarray:
        return self.mech.predict(np.asarray(qs, np.float64))

    def lookup(self, queries, *, backend: Optional[str] = None,
               queries_sorted: bool = False) -> LookupResult:
        """Batched exact-match lookup -> ``LookupResult``.

        ``backend`` picks a registry entry explicitly; the default
        resolves by batch size and key width.  ``queries_sorted=True``
        skips the sort round trip on the fused path.
        """
        with span("lookup"):
            with span("lookup.route"):
                queries = np.asarray(queries, np.float64)
                spec = self.resolve_backend(queries.shape[0], backend)
                self.stats["lookups"] += 1
                engine = self.sync_device() if spec.device else None
            if engine is None:
                if self.gapped is not None:
                    pay, slots, found = self.gapped.lookup_batch(
                        queries, full=True)
                    return host_lookup_result(pay, slots, found, spec.name,
                                              self.epoch)
                pos, probes = _sampling.exponential_search(
                    self.keys, queries, self.predict(queries))
                self.stats["search_probes"] += probes
                found = self.keys[pos] == queries
                pay = np.where(found, pos, -1)
                return host_lookup_result(pay, pos, found, spec.name,
                                          self.epoch)
            esc0 = engine.stats["oracle_escapes"]
            out, slot, found, fb = engine.lookup(
                queries, queries_sorted=queries_sorted,
                backend=spec.engine_backend,
                force_backend=backend is not None)
            with span("lookup.finish"):
                # label the stage that actually ran: an overflowed batch
                # lands on the device oracle (explicit requests skip the
                # engine's xla size cut)
                stage = {"fused": "fused", "pallas": "pallas",
                         "xla": "xla-windowed",
                         "oracle": "device-oracle"}[engine.last_stage]
                return LookupResult(
                    payloads=np.asarray(out).astype(np.int64),
                    slots=np.asarray(slot).astype(np.int64),
                    found=np.asarray(found, bool),
                    backend=stage,
                    epoch=self.epoch,
                    fallbacks=int(fb),
                    oracle_escapes=engine.stats["oracle_escapes"] - esc0,
                )

    # ------------------------------------------------------------------
    # writes (§5.3 dynamic ops — need a gapped build)
    # ------------------------------------------------------------------
    def _need_gapped(self):
        if self.gapped is None:
            raise NotImplementedError(
                "dynamic ops need gap insertion (build with gap_rho > 0)")

    def _device_placements(self, keys) -> Optional[dict]:
        """The batch's placement primitives computed on the frozen device
        arrays (the CUDA ingest-place kernel), escape rows patched from
        the host oracle in O(#escapes).  None whenever the device cannot
        serve the batch EXACTLY — device state behind the host epoch, a
        non-PLM ``predict``, a batch past one partition chunk, keys past
        per-key pair exactness, or ``n_slots >= 2^24`` — and the host
        partition runs as before.  A wide set that is only alias-free
        is certified row by row on the host (``device-verified``)."""
        if (self._engine is None or self._device_epoch != self.epoch
                or self.method not in ("pgm", "fiting")
                or self.gapped is None
                or keys.shape[0] < self.min_device_batch
                # past one chunk insert_batch recomputes the later
                # chunks against mutated state anyway
                or keys.shape[0] > self.gapped.batch_chunk()
                or self.gapped.n_slots >= (1 << 24)):
            return None
        from ..kernels import freeze as _fz
        verify = False
        if self._engine.arrays.key_wide:
            self._key_caps()  # refresh the cache to this epoch
            cached = self._keycap_cache
            if not (cached is not None and cached[0] == self.epoch
                    and cached[3] and _fz.keys_pair_exact(keys)):
                if not (cached is not None and cached[0] == self.epoch
                        and cached[2]):
                    return None  # aliasing set: only the host is exact
                verify = True
        elif _fz.keys_need_pair(keys):
            return None  # wide batch against a narrow (plain-f32) freeze
        prims, esc = self._engine.ingest_place(keys)
        n_esc = int(np.count_nonzero(esc))
        if n_esc:
            sub = self.gapped.placement_primitives(keys[esc])
            for f, v in prims.items():
                v[esc] = sub[f]
        self.stats["ingest_place_escapes"] = (
            self.stats.get("ingest_place_escapes", 0) + n_esc)
        if verify:
            bad = self.gapped.verify_placements(keys, prims)
            n_bad = int(np.count_nonzero(bad))
            if n_bad:
                sub = self.gapped.placement_primitives(keys[bad])
                for f, v in prims.items():
                    v[bad] = sub[f]
            self.stats["ingest_place_verify_patched"] = (
                self.stats.get("ingest_place_verify_patched", 0) + n_bad)
        self._placement_mode = "device-verified" if verify else "device"
        return prims

    def _fused_eligible(self, keys, payloads) -> bool:
        """Gates of the single-dispatch fused ingest: the device-
        placement gates (verified mode excluded) plus the graph's own —
        ``n_slots < 2^22``, a non-empty frozen link image for the CSR
        merge, and payloads within the frozen narrow width."""
        ga = self.gapped
        if (self._engine is None or self._device_epoch != self.epoch
                or self.method not in ("pgm", "fiting") or ga is None
                or keys.shape[0] < self.min_device_batch
                or keys.shape[0] > ga.batch_chunk()
                or ga.n_slots >= (1 << 22)
                or ga.n_keys == 0):
            return False
        arrays = self._engine.arrays
        if int(arrays.link_keys.shape[0]) == 0:
            return False
        from ..kernels import freeze as _fz
        if not arrays.wide and payloads.size and (
                int(payloads.min()) < _fz._I32_MIN
                or int(payloads.max()) > _fz._I32_MAX):
            return False
        if arrays.key_wide:
            self._key_caps()
            cached = self._keycap_cache
            if not (cached is not None and cached[0] == self.epoch
                    and cached[3] and _fz.keys_pair_exact(keys)):
                return False
        elif _fz.keys_need_pair(keys):
            return False
        return True

    def _fused_dispatch(self, keys, payloads):
        """Run the fused ingest once; returns ``(prims, ok, state)``.  On
        an in-graph abort the primitives are escape-patched and handed
        to the host partition, so an abort never wastes the dispatch."""
        prims, esc, ok, reasons, state = self._engine.fused_ingest(
            keys, payloads)
        self._placement_mode = "device"
        if ok:
            return prims, True, state
        from ..kernels.ops_gap import FUSED_ABORT_BITS
        ab = self.stats.setdefault("fused_aborts", {})
        names = [name for i, name in enumerate(FUSED_ABORT_BITS)
                 if reasons >> i & 1]
        for name in names:
            ab[name] = ab.get(name, 0) + 1
        self._last_abort_reasons = tuple(names)
        self.stats["fused_abort_total"] = (
            self.stats.get("fused_abort_total", 0) + 1)
        # the split-commit arm needs the raw escape rows to pick a prefix
        self._last_escape_mask = np.asarray(esc, bool)
        n_esc = int(np.count_nonzero(esc))
        if n_esc:
            sub = self.gapped.placement_primitives(keys[esc])
            for f, v in prims.items():
                v[esc] = sub[f]
        self.stats["ingest_place_escapes"] = (
            self.stats.get("ingest_place_escapes", 0) + n_esc)
        return prims, False, None

    def _commit_fused(self, keys, payloads, prims, state, t0):
        """Commit an accepted fused ingest: the host advances through the
        normal partition fed the SAME primitives (it stays authoritative
        and bit-identical to sequential ``insert()``); the device
        advances by ADOPTING the graph's output tensors.  The mirror's
        sources are advanced and its images marked dirty, so a later
        host delta rebuilds them first."""
        from ..kernels.delta import snapshot_sources
        eng = self._engine
        cand = np.asarray(prims["free"], bool) & np.asarray(
            prims["bracket"], bool)
        counts = self.gapped.insert_batch(keys, payloads, placements=prims)
        self._key_caps_after_batch(keys)
        self.stats["ingests"] += 1
        if (counts["contested"] != 0 or counts["slot"] != state["n_slot"]
                or counts["chain"] != state["n_chain"]):
            # unreachable by the closure-trivial acceptance argument; if
            # it ever fires, distrust the graph image and refreeze
            self._log_touch(keys)
            self.refreeze()
            return IngestReport(
                n=int(keys.shape[0]), slot=counts["slot"],
                chain=counts["chain"], contested=counts["contested"],
                epoch=self.epoch, device="refreeze",
                seconds=time.perf_counter() - t0, placement="device")
        # adopt the in-graph refreshed state + catch the host mirrors up
        err_lo = eng.err_lo
        err_hi = (eng.err_hi if eng.err_hi is not None
                  else np.zeros_like(err_lo))
        seg = state["seg"][cand]
        dlt = state["dlt"][cand].astype(np.float32)
        np.minimum.at(err_lo, seg, dlt - np.float32(1.0))
        np.maximum.at(err_hi, seg, dlt + np.float32(1.0))
        eng.adopt_fused_state(state, err_lo, err_hi)
        eng.refresh_rank_rows(keys, self.gapped.slot_key, upload=False)
        self._device_epoch = self.epoch
        self._pending_touch = []
        self._mirror.sources = snapshot_sources(self)
        self._mirror.images = None  # lazily rebuilt by the next delta
        self.stats["fused_ingests"] = (
            self.stats.get("fused_ingests", 0) + 1)
        device = "fused"
        if self._link_growth_fraction() > self.refreeze_link_growth:
            self.refreeze()  # capacity-growth policy still applies
            device = "refreeze"
        return IngestReport(
            n=int(keys.shape[0]), slot=counts["slot"],
            chain=counts["chain"], contested=0, epoch=self.epoch,
            device=device, device_elems=0,
            seconds=time.perf_counter() - t0, placement="device",
            fused_aborts=self.stats.get("fused_abort_total", 0),
            split_commits=self.stats.get("split_commits", 0))

    def _split_prefix(self, keys, prims) -> int:
        """Longest batch prefix with no locally suspect row — the split
        commit's candidate.  A row is suspect when it carries the escape
        bit, duplicates another batch key, is a free candidate without a
        bracket, or shares a gap run (``pv``/``ub``) with another batch
        row where a free placement is involved.  A heuristic: the second
        fused dispatch re-runs the full abort gate on the prefix."""
        n = int(keys.shape[0])
        free = np.asarray(prims["free"], bool)
        bracket = np.asarray(prims["bracket"], bool)
        suspect = free & ~bracket
        esc = getattr(self, "_last_escape_mask", None)
        if esc is not None and esc.shape == suspect.shape:
            suspect |= esc
        order = np.argsort(keys, kind="stable")
        ks = keys[order]
        dup = np.r_[False, ks[1:] == ks[:-1]]
        dup |= np.r_[dup[1:], False]
        suspect[order[dup]] = True
        rid = np.where(free, np.asarray(prims["pv"], np.int64),
                       np.asarray(prims["ub"], np.int64))
        uniq, inv, cnt = np.unique(rid, return_inverse=True,
                                   return_counts=True)
        free_in_run = np.zeros(uniq.size, bool)
        np.logical_or.at(free_in_run, inv, free)
        suspect |= (cnt[inv] > 1) & free_in_run[inv]
        bad = np.flatnonzero(suspect)
        # a veto with no locally attributable row: try the front half
        return int(bad[0]) if bad.size else n // 2

    def _sync_after_host_batch(self, counts, n: int):
        """Device follow-up of a host-partitioned batch: drop the device
        state when keys outgrew pair exactness, else delta (or refreeze
        past the policy thresholds).  Returns ``(label, elems)`` with
        label "delta", "refreeze", "none" or "" (already current)."""
        wide, exact = self._key_caps()
        if wide and not exact:
            # the device can no longer answer exactly: drop its state;
            # the registry now routes every lookup to the host
            self._engine = None
            self._mirror = None
            self._device_epoch = -1
            return "none", 0
        contested_frac = counts["contested"] / max(n, 1)
        want_refreeze = (
            contested_frac > self.refreeze_contested_frac
            or self._link_growth_fraction() > self.refreeze_link_growth)
        before = (self.stats["delta_updates"], self.stats["refreezes"],
                  self.stats["delta_elems"])
        self._sync_device(prefer_delta=not want_refreeze)
        if self.stats["delta_updates"] > before[0]:
            return "delta", self.stats["delta_elems"] - before[2]
        if self.stats["refreezes"] > before[1]:
            return "refreeze", 0
        return "", 0

    def _try_split_commit(self, keys, payloads, prims, t0):
        """Split commit: commit the longest locally clean prefix with a
        second fused dispatch and replay only the remainder through the
        host partition + delta sync.  Returns the merged report for the
        whole batch, or None when the prefix is too small or its
        dispatch aborts too (the caller then runs the host partition on
        the primitives already paid for)."""
        n = int(keys.shape[0])
        k = self._split_prefix(keys, prims)
        if k < max(self.min_device_batch, n // 8) or k >= n:
            return None
        pk, pp = keys[:k], payloads[:k]
        if not self._fused_eligible(pk, pp):
            return None
        prims2, _esc2, ok2, _reasons2, state2 = self._engine.fused_ingest(
            pk, pp)
        if not ok2:
            self.stats["split_commit_misses"] = (
                self.stats.get("split_commit_misses", 0) + 1)
            return None
        rep1 = self._commit_fused(pk, pp, prims2, state2, t0)
        self.stats["split_commits"] = (
            self.stats.get("split_commits", 0) + 1)
        # the remainder replays against the post-commit state
        rk, rp = keys[k:], payloads[k:]
        rprims = self._device_placements(rk)
        counts = self.gapped.insert_batch(rk, rp, placements=rprims)
        self._key_caps_after_batch(rk)
        self._log_touch(rk)
        device = rep1.device
        elems = rep1.device_elems
        if self._engine is not None:
            label, more = self._sync_after_host_batch(counts, rk.shape[0])
            if label == "delta":
                device = "fused+delta"
                elems += more
            elif label:
                device = label
        return IngestReport(
            n=n, slot=rep1.slot + counts["slot"],
            chain=rep1.chain + counts["chain"],
            contested=counts["contested"], epoch=self.epoch,
            device=device, device_elems=elems,
            seconds=time.perf_counter() - t0, placement="device-split",
            abort_reasons=getattr(self, "_last_abort_reasons", ()),
            fused_aborts=self.stats.get("fused_abort_total", 0),
            split_commits=self.stats.get("split_commits", 0))

    def ingest(self, keys, payloads) -> IngestReport:
        """Batched insert -> ``IngestReport``.  With the device state at
        the host epoch, the placements are computed on the device (the
        CUDA ingest-place kernel; host oracle otherwise), then the device
        follows by a delta update, or a refreeze past the policy
        thresholds.  On an eligible engine the whole batch is ONE fused
        ingest whose outputs the engine adopts (``device == "fused"``);
        a batch the graph vetoes falls back to the host partition
        REUSING its primitives, after a split-commit attempt."""
        self._need_gapped()
        t0 = time.perf_counter()
        keys = np.atleast_1d(np.asarray(keys, np.float64))
        payloads = np.atleast_1d(np.asarray(payloads, np.int64))
        prims = None
        placement = "host"
        self._last_abort_reasons = ()
        enabled = self.fused_ingest_enabled
        if enabled is None:  # on for the kernel engine on cuda, as the
            # reference turns it on for its accelerator kernel
            enabled = (getattr(self._engine, "fused_impl", "kernel")
                       == "kernel" and self.device.type == "cuda")
        if enabled and self._fused_eligible(keys, payloads):
            prims, ok, state = self._fused_dispatch(keys, payloads)
            placement = "device"
            if ok:
                return self._commit_fused(keys, payloads, prims, state, t0)
            # a purely capacity-based veto vetoes any same-shaped prefix
            # too, so only a row-attributable veto tries a split commit
            cap_only = set(self._last_abort_reasons) <= {
                "chain_overflow", "link_overflow"}
            if self.fused_split_commit and not cap_only:
                rep = self._try_split_commit(keys, payloads, prims, t0)
                if rep is not None:
                    return rep
        if prims is None:
            prims = self._device_placements(keys)
            placement = ("host" if prims is None
                         else getattr(self, "_placement_mode", "device"))
        counts = self.gapped.insert_batch(keys, payloads, placements=prims)
        self._key_caps_after_batch(keys)
        self._log_touch(keys)
        self.stats["ingests"] += 1
        device = "none"
        elems = 0
        if self._engine is not None:
            label, elems = self._sync_after_host_batch(counts,
                                                       keys.shape[0])
            device = label or "none"
        return IngestReport(
            n=int(keys.shape[0]), slot=counts["slot"], chain=counts["chain"],
            contested=counts["contested"], epoch=self.epoch, device=device,
            device_elems=elems, seconds=time.perf_counter() - t0,
            placement=placement,
            abort_reasons=getattr(self, "_last_abort_reasons", ()),
            fused_aborts=self.stats.get("fused_abort_total", 0),
            split_commits=self.stats.get("split_commits", 0))

    def remove(self, keys) -> int:
        """Batched delete; the device state follows lazily (the next
        device lookup delta-updates or refreezes as needed)."""
        self._need_gapped()
        keys = np.atleast_1d(np.asarray(keys, np.float64))
        n = self.gapped.delete_batch(keys)
        self._roll_caps()
        self._log_touch(keys)
        return n

    # scalar host ops (thin delegates; epoch bumps via gapped.version)
    def insert(self, key: float, payload: int) -> str:
        self._need_gapped()
        path = self.gapped.insert(key, payload)
        self._key_caps_after_batch(np.array([key], np.float64))
        self._log_touch(np.array([key], np.float64))
        return path

    def insert_batch(self, keys: np.ndarray, payloads: np.ndarray) -> dict:
        """Raw batched insert returning §5.3 path counts (host only; use
        ``ingest`` for the typed report + eager device sync)."""
        self._need_gapped()
        counts = self.gapped.insert_batch(keys, payloads)
        self._log_touch(keys)
        return counts

    def delete(self, key: float) -> bool:
        self._need_gapped()
        out = self.gapped.delete(key)
        self._roll_caps()
        self._log_touch(np.array([key], np.float64))
        return out

    def delete_batch(self, keys: np.ndarray) -> int:
        self._need_gapped()
        out = self.gapped.delete_batch(keys)
        self._roll_caps()
        self._log_touch(np.asarray(keys, np.float64))
        return out

    def update(self, key: float, payload: int) -> bool:
        self._need_gapped()
        out = self.gapped.update(key, payload)
        self._roll_caps()  # payload-only: key capabilities unchanged
        return out

    def update_batch(self, keys: np.ndarray, payloads: np.ndarray) -> int:
        """Batched payload update (ONE epoch bump; payload-only, so the
        next device sync is a pure payload-scatter delta)."""
        self._need_gapped()
        out = self.gapped.update_batch(np.asarray(keys, np.float64),
                                       np.asarray(payloads, np.int64))
        self._roll_caps()
        return out

    # ------------------------------------------------------------------
    # durability (serving/wal.py crash recovery rides on these)
    # ------------------------------------------------------------------
    def save_snapshot(self, directory, *, step: Optional[int] = None,
                      keep: int = 3, wal_lsn: int = 0,
                      extra: Optional[dict] = None) -> str:
        """Write a restorable checkpoint of the full HOST state in the
        reference's layout (``train.checkpoint.CheckpointManager``: one
        fsynced ``.npy`` per array + manifest, atomic tmp -> rename
        publish).  The device state is never written: it is an
        epoch-keyed cache that refreezes lazily after ``restore``.
        ``wal_lsn`` records the ingest-WAL byte offset this snapshot is
        consistent with (recovery replays only records past it —
        serving/wal.py).  Returns the published checkpoint directory."""
        from ..train.checkpoint import CheckpointManager
        state = {
            "keys": np.asarray(self.keys, np.float64),
            "mech_pickle": np.frombuffer(
                _dump_mech(self.mech), np.uint8).copy(),
        }
        meta = {
            "kind": "index",
            "method": self.method,
            "sample_rate": float(self.sample_rate),
            "gap_rho": float(self.gap_rho),
            "gapped": self.gapped is not None,
            "epoch": int(self.epoch),
            "wal_lsn": int(wal_lsn),
        }
        ga = self.gapped
        if ga is not None:
            offsets, lkeys, lpays = ga.export_csr_links()
            state.update(
                slot_key=np.asarray(ga.slot_key, np.float64),
                occupied=np.asarray(ga.occupied, bool),
                payload=np.asarray(ga.payload, np.int64),
                offsets=np.asarray(offsets, np.int64),
                chain_keys=np.asarray(lkeys, np.float64),
                chain_payloads=np.asarray(lpays, np.int64),
            )
            meta["n_keys"] = int(ga.n_keys)
            meta["rho"] = float(ga.rho)
        if extra:
            meta.update(extra)
        s = int(step if step is not None else self.epoch)
        meta["step"] = s
        return CheckpointManager(directory, keep=keep).save(
            s, state, extra=meta)

    @classmethod
    def restore(cls, directory, step: Optional[int] = None, device=None):
        """Load a ``save_snapshot`` checkpoint of either package ->
        ``(index, extra)``, the index's device state on ``device`` (cuda
        unless ``device="cpu"``), not yet frozen.

        The host state is restored bit-identically (arrays verbatim,
        the mechanism from its pickle as the port's classes); ``extra``
        is the manifest's metadata dict (includes ``wal_lsn``).  Newest
        step when ``step`` is None."""
        from ..train.checkpoint import CheckpointManager
        from .links import CSRLinks
        dev = resolve_device(device)
        mgr = CheckpointManager(str(directory))
        s = int(step) if step is not None else mgr.latest_step()
        if s is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        state, meta = mgr.restore(step=s)
        mech = _load_mech(
            np.asarray(state["mech_pickle"], np.uint8).tobytes())
        gapped = None
        if meta.get("gapped"):
            slot_key = np.asarray(state["slot_key"], np.float64)
            gapped = _gaps.GappedArray(
                slot_key=slot_key,
                occupied=np.asarray(state["occupied"], bool),
                payload=np.asarray(state["payload"], np.int64),
                links=CSRLinks(
                    int(slot_key.shape[0]),
                    np.asarray(state["offsets"], np.int64),
                    np.asarray(state["chain_keys"], np.float64),
                    np.asarray(state["chain_payloads"], np.int64)),
                mech=mech,
                n_keys=int(meta["n_keys"]),
                rho=float(meta["rho"]),
                version=int(meta["epoch"]))
        idx = cls(keys=np.asarray(state["keys"], np.float64), mech=mech,
                  method=meta["method"], gapped=gapped,
                  sample_rate=float(meta["sample_rate"]),
                  gap_rho=float(meta["gap_rho"]), device=dev)
        return idx, meta

    # ------------------------------------------------------------------
    # self-tuning: online retrain
    # ------------------------------------------------------------------
    def retrain(self, sample_rate: Optional[float] = None, *,
                gap_rho: Optional[float] = None, rng=None,
                method: Optional[str] = None, **mech_kwargs) -> dict:
        """Sampled refit of the LIVE gapped state — the paper's §4
        construction cost applied online.

        Extracts the live (key, payload) set (occupied slots + CSR
        chain keys via ``GappedArray.live_items``), rebuilds the gapped
        array through ``build_gapped`` with mechanism learning on a
        sample (O(n_s)), and swaps it in with the epoch bumped past the
        old one.  The OLD arrays are replaced, never mutated, so any
        outstanding ``GapSnapshot`` pin (``serving.EpochPipeline``)
        keeps serving its epoch bit-identically throughout; the device
        cache is dropped and refreezes lazily at the new epoch on the
        same device.  Defaults replay the build's settings (``method``
        / mech kwargs / ``gap_rho``); ``sample_rate`` defaults to the
        build's rate.  Returns a record dict (n / seconds /
        learn_seconds / epoch / chains before-after)."""
        self._need_gapped()
        t0 = time.perf_counter()
        old_epoch = self.epoch
        chains_before = self.gapped.link_stats()
        keys, payloads = self.gapped.live_items()
        method = method or self.method
        rate = self.sample_rate if sample_rate is None else float(sample_rate)
        rho = self.gap_rho if gap_rho is None else float(gap_rho)
        kwargs = dict(self.mech_kwargs, **mech_kwargs) if method == \
            self.method else dict(mech_kwargs)
        new = Index.build(keys, method=method, sample_rate=rate,
                          gap_rho=rho, rng=rng, payloads=payloads,
                          device=self.device, **kwargs)
        # swap host state wholesale; epoch stays strictly monotone
        new.gapped.version = old_epoch + 1
        self.keys = new.keys
        self.mech = new.mech
        self.method = new.method
        self.gapped = new.gapped
        self.sample_rate = rate
        self.gap_rho = rho
        self.mech_kwargs = new.mech_kwargs
        self.tuned = new.tuned if new.tuned is not None else self.tuned
        # device state is an epoch-keyed cache of the REPLACED arrays
        self._engine = None
        self._mirror = None
        self._device_epoch = -1
        self._keycap_cache = None
        self._pending_touch = []
        self.stats["retrains"] += 1
        return {
            "n": int(keys.shape[0]),
            "seconds": time.perf_counter() - t0,
            "learn_seconds": float(new.learn_seconds),
            "sample_rate": rate,
            "epoch": int(self.epoch),
            "chains_before": chains_before,
            "chains_after": self.gapped.link_stats(),
        }

    def mdl(self, alpha: float = 1.0) -> _mdl.MDLReport:
        """Evaluate under the §3 MDL framework (positions = logical y).

        Gapped builds are scored on the LIVE key set — occupied slot
        keys plus CSR chain keys from ``GappedArray.live_items()`` —
        against their physical slots, so keys added by ``ingest`` enter
        ``L(D|M)`` / ``max_abs_err`` and the report tracks drift (the
        retrain trigger's input).  A chained key's position is its chain
        owner's slot: exactly where the search lands before the chain
        bisect."""
        if self.gapped is not None:
            keys, _ = self.gapped.live_items()
            y = (np.searchsorted(self.gapped.slot_key, keys,
                                 side="right") - 1).astype(np.float64)
        else:
            keys = self.keys
            y = np.arange(keys.shape[0], dtype=np.float64)
        return _mdl.mdl_report(self.method, self.mech, keys, y,
                               alpha=alpha)
