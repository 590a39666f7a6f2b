"""The port's ``Index`` handle: the read slice of ``repro.core.Index``.

``Index.build`` runs the host build (§4 sampling, mechanism fit, Eq. 3
gap insertion — ``gaps.build_gapped``, a copy of the reference's), and
``lookup`` answers batched point lookups on a backend from the registry:

=============  ======  ==========  =========  ==========================
name           device  wide keys   min batch  notes
=============  ======  ==========  =========  ==========================
fused          yes     yes (hi/lo  512        the hand-written CUDA
                       f32 pair)              fused-lookup kernel, one
                                              launch per batch
numpy-oracle   no      yes (f64)   0          host reference; exact
=============  ======  ==========  =========  ==========================

Device state is frozen lazily at the host ``epoch`` and refrozen when
the epoch moves (delta sync is ROADMAP item A4).  The device is ``cuda``
unless the build is given ``device="cpu"``; without CUDA the default
raises.  The write path and the other entry points of the reference
handle raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from . import gaps as _gaps
from . import sampling as _sampling
from .mechanisms import MECHANISMS
from .results import LookupResult, host_lookup_result

__all__ = ["Index", "BackendSpec", "BACKENDS"]


def _mechanism_factory(method: str, **kwargs):
    cls = MECHANISMS[method]
    return lambda: cls(**kwargs)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue A, "
        f"item {item})")


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Capability record for one lookup backend."""

    name: str
    device: bool            # runs on the frozen device arrays
    wide_keys: bool         # exact beyond f32 (2^24) key magnitudes
    min_batch: int          # below this the backend loses to the host
    engine_backend: Optional[str]  # kernels.ops.QueryEngine stage


BACKENDS: Dict[str, BackendSpec] = {
    "fused": BackendSpec("fused", device=True, wide_keys=True,
                         min_batch=512, engine_backend="fused"),
    "numpy-oracle": BackendSpec("numpy-oracle", device=False, wide_keys=True,
                                min_batch=0, engine_backend=None),
}

# reference backends not ported yet -> ROADMAP item
_UNPORTED_BACKENDS = {"pallas": "A8", "xla-windowed": "A8"}


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
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    min_device_batch: int = 512
    _engine: object = dataclasses.field(default=None, repr=False,
                                        compare=False)
    _device_epoch: int = dataclasses.field(default=-1, repr=False,
                                           compare=False)
    _keycap_cache: object = dataclasses.field(default=None, repr=False,
                                              compare=False)
    stats: dict = dataclasses.field(default_factory=lambda: {
        "refreezes": 0, "lookups": 0, "search_probes": 0,
        "freeze_seconds": 0.0})

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
        """Build an index on the host; its device state lives on
        ``device`` (cuda unless ``device="cpu"``).  ``payloads``
        overrides the stored payload per key (default: the key's
        position) — gapped builds only."""
        if shards is not None:
            raise _not_ported("Index.build(shards=...)", "A11")
        if method == "auto":
            raise _not_ported("Index.build(method='auto')", "A15")
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
            gapped = _gaps.build_gapped(
                factory, keys, payloads=payloads, rho=gap_rho,
                sample_rate=sample_rate, rng=rng,
                refit_factory=refit_factory,
            )
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
                   mech_kwargs=dict(mech_kwargs), device=dev)

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

    def resolve_backend(self, n_queries: int,
                        requested: Optional[str] = None) -> BackendSpec:
        """Pick a backend from the capability registry (see module doc)."""
        has_plm = getattr(self.mech, "plm", None) is not None
        if requested is not None:
            if requested in _UNPORTED_BACKENDS:
                raise _not_ported(f"backend {requested!r}",
                                  _UNPORTED_BACKENDS[requested])
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
        window bounds) at the current epoch.  Returns the engine."""
        from ..kernels.bounds import query_window_bounds
        from ..kernels.freeze import freeze_index
        from ..kernels.ops import QueryEngine
        t0 = time.perf_counter()
        arrays, _statics = freeze_index(self, self.device)
        err_lo, err_hi = query_window_bounds(self)
        self._engine = QueryEngine(arrays, err_lo, err_hi)
        self._device_epoch = self.epoch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["refreezes"] += 1
        self.stats["freeze_seconds"] = time.perf_counter() - t0
        return self._engine

    def sync_device(self):
        """Bring the frozen device state to the current epoch now (a
        full refreeze in this slice; delta sync is ROADMAP item A4).
        Returns the engine."""
        if self._engine is None or self._device_epoch != self.epoch:
            return self.refreeze()
        return self._engine

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
        queries = np.asarray(queries, np.float64)
        spec = self.resolve_backend(queries.shape[0], backend)
        self.stats["lookups"] += 1
        if not spec.device:
            if self.gapped is not None:
                pay, slots, found = self.gapped.lookup_batch(queries,
                                                             full=True)
                return host_lookup_result(pay, slots, found, spec.name,
                                          self.epoch)
            pos, probes = _sampling.exponential_search(
                self.keys, queries, self.predict(queries))
            self.stats["search_probes"] += probes
            found = self.keys[pos] == queries
            pay = np.where(found, pos, -1)
            return host_lookup_result(pay, pos, found, spec.name, self.epoch)
        engine = self.sync_device()
        esc0 = engine.stats["oracle_escapes"]
        out, slot, found, fb = engine.lookup(
            queries, queries_sorted=queries_sorted,
            backend=spec.engine_backend)
        stage = {"fused": "fused",
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
    # not ported in this slice
    # ------------------------------------------------------------------
    def ingest(self, keys, payloads):
        raise _not_ported("Index.ingest", "A5")

    def remove(self, keys):
        raise _not_ported("Index.remove", "A5")

    def retrain(self, *args, **kwargs):
        raise _not_ported("Index.retrain", "A15")

    def mdl(self, alpha: float = 1.0):
        raise _not_ported("Index.mdl", "A15")

    def save_snapshot(self, directory, **kwargs):
        raise _not_ported("Index.save_snapshot", "A9")
