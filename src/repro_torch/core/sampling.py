"""Learning index with sampling (paper §4).

Uniform random sample ``D_s`` of size ``n_s = s * n`` (always including the
first and last key so the key domain is covered), fit the mechanism on the
sampled (key, *full-data position*) pairs, then patch so every unsampled
key is covered:

* FITing-Tree / PGM: **connect adjacent segments** — each segment's line is
  re-anchored to pass through the next segment's first (key, position), so
  predictions interpolate instead of extrapolating across sample holes.
* RMI: **RMI-Nearest-Seg** — empty (untrained) leaves are re-assigned to
  the nearest trained leaf (built into ``RMIMechanism.fit``).

Because sampling can violate the fitted error bounds on unsampled keys, the
paper switches correction to exponential search; we provide both that
(`exponential_search`, paper-faithful) and exact re-finalized bounds
(`refinalize_bounds`, the production path that keeps the Pallas bounded-
window kernel correct).

Theory hooks: `hoeffding_bound` (Prop. 1) and `sample_size_bound` (Thm. 1's
``O(alpha^2 log^2 E)`` guideline), exercised in tests and Fig. 8.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .mechanisms import PiecewiseLinearModel, _finalize_errors

__all__ = [
    "sample_pairs",
    "spawn_rngs",
    "connect_segments",
    "refinalize_bounds",
    "exponential_search",
    "hoeffding_bound",
    "sample_size_bound",
    "fit_sampled",
]

# fallback entropy for rng=None callers: a module-level SeedSequence
# spawner, so every anonymous sample draws an INDEPENDENT stream
# (deterministic per process, but never the same stream twice — a fixed
# default_rng(0) here made every per-shard build and every retrain
# sample identically, hiding sampling variance entirely)
_FALLBACK_SEEDS = np.random.SeedSequence(0x5A3D1E)


def _default_rng(rng: Optional[np.random.Generator]) -> np.random.Generator:
    if rng is not None:
        return rng
    return np.random.default_rng(_FALLBACK_SEEDS.spawn(1)[0])


def spawn_rngs(rng: Optional[np.random.Generator],
               n: int) -> list:
    """``n`` independent child generators derived from ``rng``.

    With an explicit ``rng`` the children are seeded by draws from it
    (deterministic given the parent's state, distinct per child — the
    per-shard / per-split threading contract).  With ``rng=None`` the
    children come from the module fallback pool, each independent."""
    if rng is None:
        return [np.random.default_rng(s) for s in _FALLBACK_SEEDS.spawn(n)]
    seeds = rng.integers(0, 2 ** 63 - 1, size=(n, 4))
    return [np.random.default_rng(np.random.SeedSequence(list(map(int, s))))
            for s in seeds]


def sample_pairs(
    x: np.ndarray,
    y: Optional[np.ndarray] = None,
    rate: float = 0.01,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform sample of (key, full-data position) pairs, endpoints forced."""
    rng = _default_rng(rng)
    n = x.shape[0]
    if y is None:
        y = np.arange(n, dtype=np.float64)
    if not (0.0 < rate <= 1.0):
        raise ValueError(f"sample rate must be in (0, 1], got {rate}")
    if rate >= 1.0:
        return np.asarray(x, np.float64), np.asarray(y, np.float64)
    n_s = max(2, int(round(rate * n)))
    idx = rng.choice(n, size=n_s, replace=False)
    idx = np.union1d(idx, np.array([0, n - 1]))
    return np.asarray(x, np.float64)[idx], np.asarray(y, np.float64)[idx]


def connect_segments(plm: PiecewiseLinearModel) -> PiecewiseLinearModel:
    """The paper's FIT/PGM sampling patch: connect adjacent segments.

    Segment k's line is redefined to run from (first_key_k, icept_k) to
    (first_key_{k+1}, icept_{k+1}); the last segment keeps its slope.
    Guarantees continuity, so unsampled keys between segment anchors are
    interpolated rather than extrapolated.
    """
    K = plm.n_segments
    if K <= 1:
        return plm
    fk, ic = plm.seg_first_key, plm.icept
    dk = fk[1:] - fk[:-1]
    new_slope = plm.slope.copy()
    safe = dk > 0
    new_slope[:-1] = np.where(safe, (ic[1:] - ic[:-1]) / np.where(safe, dk, 1.0), plm.slope[:-1])
    plm.slope = new_slope
    return plm


def refinalize_bounds(
    plm: PiecewiseLinearModel, x_full: np.ndarray, y_full: np.ndarray
) -> PiecewiseLinearModel:
    """Recompute exact per-segment error bounds on the *full* dataset.

    O(n) vectorized; restores the bounded-window search contract after
    sampling (production path for the Pallas kernel).
    """
    return _finalize_errors(
        plm, np.asarray(x_full, np.float64), np.asarray(y_full, np.float64)
    )


def exponential_search(
    sorted_keys: np.ndarray, queries: np.ndarray, y_hat: np.ndarray
) -> Tuple[np.ndarray, int]:
    """Paper-faithful correction step: exponential search around y_hat.

    Doubles the radius around the (clipped) prediction until the query is
    bracketed, then binary-searches the bracket.  Vectorized over queries;
    returns ``(positions, probes)`` — positions are the index of the exact
    match (or of the predecessor), probes is the TOTAL key-comparison
    count across the batch (2 per doubling round per unbracketed query +
    1 per bisect round per unresolved query), the correction-cost figure
    the benchmarks surface.
    """
    n = sorted_keys.shape[0]
    q = np.asarray(queries)
    pos = np.clip(np.rint(y_hat), 0, n - 1).astype(np.int64)
    radius = np.ones_like(pos)
    probes = 0
    # bracket: grow radius until sorted_keys[pos-r] <= q <= sorted_keys[pos+r]
    pending = pos.shape[0]
    for _ in range(64):  # 2^64 covers any n
        probes += 2 * pending  # both bracket ends are probed per round
        lo = np.maximum(pos - radius, 0)
        hi = np.minimum(pos + radius, n - 1)
        ok = (sorted_keys[lo] <= q) & (q <= sorted_keys[hi])
        ok |= (lo == 0) & (q <= sorted_keys[hi])
        ok |= (hi == n - 1) & (sorted_keys[lo] <= q)
        pending = int(np.count_nonzero(~ok))
        if pending == 0:
            break
        radius = np.where(ok, radius, radius * 2)
    lo = np.maximum(pos - radius, 0)
    hi = np.minimum(pos + radius, n - 1)
    # binary search within [lo, hi] for predecessor position of q
    for _ in range(int(np.ceil(np.log2(max(n, 2)))) + 2):
        probes += int(np.count_nonzero(lo < hi))
        mid = (lo + hi + 1) // 2
        go_right = sorted_keys[mid] <= q
        lo = np.where(go_right, mid, lo)
        hi = np.where(go_right, hi, mid - 1)
        done = lo >= hi
        if bool(np.all(done)):
            break
    return lo, int(probes)


def hoeffding_bound(max_err: float, n_s: int, delta: float = 0.05) -> float:
    """Prop. 1: |L(D_s|M) - L(D|M)| <= log2(E)/sqrt(2 n_s) * sqrt(log(2/delta))."""
    return float(
        np.log2(max(max_err, 2.0)) / np.sqrt(2.0 * n_s) * np.sqrt(np.log(2.0 / delta))
    )


def sample_size_bound(alpha: float, max_err: float, c: float = 1.0) -> int:
    """Thm. 1 asymptotic guideline: n_s = O(alpha^2 log^2 E)."""
    return int(np.ceil(c * (alpha ** 2) * (np.log2(max(max_err, 2.0)) ** 2)))


def fit_sampled(
    mechanism_factory,
    x: np.ndarray,
    y: Optional[np.ndarray] = None,
    rate: float = 0.01,
    rng: Optional[np.random.Generator] = None,
    patch: str = "connect",
    refinalize: bool = True,
):
    """Fit a mechanism on a sample, apply the coverage patch, return it.

    ``mechanism_factory()`` -> unfitted mechanism.  ``patch`` in
    {"connect", "none"}; RMI's nearest-seg patch is internal to its fit.
    With ``refinalize`` the error bounds are recomputed exactly on the full
    data (production path); otherwise callers should correct with
    ``exponential_search`` (paper-faithful path).
    """
    n = x.shape[0]
    if y is None:
        y = np.arange(n, dtype=np.float64)
    xs, ys = sample_pairs(x, y, rate=rate, rng=rng)
    mech = mechanism_factory()
    mech.fit(xs, ys)
    plm = getattr(mech, "plm", None)
    if plm is not None and patch == "connect" and mech.name in ("pgm", "fiting"):
        connect_segments(plm)
    if plm is not None and refinalize:
        refinalize_bounds(plm, x, y)
    return mech
