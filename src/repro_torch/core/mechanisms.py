"""Index mechanisms M(y|x) — the model families the paper plugs into.

All mechanisms share one prediction representation, a sorted piecewise
linear model (PLM):

    seg_first_key[k]  first key covered by segment k   (sorted, (K,))
    slope[k], icept[k] linear map  y_hat = slope*(x - seg_first_key) + icept
    err_lo[k], err_hi[k] per-segment signed error bounds over training keys

Prediction is branchless and batched: route each query to its segment with
``searchsorted`` (binary probe over a small table — VMEM-resident on TPU),
then one fused multiply-add.  This is the TPU adaptation of the paper's
pointer-based variants (stx::btree over segments for FITing-Tree, recursive
levels for PGM): identical semantics, vector-friendly layout.

Mechanisms:
  * :class:`PGMMechanism` — optimal piecewise linear approximation under an
    error bound eps (O'Rourke streaming convex hull, as used by the
    PGM-index).  Guarantees ``|y_hat - y| <= eps`` on trained keys.
    Recursive variant stacks PLMs over the segment keys.
  * :class:`FITingMechanism` — greedy shrinking-cone segmentation
    (FITing-Tree).  Same guarantee, more segments than optimal.
  * :class:`RMIMechanism` — two-layer recursive model index with linear
    models; leaf assignment by the root model, leaves fit with a
    closed-form least squares via ``segment_sum`` (fully parallel in JAX —
    a deliberate better-than-paper TPU adaptation of RMI training).
  * :class:`BTreeMechanism` — the classic baseline expressed in the same
    framework: "prediction" walks fence keys (cost ~ height), "correction"
    scans a page.  Used for the MDL comparison (paper §6.2/Table 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "PiecewiseLinearModel",
    "PGMMechanism",
    "FITingMechanism",
    "RMIMechanism",
    "BTreeMechanism",
    "build_mechanism",
    "MECHANISMS",
]


# ---------------------------------------------------------------------------
# Shared piecewise-linear prediction representation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PiecewiseLinearModel:
    """Frozen, array-backed piecewise linear model (host-side numpy).

    The jnp/Pallas query path consumes these arrays directly
    (see ``repro.kernels``).
    """

    seg_first_key: np.ndarray  # (K,) float64, sorted
    slope: np.ndarray          # (K,) float64
    icept: np.ndarray          # (K,) float64 — y_hat at seg_first_key
    err_lo: np.ndarray         # (K,) float64 — min(y - y_hat) per segment
    err_hi: np.ndarray         # (K,) float64 — max(y - y_hat) per segment
    n_keys: int                # number of keys the model was fit on
    levels: int = 1            # recursive levels (PGM recursive variant)
    level_sizes: Tuple[int, ...] = ()

    @property
    def n_segments(self) -> int:
        return int(self.seg_first_key.shape[0])

    def segment_of(self, x: np.ndarray) -> np.ndarray:
        """Index of the segment covering each query key."""
        x = np.asarray(x)
        seg = np.searchsorted(self.seg_first_key, x, side="right") - 1
        return np.clip(seg, 0, self.n_segments - 1)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Batched position prediction y_hat (float; callers round/clip)."""
        x = np.asarray(x, dtype=np.float64)
        seg = self.segment_of(x)
        return self.slope[seg] * (x - self.seg_first_key[seg]) + self.icept[seg]

    def predict_with_bounds(self, x) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(y_hat, lo, hi): search window [y_hat+err_lo, y_hat+err_hi]."""
        x = np.asarray(x, dtype=np.float64)
        seg = self.segment_of(x)
        y_hat = self.slope[seg] * (x - self.seg_first_key[seg]) + self.icept[seg]
        return y_hat, y_hat + self.err_lo[seg], y_hat + self.err_hi[seg]

    def max_abs_error(self) -> float:
        """E — the paper's maximum absolute prediction error bound."""
        if self.n_segments == 0:
            return 1.0
        return float(max(np.max(np.abs(self.err_lo)), np.max(np.abs(self.err_hi)), 1.0))

    def param_count(self) -> int:
        # slope + intercept + first_key (+2 error bounds) per segment
        return 5 * self.n_segments

    def size_bytes(self, payload_bytes: int = 0) -> int:
        """Index size following the paper's accounting (doubles per field)."""
        return 8 * self.param_count() + payload_bytes


def _finalize_errors(
    plm: PiecewiseLinearModel, x: np.ndarray, y: np.ndarray
) -> PiecewiseLinearModel:
    """Recompute exact per-segment signed error bounds on (x, y)."""
    seg = plm.segment_of(x)
    err = y - plm.predict(x)
    K = plm.n_segments
    lo = np.full(K, 0.0)
    hi = np.full(K, 0.0)
    np.minimum.at(lo, seg, err)
    np.maximum.at(hi, seg, err)
    plm.err_lo, plm.err_hi = lo, hi
    return plm


# ---------------------------------------------------------------------------
# PGM — optimal PLA under an error bound (streaming convex hull)
# ---------------------------------------------------------------------------


_POLY_MAX = 32  # cap on feasible-polygon complexity (see _thin_poly)


def _clip_halfplane(poly, cx, cc, keep_le):
    """Clip convex polygon (list of (a, b)) with cx*a + b {<=,>=} cc."""
    out = []
    m = len(poly)
    for idx in range(m):
        a1, b1 = poly[idx]
        a2, b2 = poly[(idx + 1) % m]
        f1 = cx * a1 + b1 - cc
        f2 = cx * a2 + b2 - cc
        in1 = (f1 <= 0.0) if keep_le else (f1 >= 0.0)
        in2 = (f2 <= 0.0) if keep_le else (f2 >= 0.0)
        if in1:
            out.append((a1, b1))
        if in1 != in2:
            t = f1 / (f1 - f2)
            out.append((a1 + t * (a2 - a1), b1 + t * (b2 - b1)))
    return out


def _thin_poly(poly):
    """Bound polygon complexity (keeps the eps guarantee conservative).

    On (near-)exactly-linear data every new constraint grazes the feasible
    polygon, netting +1 vertex per point — O(n) vertices and quadratic
    total work.  We (a) drop near-duplicate vertices and (b) if still over
    ``_POLY_MAX``, keep an evenly spaced subset.  The kept subset spans a
    convex *inner* approximation, so every accepted point still satisfies
    |err| <= eps; segments can only end marginally earlier than optimal.
    """
    if len(poly) <= _POLY_MAX:
        return poly
    # drop consecutive near-duplicates (relative tolerance)
    out = []
    for v in poly:
        if out:
            pa, pb = out[-1]
            da = abs(v[0] - pa)
            db = abs(v[1] - pb)
            if da <= 1e-12 * (1.0 + abs(pa)) and db <= 1e-12 * (1.0 + abs(pb)):
                continue
        out.append(v)
    if len(out) > _POLY_MAX:
        step = (len(out) + _POLY_MAX - 1) // _POLY_MAX
        out = out[::step]
    if len(out) >= 3:
        return out
    return poly[:3]


def _optimal_pla(x: np.ndarray, y: np.ndarray, eps: float):
    """Optimal PLA under error bound eps (the PGM-index algorithm).

    Greedy maximal extension with a *free intercept*: per segment we
    maintain the feasible region of (slope a, intercept b) — a convex
    polygon, the intersection of the strips
    ``y_t - eps <= a*(x_t - x0) + b + y0 <= y_t + eps`` —
    and end the segment when the polygon empties.  Greedy-maximal pieces
    are provably minimal in count (O'Rourke '81).  Coordinates are
    anchored at the segment's first point for conditioning.
    Sequential by nature (documented in DESIGN.md §2); host-side.

    Returns list of (first_idx, last_idx, slope, icept_at_first_key).
    """
    n = int(x.shape[0])
    eps = float(eps)
    segments = []
    i = 0
    while i < n:
        if i == n - 1:
            segments.append((i, i, 0.0, float(y[i])))
            break
        x0 = float(x[i])
        y0 = float(y[i])
        dx1 = float(x[i + 1]) - x0
        if dx1 <= 0:
            raise ValueError("keys must be strictly increasing (deduplicate first)")
        dy1 = float(y[i + 1]) - y0
        # Feasible (a, b) after the first two points: a parallelogram.
        poly = [
            ((dy1 - eps + eps) / dx1, -eps),   # b=-eps, lower constraint
            ((dy1 + eps + eps) / dx1, -eps),   # b=-eps, upper constraint
            ((dy1 + eps - eps) / dx1, eps),    # b=+eps, upper constraint
            ((dy1 - eps - eps) / dx1, eps),    # b=+eps, lower constraint
        ]
        j = i + 2
        while j < n:
            # cheap per-point cut test (pure python over <=POLY_MAX verts):
            # a point whose two halfplanes contain every vertex cannot
            # change the feasible region — skipping it is EXACT.
            dx = float(x[j]) - x0
            dy = float(y[j]) - y0
            hi = -np.inf
            lo = np.inf
            for va, vb in poly:
                v = va * dx + vb
                if v > hi:
                    hi = v
                if v < lo:
                    lo = v
            if hi <= dy + eps and lo >= dy - eps:
                # no cut here: vectorized scan-ahead for the next cutter
                pa = np.fromiter((v[0] for v in poly), np.float64, len(poly))
                pb = np.fromiter((v[1] for v in poly), np.float64, len(poly))
                chunk = 256
                j += 1
                while j < n:
                    j_end = min(n, j + chunk)
                    dxs = x[j:j_end] - x0
                    dys = y[j:j_end] - y0
                    vals = dxs[:, None] * pa[None, :] + pb[None, :]
                    cuts = ((vals.max(axis=1) > dys + eps)
                            | (vals.min(axis=1) < dys - eps))
                    idx = np.flatnonzero(cuts)
                    if idx.size:
                        j = j + int(idx[0])
                        break
                    j = j_end
                    chunk = min(chunk * 2, 1 << 16)
                continue
            p1 = _clip_halfplane(poly, dx, dy + eps, keep_le=True)
            if not p1:
                break
            p2 = _clip_halfplane(p1, dx, dy - eps, keep_le=False)
            if not p2:
                break
            poly = _thin_poly(p2)
            j += 1
        a = sum(v[0] for v in poly) / len(poly)
        b = sum(v[1] for v in poly) / len(poly)
        segments.append((i, j - 1, float(a), float(y0 + b)))
        i = j
    return segments


@dataclasses.dataclass
class PGMMechanism:
    """PGM-index: optimal PLA segments (+optional recursive levels)."""

    eps: float = 128.0
    recursive: bool = True
    plm: Optional[PiecewiseLinearModel] = None
    upper_plms: Tuple[PiecewiseLinearModel, ...] = ()

    name = "pgm"

    def fit(self, x: np.ndarray, y: np.ndarray) -> "PGMMechanism":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if not bool(np.all(np.diff(x) > 0)):
            raise ValueError("keys must be strictly increasing (deduplicate first)")
        segs = _optimal_pla(x, y, self.eps)
        K = len(segs)
        plm = PiecewiseLinearModel(
            seg_first_key=np.array([x[s[0]] for s in segs]),
            slope=np.array([s[2] for s in segs]),
            icept=np.array([s[3] for s in segs]),
            err_lo=np.zeros(K),
            err_hi=np.zeros(K),
            n_keys=x.shape[0],
        )
        self.plm = _finalize_errors(plm, x, y)
        # Recursive variant: index the segment-first-keys with further PLMs
        # until one segment remains (paper evaluates the recursive PGM).
        self.upper_plms = ()
        if self.recursive:
            uppers = []
            keys = plm.seg_first_key
            while keys.shape[0] > 64:
                pos = np.arange(keys.shape[0], dtype=np.float64)
                usegs = _optimal_pla(keys, pos, max(self.eps / 2, 4.0))
                uk = len(usegs)
                uplm = PiecewiseLinearModel(
                    seg_first_key=np.array([keys[s[0]] for s in usegs]),
                    slope=np.array([s[2] for s in usegs]),
                    icept=np.array([s[3] for s in usegs]),
                    err_lo=np.zeros(uk),
                    err_hi=np.zeros(uk),
                    n_keys=keys.shape[0],
                )
                uplm = _finalize_errors(uplm, keys, pos)
                uppers.append(uplm)
                keys = uplm.seg_first_key
            self.upper_plms = tuple(uppers)
            self.plm.levels = 1 + len(uppers)
            self.plm.level_sizes = (K,) + tuple(u.n_segments for u in uppers)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.plm.predict(x)

    def param_count(self) -> int:
        return self.plm.param_count() + sum(u.param_count() for u in self.upper_plms)

    def prediction_ops(self) -> int:
        # one fma per level + binary probe of the final level table
        levels = 1 + len(self.upper_plms)
        return 2 * levels + int(np.ceil(np.log2(max(self.plm.n_segments, 2))))


# ---------------------------------------------------------------------------
# FITing-Tree — greedy shrinking cone
# ---------------------------------------------------------------------------


def _shrinking_cone(x: np.ndarray, y: np.ndarray, eps: float, chunk: int = 8192):
    """Greedy shrinking-cone segmentation (FITing-Tree).

    The cone is anchored at the segment's first point (fixed intercept),
    which is what makes it greedy/suboptimal vs. the PGM polygon method.
    Vectorized in chunks: running cone bounds are prefix max/min, so each
    chunk is one ``maximum.accumulate`` — O(n) numpy work total.
    """
    n = int(x.shape[0])
    segments = []
    i = 0
    while i < n:
        if i == n - 1:
            segments.append((i, i, 0.0, float(y[i])))
            break
        x0, y0 = x[i], y[i]
        lo, hi = -np.inf, np.inf
        j = i + 1
        while j < n:
            j_end = min(n, j + chunk)
            dx = x[j:j_end] - x0
            if dx[0] <= 0:
                raise ValueError("keys must be strictly increasing (deduplicate first)")
            s_lo = np.maximum(np.maximum.accumulate((y[j:j_end] - eps - y0) / dx), lo)
            s_hi = np.minimum(np.minimum.accumulate((y[j:j_end] + eps - y0) / dx), hi)
            bad = s_lo > s_hi
            if bad.any():
                k = int(np.argmax(bad))  # first violating offset in chunk
                if k > 0:
                    lo, hi = float(s_lo[k - 1]), float(s_hi[k - 1])
                j = j + k
                break
            lo, hi = float(s_lo[-1]), float(s_hi[-1])
            j = j_end
        if not np.isfinite(lo) or not np.isfinite(hi):
            slope = 0.0
        else:
            slope = (lo + hi) / 2.0
        segments.append((i, j - 1, float(slope), float(y0)))
        i = j
    return segments


@dataclasses.dataclass
class FITingMechanism:
    """FITing-Tree: greedy eps-bounded segments, routed by sorted table."""

    eps: float = 128.0
    plm: Optional[PiecewiseLinearModel] = None

    name = "fiting"

    def fit(self, x: np.ndarray, y: np.ndarray) -> "FITingMechanism":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if not bool(np.all(np.diff(x) > 0)):
            raise ValueError("keys must be strictly increasing (deduplicate first)")
        segs = _shrinking_cone(x, y, self.eps)
        K = len(segs)
        plm = PiecewiseLinearModel(
            seg_first_key=np.array([x[s[0]] for s in segs]),
            slope=np.array([s[2] for s in segs]),
            icept=np.array([s[3] for s in segs]),
            err_lo=np.zeros(K),
            err_hi=np.zeros(K),
            n_keys=x.shape[0],
        )
        self.plm = _finalize_errors(plm, x, y)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.plm.predict(x)

    def param_count(self) -> int:
        return self.plm.param_count()

    def prediction_ops(self) -> int:
        return 2 + int(np.ceil(np.log2(max(self.plm.n_segments, 2))))


# ---------------------------------------------------------------------------
# RMI — two-layer linear recursive model index
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RMIMechanism:
    """Two-layer RMI with linear models (paper's configuration).

    Root: one linear model mapping key -> leaf bucket in [0, n_leaf).
    Leaves: per-bucket least-squares linear fits, computed closed-form and
    in parallel over buckets (segment sums) — the TPU-native adaptation.
    Empty leaves are patched to their nearest trained leaf
    (the paper's RMI-Nearest-Seg patch; see sampling.py).
    """

    n_leaf: int = 1000
    plm: Optional[PiecewiseLinearModel] = None
    root_slope: float = 0.0
    root_icept: float = 0.0
    leaf_first_key: Optional[np.ndarray] = None  # for PLM-style export

    name = "rmi"

    def fit(self, x: np.ndarray, y: np.ndarray) -> "RMIMechanism":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n = x.shape[0]
        # Root linear model fit on (x, y), scaled to leaf ids.
        xm, ym = x.mean(), y.mean()
        xv = ((x - xm) ** 2).mean()
        slope = 0.0 if xv == 0 else (((x - xm) * (y - ym)).mean()) / xv
        icept = ym - slope * xm
        y_max = max(float(y.max()), 1.0)
        self.root_slope = slope * self.n_leaf / (y_max + 1.0)
        self.root_icept = icept * self.n_leaf / (y_max + 1.0)
        leaf = np.clip(
            (self.root_slope * x + self.root_icept).astype(np.int64),
            0,
            self.n_leaf - 1,
        )
        # Root is monotone (slope>=0) => leaf ids are sorted; closed-form
        # per-leaf least squares via segment sums (vectorized).
        L = self.n_leaf
        cnt = np.bincount(leaf, minlength=L).astype(np.float64)
        sx = np.bincount(leaf, weights=x, minlength=L)
        sy = np.bincount(leaf, weights=y, minlength=L)
        sxx = np.bincount(leaf, weights=x * x, minlength=L)
        sxy = np.bincount(leaf, weights=x * y, minlength=L)
        denom = cnt * sxx - sx * sx
        safe = np.abs(denom) > 1e-12
        slopes = np.where(safe, (cnt * sxy - sx * sy) / np.where(safe, denom, 1.0), 0.0)
        iceptc = np.where(cnt > 0, (sy - slopes * sx) / np.maximum(cnt, 1.0), 0.0)
        # Leaf boundaries in key space: first key mapped into each leaf.
        # leaf id l covers keys with root(x) in [l, l+1) =>
        # first_key(l) = (l - root_icept)/root_slope  (root_slope>0).
        if self.root_slope <= 0:
            bounds = np.full(L, x[0])
        else:
            bounds = (np.arange(L, dtype=np.float64) - self.root_icept) / self.root_slope
        bounds[0] = min(bounds[0], x[0])
        # Patch empty leaves -> nearest trained leaf (RMI-Nearest-Seg).
        trained = np.flatnonzero(cnt > 0)
        if trained.size == 0:
            raise ValueError("RMI: no trained leaves")
        all_ids = np.arange(L)
        nearest = trained[
            np.clip(np.searchsorted(trained, all_ids), 0, trained.size - 1)
        ]
        # choose the closer of the neighbors on each side
        left = trained[np.clip(np.searchsorted(trained, all_ids) - 1, 0, trained.size - 1)]
        use_left = np.abs(all_ids - left) < np.abs(nearest - all_ids)
        nearest = np.where(use_left, left, nearest)
        slopes = slopes[nearest]
        iceptc = iceptc[nearest]
        # Export in the shared PLM layout: per-leaf y = slope*x + icept
        #   = slope*(x - first_key) + (slope*first_key + icept).
        plm = PiecewiseLinearModel(
            seg_first_key=bounds,
            slope=slopes,
            icept=slopes * bounds + iceptc,
            err_lo=np.zeros(L),
            err_hi=np.zeros(L),
            n_keys=n,
        )
        self.plm = _finalize_errors(plm, x, y)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        """RMI inference: root linear -> leaf linear (no search)."""
        x = np.asarray(x, dtype=np.float64)
        leaf = np.clip(
            (self.root_slope * x + self.root_icept).astype(np.int64),
            0,
            self.n_leaf - 1,
        )
        # icept in PLM layout is at seg_first_key; reconstruct absolute form
        sl = self.plm.slope[leaf]
        return sl * (x - self.plm.seg_first_key[leaf]) + self.plm.icept[leaf]

    def param_count(self) -> int:
        return 2 + 4 * self.n_leaf  # root + (slope,icept,err+,err-) per leaf

    def prediction_ops(self) -> int:
        return 4  # two fmas, no search


# ---------------------------------------------------------------------------
# B+Tree baseline (array-backed, same evaluation framework)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BTreeMechanism:
    """Dense-page B+Tree expressed as a mechanism for the MDL comparison.

    Prediction = root-to-leaf fence-key walk (cost ~ height * log2(fanout)
    comparisons); correction = binary scan within a page (cost ~ log2(page)).
    Arrays: fence keys per level; fully vectorizable lookup.
    """

    page_size: int = 256
    fanout: int = 16
    levels_keys: Tuple[np.ndarray, ...] = ()
    n_keys: int = 0

    name = "btree"

    def fit(self, x: np.ndarray, y: np.ndarray) -> "BTreeMechanism":
        x = np.asarray(x, dtype=np.float64)
        self.n_keys = x.shape[0]
        levels = []
        # leaf fence keys: first key of each page
        fences = x[:: self.page_size]
        levels.append(fences)
        while fences.shape[0] > self.fanout:
            fences = fences[:: self.fanout]
            levels.append(fences)
        self.levels_keys = tuple(reversed(levels))  # root first
        return self

    @property
    def height(self) -> int:
        return len(self.levels_keys)

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Returns the page-start position for each query key."""
        x = np.asarray(x, dtype=np.float64)
        leaf_fences = self.levels_keys[-1]
        page = np.clip(
            np.searchsorted(leaf_fences, x, side="right") - 1, 0, leaf_fences.shape[0] - 1
        )
        return page.astype(np.float64) * self.page_size + self.page_size / 2.0

    def param_count(self) -> int:
        return int(sum(lvl.shape[0] for lvl in self.levels_keys))

    def prediction_ops(self) -> int:
        return int(self.height * np.ceil(np.log2(self.fanout)))

    def size_bytes(self, payload_bytes: int = 0) -> int:
        # inner nodes (fence keys + child pointers) + leaves incl. payload
        inner = int(sum(lvl.shape[0] for lvl in self.levels_keys)) * 16
        leaves = self.n_keys * 16  # key + payload per entry, dense pages
        return inner + leaves + payload_bytes


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

MECHANISMS = {
    "pgm": PGMMechanism,
    "fiting": FITingMechanism,
    "rmi": RMIMechanism,
    "btree": BTreeMechanism,
}


def build_mechanism(name: str, **kwargs):
    """Build and fit nothing — returns the configured mechanism object."""
    if name not in MECHANISMS:
        raise KeyError(f"unknown mechanism {name!r}; have {sorted(MECHANISMS)}")
    return MECHANISMS[name](**kwargs)
