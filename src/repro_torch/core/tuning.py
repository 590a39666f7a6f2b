"""MDL-guided auto-tuner (paper §3 as a decision procedure).

The paper frames index learning as minimizing ``MDL = L(M) + alpha *
L(D|M)`` and argues the objective "helps design suitable indexes for
different scenarios"; fig4 plots that tradeoff offline.  ``autotune``
evaluates it ONLINE: fit every candidate (mechanism, budget) on a
*sample* of the keys — §4 makes candidate evaluation O(n_s), which is
what makes a grid affordable — and score each with a query-weighted
``mdl_report``, so the correction term reflects the keys queries
actually hit, not the uniform key distribution.

Constraint set ("Lower Bounds for the Algorithmic Complexity of
Learned Indexes", PAPERS.md): the space/error budget is a hard filter,
not a soft penalty — candidates over ``size_budget_bytes`` or
``max_err_budget`` are dropped before scoring (if ALL candidates bust
the budget the smallest model wins, flagged ``budget_met=False``).

Sample sizing uses the paper's theory hooks: ``sample_size_bound``
(Thm. 1, ``O(alpha^2 log^2 E)``) floors the sample so the sampled
correction-cost estimate is trustworthy, and the returned choice
carries ``hoeffding_eps`` (Prop. 1) — the confidence radius of the
winning score at that sample size.

Consumers: ``Index.build(method="auto")`` (and therefore per-shard
``ShardedIndex.build(method="auto")``) and ``Index.retrain``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from . import mdl as _mdl
from . import sampling as _sampling
from .mechanisms import MECHANISMS

__all__ = ["TunedChoice", "autotune", "default_grid"]

# sample floor: Thm. 1's constant is asymptotic; in practice a few
# thousand pairs make the per-candidate correction estimate stable at
# negligible fit cost (PGM on 4k pairs is ~ms)
_MIN_SAMPLE = 4096


@dataclasses.dataclass(frozen=True)
class TunedChoice:
    """The auto-tuner's winning configuration + its evidence."""

    method: str
    mech_kwargs: dict
    sample_rate: float          # rate that makes n_s >= the Thm.1 floor
    score: float                # winning query-weighted MDL
    report: _mdl.MDLReport      # full report of the winner (on sample)
    hoeffding_eps: float        # Prop.1 confidence radius of the score
    budget_met: bool            # False: every candidate busts the budget
    candidates: Tuple[dict, ...]  # (name, kwargs, mdl, bytes, max_err)


def default_grid(n: int) -> Sequence[Tuple[str, dict]]:
    """The scored (mechanism, kwargs) grid: PGM/FITing across an eps
    ladder plus one RMI sized to the key count.  B+Tree is excluded —
    it exists as the paper's baseline, never a serving choice."""
    grid = []
    for eps in (32.0, 128.0, 512.0):
        grid.append(("pgm", {"eps": eps, "recursive": False}))
        grid.append(("fiting", {"eps": eps}))
    grid.append(("rmi", {"n_leaf": max(64, n // 1024)}))
    return grid


def _query_positions(keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """True full-data position of each query key (predecessor rank)."""
    return (np.searchsorted(keys, queries, side="right") - 1).clip(0)


def autotune(
    keys: np.ndarray,
    queries: Optional[np.ndarray] = None,
    *,
    alpha: float = 1.0,
    dynamic: bool = False,
    size_budget_bytes: Optional[int] = None,
    max_err_budget: Optional[float] = None,
    grid: Optional[Sequence[Tuple[str, dict]]] = None,
    rng: Optional[np.random.Generator] = None,
) -> TunedChoice:
    """Pick (mechanism, kwargs, sample_rate) minimizing query-weighted
    MDL on a sample of ``keys``.

    ``queries`` weights ``L(D|M)`` by the observed query distribution
    (defaults to the key sample itself — uniform).  ``dynamic=True``
    restricts the grid to PLM-exporting mechanisms the gapped dynamic
    path serves device-side (pgm/fiting) — the per-shard default.
    ``alpha`` is the paper's Eq.1 weight; the budget kwargs are the
    lower-bounds constraint set (hard filter, see module doc).
    """
    keys = np.asarray(keys, np.float64)
    n = keys.shape[0]
    rngs = _sampling.spawn_rngs(rng, 2)
    # Thm.1-floored sample: E is unknown before fitting, so bound it by
    # the worst case (a single line => E <= n) — log2^2(n) * alpha^2,
    # floored at _MIN_SAMPLE for small-n stability
    n_bound = _sampling.sample_size_bound(max(alpha, 1.0), float(n), c=8.0)
    n_s = int(min(n, max(_MIN_SAMPLE, n_bound)))
    sample_rate = min(1.0, n_s / max(n, 1))
    xs, ys = _sampling.sample_pairs(keys, rate=sample_rate, rng=rngs[0])

    if queries is None:
        qx, qy = xs, ys
    else:
        queries = np.asarray(queries, np.float64)
        if queries.shape[0] > n_s:  # cap the scoring cost at O(n_s)
            queries = rngs[1].choice(queries, n_s, replace=False)
        qx = np.sort(queries)
        qy = _query_positions(keys, qx).astype(np.float64)

    cand_grid = list(grid) if grid is not None else list(default_grid(n))
    if dynamic:
        cand_grid = [(m, kw) for m, kw in cand_grid if m in ("pgm", "fiting")]

    scored = []
    for name, kwargs in cand_grid:
        mech = MECHANISMS[name](**kwargs)
        mech.fit(xs, ys)
        plm = getattr(mech, "plm", None)
        if plm is not None and name in ("pgm", "fiting") and sample_rate < 1.0:
            _sampling.connect_segments(plm)
        rep = _mdl.mdl_report(name, mech, qx, qy, alpha=alpha)
        scored.append((name, dict(kwargs), rep))
    if not scored:
        raise ValueError("autotune: empty candidate grid")

    def within_budget(rep: _mdl.MDLReport) -> bool:
        if size_budget_bytes is not None and \
                rep.l_model_bytes > size_budget_bytes:
            return False
        if max_err_budget is not None and rep.max_abs_err > max_err_budget:
            return False
        return True

    eligible = [c for c in scored if within_budget(c[2])]
    budget_met = bool(eligible)
    if not eligible:  # every candidate busts the budget: smallest model
        eligible = [min(scored, key=lambda c: c[2].l_model_bytes)]
    name, kwargs, rep = min(eligible, key=lambda c: c[2].mdl)

    return TunedChoice(
        method=name,
        mech_kwargs=kwargs,
        sample_rate=sample_rate,
        score=float(rep.mdl),
        report=rep,
        hoeffding_eps=_sampling.hoeffding_bound(rep.max_abs_err,
                                                int(xs.shape[0])),
        budget_met=budget_met,
        candidates=tuple(
            {"method": m, "mech_kwargs": kw, "mdl": float(r.mdl),
             "size_bytes": int(r.l_model_bytes),
             "max_abs_err": float(r.max_abs_err)}
            for m, kw, r in scored),
    )
