"""Host build and the ``Index`` handle.

``links``, ``mechanisms``, ``sampling``, ``gaps``, ``results``, ``mdl``,
``tuning`` and ``index`` are verbatim copies of the reference's
``repro.core`` modules (numpy host code; tests/test_torch_freeze.py
holds them byte for byte equal).  ``handle`` is the port's
``repro.core.Index``; ``index.LearnedIndex`` is the reference's
deprecation facade over it.  The package exports every name of the
reference's ``repro.core.__all__``.
"""

from .handle import BACKENDS, BackendSpec, Index
from .index import LearnedIndex
from .links import CSRLinks
from .mechanisms import (
    BTreeMechanism,
    FITingMechanism,
    MECHANISMS,
    PGMMechanism,
    PiecewiseLinearModel,
    RMIMechanism,
    build_mechanism,
)
from .mdl import MDLReport, correction_cost, mae, mdl_report
from .results import IngestReport, LookupResult, Overloaded
from .sampling import (
    exponential_search,
    fit_sampled,
    hoeffding_bound,
    refinalize_bounds,
    sample_pairs,
    sample_size_bound,
    spawn_rngs,
)
from .tuning import TunedChoice, autotune
from .gaps import GappedArray, GapSnapshot, build_gapped, gap_positions

__all__ = [
    "Index",
    "BackendSpec",
    "BACKENDS",
    "LearnedIndex",
    "LookupResult",
    "IngestReport",
    "Overloaded",
    "CSRLinks",
    "BTreeMechanism",
    "FITingMechanism",
    "MECHANISMS",
    "PGMMechanism",
    "PiecewiseLinearModel",
    "RMIMechanism",
    "build_mechanism",
    "MDLReport",
    "correction_cost",
    "mae",
    "mdl_report",
    "exponential_search",
    "fit_sampled",
    "hoeffding_bound",
    "refinalize_bounds",
    "sample_pairs",
    "sample_size_bound",
    "spawn_rngs",
    "TunedChoice",
    "autotune",
    "GappedArray",
    "GapSnapshot",
    "build_gapped",
    "gap_positions",
]
