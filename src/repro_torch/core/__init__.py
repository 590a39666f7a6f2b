"""Host build and the ``Index`` handle.

``links``, ``mechanisms``, ``sampling``, ``gaps``, ``results``, ``mdl``
and ``tuning`` are verbatim copies of the reference's ``repro.core``
modules (numpy host code; tests/test_torch_freeze.py holds them byte
for byte equal).  ``handle`` is the port's ``repro.core.Index``.
"""

from .gaps import GappedArray, build_gapped
from .handle import BACKENDS, BackendSpec, Index
from .links import CSRLinks
from .mechanisms import MECHANISMS, PiecewiseLinearModel
from .results import IngestReport, LookupResult, Overloaded

__all__ = ["Index", "BackendSpec", "BACKENDS", "GappedArray",
           "build_gapped", "CSRLinks", "MECHANISMS", "PiecewiseLinearModel",
           "LookupResult", "IngestReport", "Overloaded"]
