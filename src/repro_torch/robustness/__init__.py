"""Fault injection + online invariant auditing for the serving stack.

``faults.py`` generalizes the trainer's ``train/fault.py``
(``FailureInjector``/``StepWatchdog``, step-keyed) to SITE-keyed
deterministic schedules usable anywhere in the serving path — ingest
aborts, slow flushes, torn WAL tails, mid-publish crashes — plus the
``InvariantAuditor`` that proves ``slot + chain == n``, epoch
monotonicity, and snapshot pin refcounts after every ingest in tests
(sampled in serving via ``EpochPipeline(audit_every=...)``).
"""

from .faults import (
    FaultInjector,
    InjectedCrash,
    InjectedFault,
    InvariantAuditor,
    tear_tail,
)

__all__ = ["FaultInjector", "InjectedCrash", "InjectedFault",
           "InvariantAuditor", "tear_tail"]
