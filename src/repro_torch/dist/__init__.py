# Sharding policy: logical axis names -> mesh placements
# (partitioning.py, the only module that spells a mesh axis name).
#
# sharded.py (range-partitioned ShardedIndex + learned ShardRouter) is
# re-exported LAZILY, as the reference's repro.dist does: it pulls in
# core and kernels, and an eager import here would load them with the
# package.

from .partitioning import (
    activation_constrainer,
    input_shardings,
    param_pspecs,
    param_shardings,
    pspec_for_axes,
)

__all__ = [
    "activation_constrainer",
    "input_shardings",
    "param_pspecs",
    "param_shardings",
    "pspec_for_axes",
    "ShardRouter",
    "ShardedIndex",
    "ShardedIngestReport",
]

_LAZY = ("ShardRouter", "ShardedIndex", "ShardedIngestReport")


def __getattr__(name):
    if name in _LAZY:
        from . import sharded as _sharded
        return getattr(_sharded, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
