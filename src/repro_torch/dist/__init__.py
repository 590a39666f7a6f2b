# The range-partitioned ShardedIndex and its learned ShardRouter
# (sharded.py), re-exported LAZILY as the reference's repro.dist does:
# sharded.py pulls in core and kernels, and an eager import here would
# load them with the package.  The reference's partitioning names
# (mesh PartitionSpecs for the model code) are not part of the port.

__all__ = [
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
