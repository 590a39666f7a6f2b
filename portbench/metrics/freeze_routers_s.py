"""``freeze_routers_s``: the engine: its bounds upload and its radix and
rank routers (``ops.QueryEngine``), a stage of the set-up's freeze
(``Index.stats["freeze_stages"]["routers"]``,
``kernels/delta.py::freeze_state``)."""

from portbench.spans import freeze_seconds


def read(run):
    return freeze_seconds(run, "routers")
