"""``freeze_bounds_s``: the query-safe window bounds
(``bounds.query_window_bounds``), a stage of the set-up's freeze
(``Index.stats["freeze_stages"]["bounds"]``,
``kernels/delta.py::freeze_state``)."""

from portbench.spans import freeze_seconds


def read(run):
    return freeze_seconds(run, "bounds")
