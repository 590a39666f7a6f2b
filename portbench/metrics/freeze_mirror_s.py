"""``freeze_mirror_s``: the host mirror's copies
(``delta.snapshot_sources``), a stage of the set-up's freeze
(``Index.stats["freeze_stages"]["mirror"]``,
``kernels/delta.py::freeze_state``)."""

from portbench.spans import freeze_seconds


def read(run):
    return freeze_seconds(run, "mirror")
