"""``build_learn_s``: the learning stage of the host build in set-up
(``GappedArray.build_timings["learn_seconds"]``,
``core/gaps.py::build_gapped``)."""

from portbench.spans import build_seconds


def read(run):
    return build_seconds(run, "learn_seconds")
