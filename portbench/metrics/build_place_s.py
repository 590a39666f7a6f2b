"""``build_place_s``: the placement stage of the host build in set-up
(``GappedArray.build_timings["place_seconds"]``,
``core/gaps.py::build_gapped``)."""

from portbench.spans import build_seconds


def read(run):
    return build_seconds(run, "place_seconds")
